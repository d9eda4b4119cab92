"""The deployment's DB: a committed file, or the ASTRAL-scale synthetic
DB written once per seed into ``satbench/cache/`` and loaded from there,
as a deployment loads its DB file."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import synth
from .cells import BENCH, ROOT
from .reference.dbfile import FileIndex, index_file

CACHE = BENCH / "cache"


def entropy(seed: int, *path: int) -> np.random.SeedSequence:
    """The seed sequence of one use of ``--seed`` (any whole number)."""
    return np.random.SeedSequence([seed % 2 ** 64, *path])


@dataclass
class Deployment:
    path: Path  # the DB file the program loads
    index: FileIndex  # the benchmark's own index of it
    made_s: float  # seconds spent making and indexing it here


def prepare(name: str, config: dict, seed: int,
            cache: Path = CACHE) -> Deployment:
    t0 = time.perf_counter()
    db = config["db"]
    if db["kind"] == "file":
        path = ROOT / db["path"]
    elif db["kind"] == "astral_synthetic":
        path = cache / f"{name}-{seed}.ascii"
        if not path.is_file():
            entries = synth.astral_entries(db["entries"], entropy(seed, 1))
            cache.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            tmp.write_text(synth.format_database(entries))
            os.replace(tmp, path)
    else:
        raise ValueError(f"unknown DB kind {db['kind']!r}")
    index = index_file(str(path))
    if len(index.names) != db["entries"]:
        raise ValueError(f"{path} holds {len(index.names)} entries, the "
                         f"configuration states {db['entries']}")
    return Deployment(path=path, index=index,
                      made_s=time.perf_counter() - t0)
