"""Entry sharding in the port (cuda_satabsearch_tpu_torch/parallel/):
a search sharded over a mesh of devices equals the unsharded search
and the JAX package's sharded XLA search, bitwise; a two-process gloo
run equals a single-process run; ``-c --mesh`` prints what ``-c``
prints.  Every entry's stream is keyed by its file-order index, so no
split of the entries may change a bit."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cuda_satabsearch_tpu.io.pack import pack_database as jpack_database  # noqa: E402
from cuda_satabsearch_tpu.io.pack import pack_query as jpack_query  # noqa: E402
from cuda_satabsearch_tpu.ops.search import search_db as jsearch_db  # noqa: E402
from cuda_satabsearch_tpu.parallel.mesh import (  # noqa: E402
    entry_sharding, make_mesh as jmake_mesh)
from cuda_satabsearch_tpu_torch import cli  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import (  # noqa: E402
    pack_database, pack_query)
from cuda_satabsearch_tpu_torch.io.writer import format_database  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.search import upload_db  # noqa: E402
from cuda_satabsearch_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, shard_rows)
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

from conftest import random_entry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _problem(seed, nentries=21):
    rng = np.random.default_rng(seed)
    entries = [random_entry(rng, int(n), f"e{i:03d}")
               for i, n in enumerate(rng.integers(4, 30, size=nentries))]
    queries = [pack_query(random_entry(rng, n, f"q{n}")) for n in (9, 5)]
    return entries, queries


def _session(entries, ndev=None, **kw):
    mesh = dict(use_mesh=True, devices=["cpu"] * ndev) if ndev else {}
    return SearchSession("<entries>", SessionConfig(
        maxstart=16, seed=7, device="cpu", **mesh, **kw), entries=entries)


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
def test_sharded_equals_unsharded(ndev):
    entries, queries = _problem(3)
    plain = _session(entries).search_many(queries, lsoln=True)
    sess = _session(entries, ndev)
    assert len(sess.device_db) == ndev
    for b in sess.db.buckets:
        assert b.size % ndev == 0
    sharded = sess.search_many(queries, lsoln=True)
    for p, s in zip(plain, sharded):
        np.testing.assert_array_equal(s.scores, p.scores)
        np.testing.assert_array_equal(s.ssemaps, p.ssemaps)
        assert s.names == p.names


def test_sharded_equals_jax_sharded_xla_search():
    """tests/test_mesh.py's problem: the JAX package's search on its XLA
    engine with the entry axis sharded over the 8-device CPU mesh."""
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    rng = np.random.default_rng(3)
    entries = [random_entry(rng, int(n), f"e{i:03d}")
               for i, n in enumerate(rng.integers(4, 30, size=21))]
    qentry = random_entry(rng, 9, "q")
    mesh = jmake_mesh(jax.devices()[:8])
    ref = jsearch_db(jpack_query(qentry), jpack_database(entries, pad_to=8),
                     maxstart=16, lorder=True, seed=7, query_tag=3,
                     backend="xla", sharding=entry_sharding(mesh))
    got = _session(entries, 8).search(pack_query(qentry), lorder=True,
                                      query_tag=3, lsoln=True)
    np.testing.assert_array_equal(got.scores, ref.scores)
    np.testing.assert_array_equal(got.ssemaps, ref.ssemaps)


def test_mesh_padding_counts():
    rng = np.random.default_rng(5)
    entries = [random_entry(rng, 10, f"e{i}") for i in range(5)]
    for ndev in (3, 8):
        db = pack_database(entries, pad_to=ndev)
        (b,) = db.buckets
        assert b.size == -(-5 // ndev) * ndev
        assert (b.index >= 0).sum() == 5
        shards = upload_db(db, make_mesh(["cpu"] * ndev))
        assert len(shards) == ndev
        per = b.size // ndev
        assert [len(s.buckets[0].index) for s in shards] == [per] * ndev
        np.testing.assert_array_equal(
            np.concatenate([s.buckets[0].index for s in shards]), b.index)
        for i, s in enumerate(shards):
            np.testing.assert_array_equal(
                s.buckets[0].n2.numpy(), b.orders[i * per:(i + 1) * per])
            np.testing.assert_array_equal(s.buckets[0].index_dev.numpy(),
                                          b.index[i * per:(i + 1) * per])
    assert shard_rows(16, 8, 3) == slice(6, 8)
    with pytest.raises(ValueError, match="pad_to=3"):
        shard_rows(10, 3, 0)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])


WORKER = r"""
import sys
import numpy as np
import torch
from cuda_satabsearch_tpu_torch.parallel import distributed
from cuda_satabsearch_tpu_torch.io.pack import pack_query
from cuda_satabsearch_tpu_torch.io.parser import parse_search_input
from cuda_satabsearch_tpu_torch.session import SearchSession, SessionConfig

rank, port, dbfile, qfile, out = sys.argv[1:6]
distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=2,
                       rank=int(rank), device="cpu")
with open(qfile) as fp:
    queries = [pack_query(q) for q in parse_search_input(fp).queries]
sess = SearchSession(dbfile, SessionConfig(
    maxstart=16, seed=7, device="cpu", use_mesh=True,
    devices=["cpu", "cpu"]))
assert sess.gather and len(sess.device_db) == 2
res = sess.search_many(queries, lsoln=True)
np.savez(f"{out}.{rank}.npz", scores=np.stack([r.scores for r in res]),
         maps=np.concatenate([r.ssemaps.ravel() for r in res]),
         primary=distributed.is_primary())
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_equals_single_process(tmp_path):
    """Two ranks, each with a mesh of two CPU devices (four shards in
    all), spawned here with a 60 s limit; the all-gathered result on
    every rank equals a single-process unsharded run."""
    entries, _ = _problem(11, nentries=19)
    dbfile = tmp_path / "db.ascii"
    dbfile.write_text(format_database(entries))
    qfile = os.path.join(FIXTURES, "multiquery.input")
    port, out = _free_port(), str(tmp_path / "res")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), str(dbfile), qfile,
         out], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    from cuda_satabsearch_tpu_torch.io.parser import parse_search_input

    with open(qfile) as fp:
        queries = [pack_query(q) for q in parse_search_input(fp).queries]
    ref = SearchSession(str(dbfile), SessionConfig(
        maxstart=16, seed=7, device="cpu")).search_many(queries, lsoln=True)
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        assert bool(got["primary"]) == (r == 0)
        np.testing.assert_array_equal(got["scores"],
                                      np.stack([x.scores for x in ref]))
        np.testing.assert_array_equal(
            got["maps"], np.concatenate([x.ssemaps.ravel() for x in ref]))


def test_cli_mesh_stdout_identical_to_cli(monkeypatch, capsys):
    """``-c --mesh`` vs ``-c``: the d1ubia_ query with LSOLN against the
    586-entry DB, r = 8."""
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        body = fp.read().splitlines(keepends=True)[2:]
    text = "tableauxdistmatrixdb.small.ascii\nT T T\n" + "".join(body)
    monkeypatch.chdir(FIXTURES)
    outs = []
    for argv in (["-c", "-r", "8"], ["-c", "--mesh", "-r", "8"]):
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        assert cli.main(argv) == 0
        captured = capsys.readouterr()
        outs.append(captured.out)
    assert "torch on cpu)" in captured.err
    assert outs[0].count("\n") > 586
    assert outs[1] == outs[0]
