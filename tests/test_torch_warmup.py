"""The port's start-up kernel (cuda_satabsearch_tpu_torch/core/warmup.py)
against the JAX package's warm-up (cuda_satabsearch_tpu/core/warmup.py):
the same one-op kernel, o = x + 1 on f32[8, 128], run here in Pallas
interpret mode on seeded inputs, and the same no-op on the CPU.  The
CUDA kernel itself (csrc/warmup.cu) is held against x + 1 on the card
by chip_smoke.py."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from cuda_satabsearch_tpu.core import warmup as jwarmup  # noqa: E402
from cuda_satabsearch_tpu_torch import session as tsession  # noqa: E402
from cuda_satabsearch_tpu_torch.core import warmup as twarmup  # noqa: E402
from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS  # noqa: E402
from cuda_satabsearch_tpu_torch.core.warmup import (  # noqa: E402
    SHAPE, add_one, warm_backend)
from cuda_satabsearch_tpu_torch.ops import sa_kernel, warm  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _pallas_add_one(x: np.ndarray) -> np.ndarray:
    """The JAX package's warm-up kernel (core/warmup.py:48-53), run in
    interpret mode as the JAX package's Pallas tests run on the CPU."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_one_matches_pallas_interpret(seed):
    x = np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)
    x[0, :4] = [0.0, -1.0, np.float32(3.4e38), -np.float32(1e-45)]
    before = add_one.launches
    got = add_one(torch.from_numpy(x))
    assert add_one.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), _pallas_add_one(x))


@pytest.mark.parametrize("shape", [(3, 37), (1027,), (2, 3, 4)])
def test_add_one_matches_pallas_interpret_odd_sizes(shape):
    """Sizes that are not a whole number of float4s (the kernel's scalar
    tail) or not 2-D, against the same Pallas kernel."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got = add_one(torch.from_numpy(x))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _pallas_add_one(x))


def test_add_one_refuses_other_devices():
    with pytest.raises(ValueError, match="no start-up kernel"):
        add_one(torch.zeros(SHAPE, dtype=torch.float32, device="meta"))


def test_warm_backend_is_a_no_op_on_the_cpu_in_both_packages(monkeypatch):
    monkeypatch.setattr(jwarmup, "_DONE", False)
    monkeypatch.delenv("SATAB_NO_WARMUP", raising=False)
    before = add_one.launches
    assert warm_backend(torch.device("cpu")) == 0.0
    assert add_one.launches == before
    assert jwarmup.warm_backend(log=False) == 0.0


def test_warm_backend_brings_up_three_parts(monkeypatch, capsys):
    """On a card, warm_backend launches the start-up kernel, then
    ops/warm.warm_search prepares the SA kernel, decides whether the
    default schedule screens its Metropolis test, and brings up what a
    search touches around the kernel through the search's own code: the
    pinned staging of a query with its tag, its upload, the side stream
    with its fork and join events (ops/sa_kernel.fork_join), the gather
    of scores and maps into file order, and a drain, in order; the three
    times are reported on one stderr line (stand-ins here for the parts
    that need a card)."""
    calls = []
    dev = torch.device("meta")

    class Stand:
        def __init__(self, name):
            self.name = name
            self.device_index = 0

        def record(self, stream):
            calls.append(("record", self.name, stream.name))

        def wait_event(self, event):
            calls.append(("wait", self.name, event.name))

    class Buffer:
        def __init__(self):
            self.buf = self

        def to(self, device, non_blocking):
            calls.append(("upload", device, non_blocking))
            return self

        def __getitem__(self, rows):
            return self

        def cpu(self):
            calls.append(("drain",))

    def fake_add_one(x):
        calls.append(("add_one", x.device, tuple(x.shape)))
        return torch.ones(SHAPE)

    def fake_staging(K, n1r, pin):
        calls.append(("staging", K, n1r, pin))
        return Buffer()

    def fake_stage(staging, queries, tags):
        calls.append(("stage", [q.order for q in queries], list(tags)))

    def fake_gather(order, outs):
        calls.append(("to_file_order", order.device,
                      [tuple(x.shape) for x in outs]))

    def fake_streams(index):
        calls.append(("launch_streams", index))
        return Stand("side"), Stand("fork"), Stand("join")

    monkeypatch.setattr(twarmup, "add_one", fake_add_one)
    monkeypatch.setattr(warm, "prepare",
                        lambda d: calls.append(("prepare", d)))
    monkeypatch.setattr(warm, "screens",
                        lambda params: calls.append(("screens", params)))
    monkeypatch.setattr(warm, "Staging", fake_staging)
    monkeypatch.setattr(warm, "stage", fake_stage)
    monkeypatch.setattr(warm, "to_file_order", fake_gather)
    monkeypatch.setattr(sa_kernel, "launch_streams", fake_streams)
    monkeypatch.setattr(twarmup.torch.cuda, "current_stream",
                        lambda d: Stand("current"))
    assert warm_backend(dev) >= 0.0
    assert calls == [("add_one", dev, SHAPE), ("prepare", dev),
                     ("screens", DEFAULTS), ("staging", 1, 8, True), ("stage", [1], [0]),
                     ("upload", dev, True), ("launch_streams", 0),
                     ("record", "fork", "current"),
                     ("wait", "side", "fork"),
                     ("record", "join", "side"),
                     ("wait", "current", "join"),
                     ("to_file_order", dev, [(1, 32), (1, 32, 8)]),
                     ("drain",)]
    (line,) = capsys.readouterr().err.splitlines()
    assert line.startswith("# start-up on meta: CUDA context and kernel "
                           "library ")
    assert "SA module prepare" in line and "launch path" in line
    assert not hasattr(twarmup, "rng")  # no keys are made on the host


def test_session_warms_after_the_db_load(monkeypatch):
    """A session on the kernel backend launches the start-up kernel
    once, after the DB load (a bad dbfile fails first, as in the JAX
    package) and before the upload; the plain backend never does."""
    calls = []
    monkeypatch.setattr(tsession, "resolve_backend",
                        lambda backend, device: (
                            "torch" if device == "cpu" else "cuda",
                            torch.device("cpu")))
    monkeypatch.setattr(tsession, "warm_backend",
                        lambda dev: calls.append(("warm", dev)) or 0.25)
    real_upload = tsession.upload_db
    monkeypatch.setattr(tsession, "upload_db",
                        lambda db, dev: calls.append(("upload", dev))
                        or real_upload(db, dev))
    with pytest.raises(FileNotFoundError):
        tsession.SearchSession(os.path.join(FIXTURES, "no_such_db.ascii"))
    assert calls == []
    sess = tsession.SearchSession(
        os.path.join(FIXTURES, "tableauxdistmatrixdb.test.ascii"))
    assert [c[0] for c in calls] == ["warm", "upload"]
    assert sess.warmup_s == 0.25

    calls.clear()
    plain = tsession.SearchSession(
        os.path.join(FIXTURES, "tableauxdistmatrixdb.test.ascii"),
        tsession.SessionConfig(device="cpu"))
    assert [c[0] for c in calls] == ["upload"]
    assert plain.warmup_s == 0.0
