"""The port's threefry stream (cuda_satabsearch_tpu_torch/ops/rng.py)
against jax.random and the JAX package's stream helpers.

Keys and raw uniforms must be bitwise equal.  The acceptance slots carry
ln u: torch.log and XLA's log may differ there by at most 1 ulp, and
every other slot must be bitwise equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from cuda_satabsearch_tpu.ops.common import make_uniforms  # noqa: E402
from cuda_satabsearch_tpu.ops.search import entry_keys  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import rng  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.common import (  # noqa: E402
    round8, slots_per_restart)


def _jax_keys(seed, tag, idx):
    return np.asarray(entry_keys(seed, tag, idx)).astype(np.int64)


@pytest.mark.parametrize("seed,tag", [(1234, 0), (1234, 7), (0, 3),
                                      (2 ** 31 - 1, 2 ** 20 + 5)])
def test_entry_keys_bitwise(seed, tag):
    idx = np.array([0, 1, 2, 585, 14290, 2 ** 31 + 11], np.int64)
    got = rng.entry_keys(seed, [tag], idx)[0].numpy()
    np.testing.assert_array_equal(got, _jax_keys(seed, tag, idx))


def test_entry_keys_several_tags():
    idx = np.arange(5)
    got = rng.entry_keys(99, [4, 0, 11], idx).numpy()
    for k, tag in enumerate((4, 0, 11)):
        np.testing.assert_array_equal(got[k], _jax_keys(99, tag, idx))


def test_fold_in_bitwise():
    r = np.random.default_rng(1)
    keys = r.integers(0, 2 ** 32, size=(6, 2), dtype=np.uint64)
    data = r.integers(0, 2 ** 32, size=6, dtype=np.uint64)
    got = rng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                      torch.from_numpy(data.astype(np.int64))).numpy()
    for k, d, g in zip(keys, data, got):
        ref = jax.random.fold_in(np.asarray(k, np.uint32), np.uint32(d))
        np.testing.assert_array_equal(g, np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("c_par", [128, 100])
@pytest.mark.parametrize("seed,tag,n1", [(1234, 0, 8), (5, 2, 13),
                                         (77, 9, 19)])
def test_uniforms_raw_bitwise(c_par, seed, tag, n1):
    r_seq, P = 2, slots_per_restart(n1)
    idx = np.array([0, 3, 40])
    kj = entry_keys(seed, tag, idx)
    got = rng.uniforms_raw(rng.entry_keys(seed, [tag], idx)[0], r_seq, P,
                           c_par).numpy()
    for e in range(len(idx)):
        for r in range(r_seq):
            ref = np.asarray(jax.random.uniform(
                jax.random.fold_in(kj[e], r), (P, c_par)))
            np.testing.assert_array_equal(got[e, r], ref)


@pytest.mark.parametrize("c_par", [128, 100])
@pytest.mark.parametrize("n1", [5, 13])
def test_log_acc_slots_within_one_ulp(c_par, n1):
    r_seq, n1r = 2, round8(n1)
    P = slots_per_restart(n1)
    idx = np.arange(6)
    ref = np.asarray(make_uniforms(entry_keys(1234, 1, idx), r_seq, P,
                                   c_par, n1r))[..., :c_par]
    got = rng.make_uniforms(rng.entry_keys(1234, [1], idx)[0], r_seq, P,
                            c_par, n1r).numpy()
    slot = np.arange(P)
    acc = (slot >= n1r) & ((slot - n1r) % 3 == 2)
    np.testing.assert_array_equal(got[:, :, ~acc], ref[:, :, ~acc])
    g = got[:, :, acc].view(np.int32).astype(np.int64)
    j = ref[:, :, acc].view(np.int32).astype(np.int64)
    assert np.all(np.isfinite(ref[:, :, acc]))
    assert np.abs(g - j).max() <= 1  # same sign: ulp gap = bit gap


def test_ln_f32_within_one_ulp_of_xla_on_the_whole_grid():
    """Every non-zero jax float32 uniform is k * 2**-23; ln u of each
    is within 1 ulp of XLA's float32 log, and ln 0 = -inf."""
    import jax.numpy as jnp

    g = (np.arange(1, 2 ** 23, dtype=np.float64) * 2.0 ** -23).astype(
        np.float32)
    got = rng.ln_f32(torch.from_numpy(g)).numpy()
    ref = np.asarray(jnp.log(jnp.asarray(g)))
    gap = np.abs(got.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert gap.max() <= 1
    assert rng.ln_f32(torch.zeros(3)).numpy().tolist() == [-np.inf] * 3
