"""The JAX package's threefry uniform stream, reproduced in torch.

Counterpart of cuda_satabsearch_tpu/ops/search.py ``entry_keys``
(:74-89), ops/common.py ``make_uniforms`` (:61-102) and ops/engine.py
``log_acc_slots`` (:44-66).  jax.random (threefry2x32, partitionable)
is reproduced bit for bit:

* ``PRNGKey(s) = (0, s)``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``uniform(k, shape)`` at flat index i: ``(x0, x1) = threefry2x32(k,
  (i >> 32, i & 0xffffffff))``, ``bits = x0 ^ x1``, and
  ``u = bitcast_f32((bits >> 9) | 0x3f800000) - 1``.

The stream of entry ``e`` for query tag ``t`` and restart ``r`` is
``uniform(fold_in(fold_in(fold_in(PRNGKey(seed), t), e), r), (P, c_par))``,
P = round8(n1) + 3*maxiter slots.  uint32 values are held in int64
tensors and wrapped with ``& 0xffffffff`` after every add.  The CUDA
kernel (csrc/sa_search.cu) derives the same keys from (seed, tag,
index) and draws the same stream in-kernel; the plain engine makes them
here.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import round8

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SEED_MIN, SEED_END = -2 ** 31, 2 ** 31  # the int32 seeds PRNGKey takes


def check_seed(seed: int) -> int:
    """``seed`` if it lies in [-2**31, 2**31), else ValueError: the JAX
    package keys its stream with ``PRNGKey(seed)`` on an int32 and
    raises OverflowError beyond it, so a wider seed would run a stream
    it never makes (or, masked to 32 bits, another seed's)."""
    if not SEED_MIN <= seed < SEED_END:
        raise ValueError(f"seed {seed} is outside [-2**31, 2**31) (the "
                         f"JAX package's int32 seeds)")
    return int(seed)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64
    tensors (all four arguments broadcast together)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << rot) | (x1 >> (32 - rot))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in over keys int64[..., 2] and uint32 data
    broadcast against keys[..., 0]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & M32)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def entry_keys(seed: int, query_tags, indices,
               device=None) -> torch.Tensor:
    """Per-(query, entry) keys int64[K, E, 2] (uint32 values):
    fold_in(fold_in(PRNGKey(seed), tag), index), as the JAX package
    keys the stream of entry ``index`` (its file-order position).
    ``seed`` must lie in [-2**31, 2**31) (``check_seed``)."""
    seed = check_seed(seed)
    tags = torch.as_tensor(np.asarray(query_tags, np.int64).reshape(-1),
                           device=device)
    idx = torch.as_tensor(np.asarray(indices, np.int64).reshape(-1),
                          device=device)
    base = torch.tensor([0, seed & M32], dtype=torch.int64, device=device)
    per_tag = fold_in(base.expand(tags.numel(), 2), tags)  # [K, 2]
    return fold_in(per_tag[:, None, :], idx[None, :])


def uniforms_raw(keys: torch.Tensor, r_seq: int, P: int,
                 c_par: int) -> torch.Tensor:
    """float32[..., r_seq, P, c_par]: restart r of key k is
    jax.random.uniform(fold_in(k, r), (P, c_par))."""
    dev = keys.device
    r = torch.arange(r_seq, dtype=torch.int64, device=dev)
    rkeys = fold_in(keys[..., None, :], r)  # [..., r_seq, 2]
    flat = torch.arange(P * c_par, dtype=torch.int64,
                        device=dev).view(P, c_par)
    k0 = rkeys[..., 0][..., None, None]
    k1 = rkeys[..., 1][..., None, None]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(flat), flat)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def ln_f32(u: torch.Tensor) -> torch.Tensor:
    """float32(ln(float64(u))): the natural log rounded once to float32
    (within 1 ulp of XLA's float32 log, which is within 1 ulp of the
    true value).  CPU tensors go through numpy: torch's CPU log (MKL
    build) has returned values off by ~1.5e3 ulp in whole worker-thread
    chunks on a process's first large call.  On the card it is the same
    libdevice double-precision log the CUDA kernel calls."""
    if u.device.type == "cpu":
        with np.errstate(divide="ignore"):  # ln(0) = -inf
            out = np.log(u.numpy().astype(np.float64)).astype(np.float32)
        return torch.from_numpy(out)
    return torch.log(u.double()).float()


def log_acc_slots(uniforms: torch.Tensor, n1r: int) -> torch.Tensor:
    """Replace the Metropolis-acceptance slots (round8(n1) + 3*it + 2,
    along dim -2) of a uniform stream [..., P, c_par] by their natural
    log; ln(0) = -inf accepts unconditionally.  The ln u values may
    differ from the JAX package's by 1 ulp; the accept test
    ``delta > temp * ln u`` has an integer delta, so such a gap flips a
    decision only in rare (u, iteration) pairs, and then for one value
    of delta."""
    acc = torch.arange(round8(n1r) + 2, uniforms.shape[-2], 3,
                       device=uniforms.device)
    out = uniforms.clone()
    out[..., acc, :] = ln_f32(uniforms[..., acc, :])
    return out


def make_uniforms(keys: torch.Tensor, r_seq: int, P: int, c_par: int,
                  n1r: int) -> torch.Tensor:
    """The stream the search consumes: ``uniforms_raw`` with ln u in
    the acceptance slots.  ``n1r`` is explicit (the slot-schedule base),
    as in the JAX package."""
    return log_acc_slots(uniforms_raw(keys, r_seq, P, c_par), n1r)
