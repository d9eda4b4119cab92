"""The threefry uniform stream of the search: a frozen copy.

Copied from cuda_satabsearch_tpu_torch/ops/rng.py (``threefry2x32``,
``fold_in``, ``entry_keys``, ``uniforms_raw``, ``ln_f32``),
ops/common.py (``round8``) and ops/search.py (``choose_chains``) at
commit d4cb1337b7aaf96a99aa4443f325ec93637d3526.  jax.random's
threefry2x32 (partitionable) bit for bit:

* ``PRNGKey(s) = (0, s)``;
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``uniform(k, shape)`` at flat index i: ``(x0, x1) = threefry2x32(k,
  (i >> 32, i & 0xffffffff))``, ``bits = x0 ^ x1``, and
  ``u = bitcast_f32((bits >> 9) | 0x3f800000) - 1``.

The stream of entry ``e`` (its file-order index) for query tag ``t`` and
restart ``r`` is ``uniform(fold_in(fold_in(fold_in(PRNGKey(seed), t),
e), r), (P, c_par))``: slot p of chain c is flat index p * c_par + c.
uint32 values are held in int64 tensors and wrapped with
``& 0xffffffff`` after every add.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
C_MAX = 128  # most chains per (query, entry): one CUDA thread each


def round8(x: int) -> int:
    """Query-order padding quantum; keys the slot schedule."""
    return max(8, -(-x // 8) * 8)


def choose_chains(maxstart: int, c_max: int = C_MAX) -> tuple[int, int]:
    """(parallel chains, sequential restarts): the largest divisor of
    ``maxstart`` that is <= c_max runs as parallel chains."""
    if maxstart < 1:
        raise ValueError("maxstart must be >= 1")
    for c in range(min(maxstart, c_max), 0, -1):
        if maxstart % c == 0:
            return c, maxstart // c
    return 1, maxstart


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


def pair_keys(seed: int, tags, indices, device=None) -> torch.Tensor:
    """Keys int64[B, 2] of B (query tag, entry index) pairs:
    fold_in(fold_in(PRNGKey(seed), tag), index).  ``seed`` is an int32."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    tags = torch.as_tensor(np.asarray(tags, np.int64), device=device)
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    base = torch.tensor([0, seed & M32], dtype=torch.int64, device=device)
    return fold_in(fold_in(base.expand(tags.numel(), 2), tags), idx)


def uniforms(keys: torch.Tensor, P: int, c_par: int) -> torch.Tensor:
    """float32[B, P, c_par]: jax.random.uniform(key, (P, c_par)) of each
    key of keys int64[B, 2]."""
    flat = torch.arange(P * c_par, dtype=torch.int64,
                        device=keys.device).view(1, P, c_par)
    k0 = keys[:, 0].view(-1, 1, 1)
    k1 = keys[:, 1].view(-1, 1, 1)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(flat), flat)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def ln_f32(u: torch.Tensor) -> torch.Tensor:
    """float32(ln(float64(u))): the natural log rounded once to float32.
    CPU tensors go through numpy (torch's CPU log has returned values
    off by ~1.5e3 ulp in whole worker-thread chunks); on the card it is
    the double-precision libdevice log."""
    if u.device.type == "cpu":
        with np.errstate(divide="ignore"):  # ln(0) = -inf
            out = np.log(u.numpy().astype(np.float64)).astype(np.float32)
        return torch.from_numpy(out)
    return torch.log(u.double()).float()
