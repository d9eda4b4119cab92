"""The SA kernel's screened Metropolis test (csrc/sa_search.cu, the
loop's acceptance), held to the exact test on every value of the
uniform grid.

The exact test accepts a move where float(delta) > temp * ln u, with ln
u = float32(log(float64(u))) (``ops/rng.ln_f32``) and one float32
product.  The kernel decides it with fast_ln(u), any float32 within
``FAST_LN_ERR`` of ln u (the card test measures the kernel's):
accepted where float(delta) > prod + margin, rejected where
float(delta) < prod - margin, prod = temp * fast_ln(u) and margin = temp
* ``SCREEN_MARGIN``, each a float32 operation; the exact test decides
the rest.  Both sums grow with prod, which grows with fast_ln(u), and a
larger delta only accepts more: so a fast_ln at ln u - FAST_LN_ERR
accepts wherever any allowed one does, at ln u + FAST_LN_ERR rejects
wherever any does, and the integer just below temp * ln u (rejected)
and the one above it (accepted) are the deltas where either could
first go wrong.  The test checks those four cases at every u = k 2**-23
and at every temperature of a restart.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from cuda_satabsearch_tpu_torch.core.constants import DEFAULTS
from cuda_satabsearch_tpu_torch.ops import sa_kernel
from cuda_satabsearch_tpu_torch.ops.sa_kernel import (
    FAST_LN_ERR, SCREEN_MARGIN, SCREEN_TEMPS, screened_warp_moves, screens,
    temperatures)

f32 = np.float32


def screen_margin_needed(err: float) -> float:
    """The least margin over the temperature at which the screen decides
    as the exact test does, for |fast_ln(u) - ln u| <= err and normal
    float32 products (``SCREEN_TEMPS``): the products temp * fast_ln(u)
    and temp * ln u, at most 23 ln 2 + err in magnitude, each round by up
    to 2**-24 of themselves, and so do the margin temp * m and the sums
    prod +- margin that the test compares delta with."""
    e, lmax = 2.0 ** -24, 23 * np.log(2.0)
    return (err + e * (3 * lmax + 2 * err + e * (lmax + err))) / (1 - e) ** 2


@pytest.fixture(scope="module")
def grid():
    """(ln u, the least and the most fast_ln allowed) over u = k 2**-23,
    k = 1 .. 2**23 - 1, float32."""
    u = np.arange(1, 2 ** 23, dtype=np.float64) * 2.0 ** -23
    ln = np.log(u).astype(f32)
    wide = ln.astype(np.float64)
    lo = (wide - FAST_LN_ERR).astype(f32)  # rounded into the bound
    lo = np.where(lo < wide - FAST_LN_ERR, np.nextafter(lo, f32(0)), lo)
    hi = (wide + FAST_LN_ERR).astype(f32)
    hi = np.where(hi > wide + FAST_LN_ERR, np.nextafter(hi, f32(-1)), hi)
    assert (np.abs(lo - wide) <= FAST_LN_ERR).all()
    assert (np.abs(hi - wide) <= FAST_LN_ERR).all()
    return ln, lo, hi


def screened(delta, temp, fast):
    """(accept, exact path) of the kernel's screen, in float32."""
    prod = f32(temp) * fast
    margin = f32(temp) * f32(SCREEN_MARGIN)
    accept = delta > prod + margin
    reject = delta < prod - margin
    return accept, ~accept & ~reject


@pytest.mark.parametrize("params", [
    DEFAULTS,
    dataclasses.replace(DEFAULTS, temp0=1000.0, alpha=0.9, maxiter=20),
], ids=["defaults", "hot"])
def test_the_screen_decides_as_the_exact_test(grid, params):
    """``screened``'s float32 operations, in place over the grid."""
    ln, lo, hi = grid
    assert screens(params)
    delta, x = np.empty_like(ln), np.empty_like(ln)
    wrong = np.empty(ln.shape, bool)
    for temp in temperatures(params):
        margin = temp * f32(SCREEN_MARGIN)
        np.multiply(ln, temp, out=x)  # temp * ln u, one float32 product
        np.floor(x, out=delta)  # the largest delta the test rejects
        np.multiply(lo, temp, out=x)
        np.add(x, margin, out=x)
        assert not np.greater(delta, x, out=wrong).any(), temp  # accepted
        delta += f32(1)  # the least delta the test accepts
        np.multiply(hi, temp, out=x)
        np.subtract(x, margin, out=x)
        assert not np.less(delta, x, out=wrong).any(), temp  # rejected


def test_the_screen_accepts_at_u_0():
    """ln 0 = -inf: the exact test accepts every delta; so does the
    screen, without the exact path (fast_ln(0) = -inf too)."""
    for temp in temperatures(DEFAULTS):
        for delta in (-10 ** 6, -1, 0, 5):
            accept, near = screened(f32(delta), temp, f32(-np.inf))
            assert accept and not near


def test_the_screen_leaves_few_moves_to_the_exact_path(grid):
    """With fast_ln = ln u, the share of grid values the screen leaves in
    doubt at a delta: about 2 x SCREEN_MARGIN x u at u = exp(delta /
    temp), so at most a few in 10**5 of a lane's moves."""
    ln, _, _ = grid
    for temp in temperatures(DEFAULTS)[::33]:
        for delta in (0, -1, -5):
            _, near = screened(f32(delta), temp, ln)
            assert near.mean() <= 2.5 * SCREEN_MARGIN, (temp, delta)


def test_the_margin_covers_the_error_bound():
    assert SCREEN_MARGIN >= screen_margin_needed(FAST_LN_ERR)
    # twice the largest |fast_ln(u) - ln u| over the grid on an NVIDIA
    # H100 (2**-19: tests/test_torch_accept_screen_card.py)
    assert FAST_LN_ERR >= 2 * 2.0 ** -19


def test_temperatures_are_float32_products():
    temps = temperatures(DEFAULTS)
    assert temps.dtype == f32 and len(temps) == DEFAULTS.maxiter
    assert temps[0] == f32(10.0)
    assert temps[1] == f32(10.0) * f32(0.95)
    assert temps[-1] == temps[-2] * f32(0.95)


@pytest.mark.parametrize("change, screened_", [
    ({}, True),
    ({"temp0": 0.0}, False),
    ({"temp0": -1.0}, False),
    ({"temp0": float("inf")}, False),
    ({"temp0": float("nan")}, False),
    ({"alpha": 0.0}, False),
    ({"alpha": float("nan")}, False),
    ({"alpha": 1e-10, "maxiter": 100}, False),  # underflows SCREEN_TEMPS
    ({"alpha": 1e-10, "maxiter": 3}, True),
    ({"temp0": 2.0 ** 101}, False),
    ({"maxiter": 0}, False),
])
def test_where_the_kernel_screens(change, screened_):
    assert screens(dataclasses.replace(DEFAULTS, **change)) is screened_


def test_screen_temps_keep_the_margin_normal_and_finite():
    """At the least temperature the margin is normal, and its room over
    the bound dwarfs the absolute rounding (2**-150) of a product that
    falls below the normal range (a fast_ln near 0); at the most the
    products stay finite."""
    lo, hi = SCREEN_TEMPS
    assert f32(lo) * f32(SCREEN_MARGIN) >= np.finfo(f32).tiny
    room = lo * (SCREEN_MARGIN - screen_margin_needed(FAST_LN_ERR))
    assert room > 2.0 ** -140
    assert np.isfinite(f32(hi) * f32(-23 * np.log(2) - FAST_LN_ERR))
    assert np.isfinite(f32(hi) * f32(SCREEN_MARGIN) * f32(2))


def test_screened_warp_moves_count_the_warps_of_each_class():
    plan = SimpleNamespace(classes=[SimpleNamespace(entries=n)
                                    for n in (30, 556)])
    # c_par 128: 4 warps a CTA at G 1, 16 at G 4; 100 chains: 4 warps
    assert screened_warp_moves(plan, 2, (4, 1), c_par=128, r_seq=32,
                               maxiter=100) == \
        2 * 3200 * (30 * 16 + 556 * 4)
    assert screened_warp_moves(plan, 1, (1, 1), c_par=100, r_seq=1,
                               maxiter=5) == 5 * (30 + 556) * 4
    assert screened_warp_moves(plan, 1, (2, 2), c_par=8, r_seq=1,
                               maxiter=5) == 5 * (30 + 556)


def test_exact_log_share_is_none_before_any_screened_move(monkeypatch):
    monkeypatch.setattr(sa_kernel.sa_search, "screened_warp_moves", 0)
    assert sa_kernel.exact_log_share() is None
