"""The plain PyTorch version of the SA search kernel.

Counterpart of cuda_satabsearch_tpu/ops/engine.py (``make_entry_search``
:106-298), batched over (query, entry) rows and chains as written-out
dims, with ``torch.gather`` for the takes.  ``search_plan_plain``
computes what the CUDA kernel (csrc/sa_search.cu, wrapper
ops/sa_kernel.py) computes for a launch plan, on the same inputs, by
running ``search_plain`` bucket by bucket, and is the reference the
kernel is held against on the card.  It runs on CPU tensors (the ``-c``
path and the tests) and on CUDA tensors (``--backend torch``, and
chip_smoke.py's comparisons).

Semantics follow the JAX engine step for step: thinit (:142-158), the
integer initial score over pairs i < k (:160-178), the LORDER window
(:188-205), the uniform same-type unmatched pick (:208-215), the O(n1)
delta (:220-238), max tracking before acceptance (:241-246), the
log-domain accept and update (:251-261) and the first-maximal-chain
reduction (:291-296).  The query order may differ between queries of
one call (any mix within a round8 group): ``n1s`` carries each exact
order, the tables are padded to n1r = round8(max order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import DEFAULTS, SAParams
from . import rng
from .common import slots_per_restart

I64 = torch.int64
F32 = torch.float32

# stream elements per block of entries when the stream is made from
# keys: bounds the threefry temporaries (int64) to ~2**24 * 8 B each
_STREAM_ELEMS = 1 << 24


def _tscord(x, y):
    """Tableau pair score on packed hi*8 + lo codes: +2 both halves
    equal, +1 one, -2 none (kernel.cu:306-332)."""
    he = (x >> 3) == (y >> 3)
    le = (x & 7) == (y & 7)
    return torch.where(he & le, 2, torch.where(he | le, 1, -2))


def search_plain(qtypes, qtab, qdmat, n1s, types, tab, dmat, n2, *,
                 keys=None, uniforms=None, c_par: int, r_seq: int,
                 lorder: bool, lsoln: bool,
                 params: SAParams = DEFAULTS):
    """SA search of K queries against E entries of one bucket.

    qtypes int8[K, n1r], qtab uint8[K, n1r, n1r] (hi*8 + lo),
    qdmat f32[K, n1r, n1r], n1s int32[K]; types int8[E, d2],
    tab uint8[E, d2, d2], dmat f32[E, d2, d2], n2 int32[E].
    The stream is either ``uniforms`` f32[K, E, r_seq, P, c_par] with
    ln u in the acceptance slots, or ``keys`` int64[K, E, 2] (uint32
    values, ops/rng.entry_keys), from which the same stream is made
    here, block by block.
    Returns (scores int32[K, E], bestmaps int32[K, E, n1r] or None).
    """
    if (keys is None) == (uniforms is None):
        raise ValueError("give exactly one of keys / uniforms")
    K, n1r = qtypes.shape
    E = types.shape[0]
    P = slots_per_restart(n1r, params.maxiter)
    per_entry = K * r_seq * P * c_par
    block = E if keys is None else max(1, _STREAM_ELEMS // per_entry)
    scores, maps = [], []
    for s in range(0, E, block):
        sl = slice(s, min(s + block, E))
        if keys is None:
            u = uniforms[:, sl]
        else:
            u = rng.make_uniforms(keys[:, sl], r_seq, P, c_par, n1r)
        sc, mp = _search_block(qtypes, qtab, qdmat, n1s, types[sl],
                               tab[sl], dmat[sl], n2[sl], u, c_par, r_seq,
                               lorder, lsoln, params)
        scores.append(sc)
        maps.append(mp)
    scores = torch.cat(scores, dim=1)
    return scores, (torch.cat(maps, dim=1) if lsoln else None)


def search_plan_plain(qtypes, qtab, qdmat, n1s, plan, *, seed: int = 0,
                      tags=None, uniforms=None, c_par: int, r_seq: int,
                      lorder: bool, lsoln: bool,
                      params: SAParams = DEFAULTS):
    """SA search of K queries against every bucket of a launch plan
    (ops/kernel_search.make_plan), the arguments and results of the
    kernel's wrapper ops/sa_kernel.sa_search: ``search_plain`` bucket by
    bucket, with each bucket's keys from ``rng.entry_keys(seed, tags,
    bucket.index)`` or its columns of the supplied ``uniforms``
    f32[K, E, r_seq, P, c_par].  Returns (scores int32[K, E], maps
    int32[K, E, n1r] or None), E = plan.nentries in the plan's order."""
    if (tags is None) == (uniforms is None):
        raise ValueError("give exactly one of tags / uniforms")
    if torch.is_tensor(tags):
        tags = tags.cpu().numpy()
    K, n1r = qtypes.shape
    scores = [torch.empty((K, 0), dtype=torch.int32, device=plan.device)]
    maps = [torch.empty((K, 0, n1r), dtype=torch.int32, device=plan.device)]
    off = 0
    for b in plan.buckets:
        E = len(b.index)
        if tags is not None:
            stream = dict(keys=rng.entry_keys(seed, tags, b.index,
                                              device=plan.device))
        else:
            stream = dict(uniforms=uniforms[:, off:off + E])
        s, m = search_plain(qtypes, qtab, qdmat, n1s, b.types, b.tab,
                            b.dmat, b.n2, c_par=c_par, r_seq=r_seq,
                            lorder=lorder, lsoln=lsoln, params=params,
                            **stream)
        off += E
        scores.append(s)
        maps.append(m)
    return (torch.cat(scores, dim=1),
            torch.cat(maps, dim=1) if lsoln else None)


def _search_block(qtypes, qtab, qdmat, n1s, types, tab, dmat, n2,
                  uniforms, C, r_seq, lorder, lsoln, p):
    dev = types.device
    K, n1r = qtypes.shape
    E, d2 = types.shape
    B = K * E
    P = slots_per_restart(n1r, p.maxiter)
    # per-(query, entry) rows: b = q * E + e
    qt = qtypes.to(I64)[:, None].expand(K, E, n1r).reshape(B, n1r)
    qc = qtab.to(I64)[:, None].expand(K, E, n1r, n1r).reshape(
        B, n1r, n1r)
    qd = qdmat[:, None].expand(K, E, n1r, n1r).reshape(B, n1r, n1r)
    n1 = n1s.to(I64)[:, None].expand(K, E).reshape(B)
    t2 = types.to(I64)[None].expand(K, E, d2).reshape(B, d2)
    c2 = tab.to(I64).reshape(1, E, d2 * d2).expand(K, E, d2 * d2).reshape(
        B, d2 * d2)
    dm2 = dmat.reshape(1, E, d2 * d2).expand(K, E, d2 * d2).reshape(
        B, d2 * d2)
    nn2 = n2.to(I64)[None].expand(K, E).reshape(B)
    u_all = uniforms.reshape(B, r_seq, P, C)

    iota1 = torch.arange(n1r, device=dev)[None, :, None]  # [1, n1r, 1]
    iota2 = torch.arange(d2, device=dev)[None, :, None]  # [1, d2, 1]
    n1c = n1[:, None]  # [B, 1]
    n2c = nn2[:, None]
    n2b = nn2[:, None, None]
    n1f = n1.to(F32)[:, None]
    eps = torch.tensor(p.eps, dtype=F32, device=dev)
    mxssed = torch.tensor(p.mxssed, dtype=F32, device=dev)
    matchprob = torch.tensor(p.init_matchprob, dtype=F32, device=dev)
    temps = [np.float32(p.temp0)]  # temp *= alpha in float32
    for _ in range(p.maxiter - 1):
        temps.append(np.float32(temps[-1] * np.float32(p.alpha)))
    temps = torch.tensor(np.array(temps), device=dev)
    n1max = int(n1.max())

    def take2(flat, rowidx, colidx):
        """flat[b, rowidx[b, c] * d2 + colidx[b, k, c]] -> [B, K', C]
        (indices clamped; callers gate the -1 entries)."""
        idx = rowidx.clamp(min=0)[:, None, :] * d2 + colidx.clamp(min=0)
        return torch.gather(flat, 1, idx.reshape(B, -1)).view(idx.shape)

    maxscore = torch.full((B, C), p.maxscore_init, dtype=I64, device=dev)
    bestmap = torch.full((B, n1r, C), -1, dtype=I64, device=dev)
    for r in range(r_seq):
        u = u_all[:, r]  # [B, P, C]
        ssemap = torch.full((B, n1r, C), -1, dtype=I64, device=dev)
        revmap = torch.full((B, d2, C), -1, dtype=I64, device=dev)

        # thinit: greedy random initial matching (kernel.cu:588-648)
        j = torch.zeros((B, C), dtype=I64, device=dev)
        stopped = torch.zeros((B, C), dtype=torch.bool, device=dev)
        for i in range(n1max):
            attempt = (u[:, i] < matchprob) & ~stopped & (i < n1c)
            cmask = ((iota2 >= j[:, None]) & (iota2 < n2b)
                     & (t2 == qt[:, i:i + 1])[:, :, None])
            jfound = torch.where(cmask, iota2, d2).amin(dim=1)  # [B, C]
            ok = attempt & (jfound < n2c)
            stopped = stopped | (attempt & (jfound >= n2c))
            ssemap[:, i] = torch.where(ok, jfound, -1)
            revmap = torch.where((iota2 == jfound[:, None]) & ok[:, None],
                                 i, revmap)
            j = torch.where(ok, jfound + 1, j)

        # initial score: integer sum over pairs i < k (kernel.cu:396-440)
        score = torch.zeros((B, C), dtype=I64, device=dev)
        for i in range(n1max):
            l_i = ssemap[:, i]  # [B, C]
            vd = take2(dm2, l_i, ssemap)  # dmat2[l_i, l_k], [B, n1r, C]
            vc = take2(c2, l_i, ssemap)
            use = ((iota1 > i) & (ssemap >= 0) & (l_i >= 0)[:, None]
                   & ((qd[:, i, :, None] - vd).abs() <= mxssed))
            score = score + torch.where(
                use, _tscord(qc[:, i, :, None], vc), 0).sum(dim=1)
        improved = score > maxscore
        maxscore = torch.where(improved, score, maxscore)
        if lsoln:
            bestmap = torch.where(improved[:, None], ssemap, bestmap)

        # annealing (kernel.cu:1032-1191)
        for it in range(p.maxiter):
            base = n1r + 3 * it
            u_move, u_cand, u_acc = u[:, base], u[:, base + 1], u[:, base + 2]
            ssei = ((u_move - eps) * n1f).to(I64)  # [B, C]
            ssei3 = ssei[:, None]

            if lorder:
                kbest = torch.where((iota1 <= ssei3) & (ssemap >= 0),
                                    iota1, -1).amax(dim=1)
                sj = torch.gather(ssemap, 1, kbest.clamp(min=0)[:, None])
                startj = torch.where(kbest >= 0, sj[:, 0], n2c)
                knext = torch.where((iota1 > ssei3) & (ssemap >= 0),
                                    iota1, n1r).amin(dim=1)
                ej = torch.gather(ssemap, 1,
                                  knext.clamp(max=n1r - 1)[:, None])[:, 0]
                endj = torch.where(ssei == n1c - 1, n2c,
                                   torch.where(knext < n1c, ej, -1))
            else:
                startj = torch.zeros_like(ssei)
                endj = n2c.expand_as(ssei)

            qtype = torch.gather(qt, 1, ssei)  # [B, C]
            cand = ((iota2 >= startj[:, None]) & (iota2 < endj[:, None])
                    & (t2[:, :, None] == qtype[:, None]) & (revmap < 0))
            count = cand.sum(dim=1)
            rpick = ((u_cand - eps) * count.to(F32)).to(I64)
            hit = cand & (torch.cumsum(cand, dim=1) == rpick[:, None] + 1)
            newj = torch.where(hit, iota2, -1).amax(dim=1)  # -1 = unmap
            oldj = torch.gather(ssemap, 1, ssei3)[:, 0]

            # O(n1) incremental delta (kernel.cu:502-535)
            sidx = ssei3.expand(B, n1r, C)
            qdc = torch.gather(qd, 2, sidx)  # qdmat[k, ssei]
            qcc = torch.gather(qc, 2, sidx)
            m = (ssemap >= 0) & (iota1 != ssei3)
            old_d = take2(dm2, oldj, ssemap)
            new_d = take2(dm2, newj, ssemap)
            t_o = (m & (oldj >= 0)[:, None] & (ssemap != oldj[:, None])
                   & ((qdc - old_d).abs() <= mxssed))
            t_n = (m & (newj >= 0)[:, None] & (ssemap != newj[:, None])
                   & ((qdc - new_d).abs() <= mxssed))
            tsc_o = _tscord(qcc, take2(c2, oldj, ssemap))
            tsc_n = _tscord(qcc, take2(c2, newj, ssemap))
            delta = (torch.where(t_n, tsc_n, 0)
                     - torch.where(t_o, tsc_o, 0)).sum(dim=1)

            # max tracking before acceptance (kernel.cu:1136-1155)
            newscore = score + delta
            improved = newscore > maxscore
            maxscore = torch.where(improved, newscore, maxscore)
            at_ssei = iota1 == ssei3
            if lsoln:
                moved = torch.where(at_ssei, newj[:, None], ssemap)
                bestmap = torch.where(improved[:, None], moved, bestmap)

            # log-domain Metropolis acceptance: the slot carries ln u
            accept = delta.to(F32) > temps[it] * u_acc
            acc3 = accept[:, None]
            score = torch.where(accept, newscore, score)
            ssemap = torch.where(at_ssei & acc3, newj[:, None], ssemap)
            revmap = torch.where((iota2 == oldj[:, None]) & acc3
                                 & (oldj >= 0)[:, None], -1, revmap)
            revmap = torch.where((iota2 == newj[:, None]) & acc3
                                 & (newj >= 0)[:, None], ssei3, revmap)

    # the first maximal chain wins (kernel.cu:1194-1233)
    best = maxscore.amax(dim=1)
    chains = torch.arange(C, device=dev)
    winner = torch.where(maxscore == best[:, None], chains, C).amin(dim=1)
    scores = best.to(torch.int32).view(K, E)
    if not lsoln:
        return scores, None
    maps = torch.gather(bestmap, 2,
                        winner[:, None, None].expand(B, n1r, 1))[..., 0]
    return scores, maps.to(torch.int32).view(K, E, n1r)
