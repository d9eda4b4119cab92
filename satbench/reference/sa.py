"""The plain reference of the SA search, vectorized over pairs and chains.

What one (query, entry) pair of a search computes, written from the
scalar specification (reference/spec.py ``search_entry``) in plain
PyTorch: every chain of every pair runs in lockstep, one tensor
operation over all of them per step of the specification.  It imports
nothing of the program and takes nothing the program made: the entries
come from reference/dbfile.py, the stream from reference/stream.py.

``precision`` "float32" is the configuration's arithmetic: distances on
the bf16 grid compared by a float32 difference, the Metropolis test
``delta > temp * ln u`` and the cooling ``temp *= alpha`` in float32.
"bfloat16" is the benchmark's control: the same two steps rounded to
bfloat16, the nearest precision below, which a correct run must not be
taken for.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec
from .stream import (choose_chains, fold_in, ln_f32, pair_keys, round8,
                     uniforms)

I64 = torch.int64
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# elements of the largest [pairs, chains, n1, n1] temporary of one block
BLOCK_ELEMS = 1 << 24


def _tscord(x, y):
    """Pair score on packed hi*8 + lo codes: 2 both halves equal, 1 one,
    -2 none."""
    he = (x >> 3) == (y >> 3)
    le = (x & 7) == (y & 7)
    return torch.where(he & le, 2, torch.where(he | le, 1, -2))


def _close(qd, dd, dtype):
    """|qd - dd| <= MXSSED, the difference taken in ``dtype``."""
    if dtype == torch.float32:
        diff = qd - dd
    else:
        diff = qd.to(dtype) - dd.to(dtype)
    return diff.abs() <= spec.MXSSED


def _pad(arrays, n, fill, dtype):
    """Stack square or vector arrays padded to n (per trailing dim)."""
    out = np.full((len(arrays),) + (n,) * arrays[0].ndim, fill, dtype)
    for b, a in enumerate(arrays):
        out[(b,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def search_pairs(queries, entries, tags, indices, *, seed: int,
                 maxstart: int, lorder: bool, lsoln: bool, device,
                 precision: str = "float32",
                 maxiter: int = spec.MAXITER):
    """Search pair b = (queries[b], entries[b]) with query tag tags[b]
    against the entry of file-order index indices[b] (entries from
    reference/dbfile.py).  Returns (scores int32[B], maps: a list of
    int32[n1] or None): the max over all restarts and the best map of
    the first maximal chain, as spec.search_entry gives them."""
    B = len(queries)
    scores = np.zeros(B, np.int32)
    maps = [None] * B if lsoln else None
    c_par, r_seq = choose_chains(maxstart)
    order = sorted(range(B), key=lambda b: (queries[b].order,
                                            entries[b].order))
    at = 0
    while at < B:
        n1 = queries[order[at]].order
        n2 = max(entries[order[at]].order, 8)
        block = [order[at]]
        at += 1
        while at < B:
            b = order[at]
            n1b, n2b = queries[b].order, max(n2, entries[b].order)
            if ((len(block) + 1) * c_par * max(n1b * n1b, n2b) > BLOCK_ELEMS
                    or round8(n1b) != round8(n1)):
                break
            block.append(b)
            n1, n2 = n1b, n2b
            at += 1
        s, m = _search_block([queries[b] for b in block],
                             [entries[b] for b in block],
                             [tags[b] for b in block],
                             [indices[b] for b in block], seed=seed,
                             c_par=c_par, r_seq=r_seq, lorder=lorder,
                             lsoln=lsoln, device=torch.device(device),
                             dtype=PRECISIONS[precision], maxiter=maxiter)
        for i, b in enumerate(block):
            scores[b] = s[i]
            if lsoln:
                maps[b] = m[i]
    return scores, maps


def _search_block(qs, es, tags, indices, *, seed, c_par, r_seq, lorder,
                  lsoln, device, dtype, maxiter):
    B, C = len(qs), c_par
    N1 = max(q.order for q in qs)
    N2 = max(e.order for e in es)

    def put(x):
        return torch.from_numpy(x).to(device)

    n1 = put(np.array([q.order for q in qs], np.int64))
    n2 = put(np.array([e.order for e in es], np.int64))
    qtypes = put(_pad([q.types.astype(np.int64) for q in qs], N1, 127,
                      np.int64))
    qtab = put(_pad([q.tabhi.astype(np.int64) * 8 + q.tablo for q in qs],
                    N1, 0, np.int64))
    qd = put(_pad([q.dmat for q in qs], N1, 0.0, np.float32))
    dtypes = put(_pad([e.types.astype(np.int64) for e in es], N2, -1,
                      np.int64))
    dtab = put(_pad([e.tabhi.astype(np.int64) * 8 + e.tablo for e in es],
                    N2, 0, np.int64)).view(B, N2 * N2)
    dd = put(_pad([e.dmat for e in es], N2, 1.0e9, np.float32)
             ).view(B, N2 * N2)
    keys = pair_keys(seed, tags, indices, device=device)
    n1r = put(np.array([round8(q.order) for q in qs], np.int64))
    P = int(n1r.max()) + 3 * maxiter

    kidx = torch.arange(N1, device=device)
    jidx = torch.arange(N2, device=device)
    n1c = n1.view(B, 1)
    n2c = n2.view(B, 1)
    n1f = n1c.to(torch.float32)
    eps = torch.tensor(np.float32(spec.EPS), device=device)
    # nxt[b, t, j]: the first j' >= j with type t (N2 if none), j <= N2
    pos = torch.where(dtypes[:, None, :] == torch.arange(4, device=device
                                                         ).view(1, 4, 1),
                      jidx.view(1, 1, N2), N2)
    pos = torch.cat([pos, torch.full((B, 4, 1), N2, dtype=I64,
                                     device=device)], dim=2)
    nxt = pos.flip(2).cummin(2).values.flip(2).reshape(B, 4 * (N2 + 1))
    upper = (kidx.view(N1, 1) < kidx.view(1, N1)).view(1, 1, N1, N1)
    qd_b = qd.view(B, 1, N1, N1)
    qtab_b = qtab.view(B, 1, N1, N1)
    qd_rows = qd.view(B, N1 * N1)
    qtab_rows = qtab.view(B, N1 * N1)

    def trunc_index(u, n):
        return ((u - eps) * n).to(I64)

    def gather_db(flat_idx, table):
        """table[b, flat_idx[b, ...]] for a table viewed [B, N2 * N2]."""
        shape = flat_idx.shape
        return table.gather(1, flat_idx.reshape(B, -1)).view(shape)

    def full_score(ssemap):
        m = ssemap.clamp(min=0)
        flat = m.view(B, C, N1, 1) * N2 + m.view(B, C, 1, N1)
        valid = (ssemap >= 0)
        pair = valid.view(B, C, N1, 1) & valid.view(B, C, 1, N1) & upper
        close = _close(qd_b, gather_db(flat, dd), dtype)
        sc = _tscord(qtab_b, gather_db(flat, dtab))
        return torch.where(pair & close, sc, 0).sum(dim=(2, 3))

    maxscore = torch.full((B, C), spec.MAXSCORE_INIT, dtype=I64,
                          device=device)
    bestmap = torch.full((B, C, N1), -1, dtype=I64, device=device)
    bc = torch.arange(B * C, device=device)
    for r in range(r_seq):
        u = uniforms(fold_in(keys, r), P, C)  # [B, P, C]

        def slot(s):
            return u.gather(1, s.view(B, 1, 1).expand(B, 1, C)).view(B, C)

        # thinit: greedy random initial matching, monotone cursor
        ssemap = torch.full((B, C, N1), -1, dtype=I64, device=device)
        revmap = torch.full((B, C, N2 + 1), -1, dtype=I64, device=device)
        cursor = torch.zeros((B, C), dtype=I64, device=device)
        done = torch.zeros((B, C), dtype=torch.bool, device=device)
        for i in range(N1):
            act = ((i < n1c) & ~done
                   & (u[:, i, :] < np.float32(spec.INIT_MATCHPROB)))
            t = qtypes[:, i].clamp(0, 3).view(B, 1)
            jn = nxt.gather(1, t * (N2 + 1) + cursor)
            off = jn >= n2c
            done = done | (act & off)
            ok = act & ~off
            ssemap[:, :, i] = torch.where(ok, jn, -1)
            revmap.view(-1).index_put_(
                (bc * (N2 + 1) + torch.where(ok, jn, N2).view(-1),),
                torch.where(ok, i, -1).view(-1))
            cursor = torch.where(ok, jn + 1, cursor)
        revmap[:, :, N2] = -1
        score = full_score(ssemap)
        better = score > maxscore
        maxscore = torch.where(better, score, maxscore)
        bestmap = torch.where(better.view(B, C, 1), ssemap, bestmap)

        temp = np.float32(spec.TEMP0)
        for it in range(maxiter):
            s = n1r + 3 * it
            ssei = trunc_index(slot(s), n1f)  # [B, C]
            if lorder:
                mapped = ssemap >= 0
                below = torch.where(mapped & (kidx <= ssei.view(B, C, 1)),
                                    kidx, -1).max(dim=2).values
                startj = torch.where(
                    below >= 0,
                    ssemap.gather(2, below.clamp(min=0).view(B, C, 1)
                                  ).view(B, C), n2c)
                above = torch.where(mapped & (kidx > ssei.view(B, C, 1)),
                                    kidx, N1).min(dim=2).values
                endj = torch.where(
                    above < N1,
                    ssemap.gather(2, above.clamp(max=N1 - 1).view(B, C, 1)
                                  ).view(B, C), -1)
                endj = torch.where(ssei == n1c - 1, n2c, endj)
            else:
                startj = torch.zeros_like(ssei)
                endj = n2c.expand(B, C)
            qt = qtypes.gather(1, ssei)  # [B, C]
            cand = ((dtypes.view(B, 1, N2) == qt.view(B, C, 1))
                    & (revmap[:, :, :N2] < 0)
                    & (jidx >= startj.clamp(min=0).view(B, C, 1))
                    & (jidx < endj.clamp(min=0).view(B, C, 1)))
            count = cand.sum(dim=2)
            ridx = torch.where(count >= 2,
                               trunc_index(slot(s + 1),
                                           count.to(torch.float32)), 0)
            hit = cand & (cand.cumsum(dim=2) == (ridx + 1).view(B, C, 1))
            newj = torch.where(count > 0, hit.to(torch.int8).argmax(dim=2),
                               -1)
            oldj = ssemap.gather(2, ssei.view(B, C, 1)).view(B, C)

            # the O(n1) delta of remapping ssei: oldj -> newj
            l = ssemap
            lc = l.clamp(min=0)
            row = ssei.view(B, C, 1) * N1 + kidx
            d1 = qd_rows.gather(1, row.view(B, -1)).view(B, C, N1)
            qrow = qtab_rows.gather(1, row.view(B, -1)).view(B, C, N1)
            base = (l >= 0) & (kidx != ssei.view(B, C, 1))
            delta = torch.zeros((B, C), dtype=I64, device=device)
            for j, sign in ((oldj, -1), (newj, 1)):
                jv = j.view(B, C, 1)
                flat = jv.clamp(min=0) * N2 + lc
                term = (base & (jv >= 0) & (l != jv)
                        & _close(d1, gather_db(flat, dd), dtype))
                delta += sign * torch.where(
                    term, _tscord(qrow, gather_db(flat, dtab)), 0).sum(dim=2)

            newscore = score + delta
            better = newscore > maxscore
            maxscore = torch.where(better, newscore, maxscore)
            if lsoln:
                moved = ssemap.scatter(2, ssei.view(B, C, 1),
                                       newj.view(B, C, 1))
                bestmap = torch.where(better.view(B, C, 1), moved, bestmap)
            lnu = ln_f32(slot(s + 2))
            if dtype == torch.float32:
                thresh = torch.tensor(temp, device=device) * lnu
                accept = delta.to(torch.float32) > thresh
            else:
                thresh = (torch.tensor(temp, device=device).to(dtype)
                          * lnu.to(dtype))
                accept = delta.to(torch.float32) > thresh.to(torch.float32)
            score = torch.where(accept, newscore, score)
            ssemap.scatter_(2, ssei.view(B, C, 1),
                            torch.where(accept, newj, oldj).view(B, C, 1))
            flat_rev = bc.view(B, C) * (N2 + 1)
            clear = accept & (oldj >= 0)
            revmap.view(-1).index_put_(
                ((flat_rev + torch.where(clear, oldj, N2)).view(-1),),
                torch.full((B * C,), -1, dtype=I64, device=device))
            setn = accept & (newj >= 0)
            revmap.view(-1).index_put_(
                ((flat_rev + torch.where(setn, newj, N2)).view(-1),),
                torch.where(setn, ssei, -1).view(-1))
            revmap[:, :, N2] = -1
            if dtype == torch.float32:
                temp = np.float32(temp * np.float32(spec.ALPHA))
            else:
                temp = np.float32(torch.tensor(
                    np.float32(temp * np.float32(spec.ALPHA))).to(dtype)
                    .float().item())

    best = maxscore.max(dim=1)
    chain = maxscore.argmax(dim=1)  # the first maximal chain
    score_out = best.values.cpu().numpy().astype(np.int32)
    maps_out = None
    if lsoln:
        bm = bestmap[torch.arange(B, device=device), chain].cpu().numpy()
        maps_out = [bm[b, :qs[b].order].astype(np.int32) for b in range(B)]
    return score_out, maps_out
