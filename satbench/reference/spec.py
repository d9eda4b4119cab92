"""The scalar specification of one SA chain: a frozen copy.

Copied from cuda_satabsearch_tpu_torch/ops/golden.py at commit
d4cb1337b7aaf96a99aa4443f325ec93637d3526, with the algorithm's
constants (core/constants.py) and the pair score (core/codes.py
``tscord``) of the same commit written in, so that it imports nothing
of the program.  The benchmark's vectorized reference (reference/sa.py)
is held against it chain by chain in the benchmark's tests.

This is the executable specification: a plain-NumPy, single-chain
implementation of the exact move/score/acceptance semantics of the
reference kernel (the reference's nvcc_src_current/cudaSaTabsearch_kernel.cu),
including its quirks:

* thinit greedy random initial matching with monotone db cursor and
  early-return when the cursor runs off the end (kernel.cu:588-648);
* the LORDER window: startj = mapping of the nearest mapped predecessor
  (including ssei itself), falling back to n2 (empty window) when none;
  endj = mapping of the nearest mapped successor, n2 when ssei is last,
  and -1 (empty window) when no successor is mapped (kernel.cu:1053-1083);
* candidate selection uniform over same-type unmatched SSEs in
  [startj, endj), newj = -1 meaning "unmap ssei" (kernel.cu:677-714);
* O(n1) incremental delta with the l != old_j / l != new_j / k != sse_i
  guards (kernel.cu:502-535);
* max-score tracking *before* the Metropolis acceptance test
  (kernel.cu:1136-1155), acceptance by expf(delta/temp) > u in float32
  (kernel.cu:1166), geometric cooling temp *= ALPHA (kernel.cu:1189);
* index sampling by truncation of (u - EPS) * n (kernel.cu:1042, :710).

Randomness is supplied by the caller as a flat array of uniforms in
[0, 1) consumed at *fixed slots*: per restart, slot i for query SSE i in
thinit and slots round8(n1) + 3*it + {0,1,2} for (move, candidate,
accept) of iteration it — the n1r schedule (ops/common.py round8), so
every query order in the same 8-padded bucket shares one stream layout
(what lets mixed-order query batches run bitwise-identically to
sequential dispatch).  The reference consumes uniforms data-dependently, but
scores are RNG-stream-dependent anyway (its own CPU and GPU paths give
different per-entry scores for the same input,
README_example_usage.txt:43-49 vs :92-98); a fixed schedule is what lets
the vectorized engines be tested against this model in bitwise
lockstep.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the algorithm's constants (saparams.h:28-43, cudaSaTabsearch_kernel.cu
# :67, :1009), as core/constants.py holds them
MXSSED = 4.0
MAXITER = 100
TEMP0 = 10.0
ALPHA = 0.95
INIT_MATCHPROB = 0.5
EPS = 1.1e-7
MAXSCORE_INIT = -99999


def tscord(xhi: int, xlo: int, yhi: int, ylo: int) -> int:
    """Discrete tableau pair score: 2 if both halves equal, 1 if exactly
    one half equal, else -2 (cudaSaTabsearch_kernel.cu:306-332)."""
    he = xhi == yhi
    le = xlo == ylo
    if he and le:
        return 2
    if he or le:
        return 1
    return -2

F32 = np.float32


def trunc_index(u, n: int) -> int:
    """Reference index sampling: truncation toward zero of (u-EPS)*n."""
    return int(np.int32(F32((F32(u) - F32(EPS)) * F32(n))))


def thinit(qtypes, n1, dbtypes, n2, ssemap, revmap, u_arr):
    """Random greedy initial matching (kernel.cu:588-648).

    u_arr: n1 uniforms, one per query SSE (slot i may go unused after the
    early return; that keeps the slot schedule fixed).
    """
    ssemap[:n1] = -1
    revmap[:n2] = -1
    j = 0
    for i in range(n1):
        if u_arr[i] < INIT_MATCHPROB:
            while j < n2 and qtypes[i] != dbtypes[j]:
                j += 1
            if j >= n2:
                return  # rest left unmapped (early return, kernel.cu:633-639)
            ssemap[i] = j
            revmap[j] = i
            j += 1


def tmscord(qtabhi, qtablo, qdmat, n1, tabhi, tablo, dmat, n2, ssemap) -> int:
    """Full O(n1^2) score of a mapping (kernel.cu:396-440)."""
    score = 0
    for i in range(n1):
        j = ssemap[i]
        if j < 0:
            continue
        for k in range(i + 1, n1):
            l = ssemap[k]
            if l < 0:
                continue
            if abs(qdmat[i, k] - dmat[j, l]) <= MXSSED:
                score += tscord(qtabhi[i, k], qtablo[i, k],
                                tabhi[j, l], tablo[j, l])
    return score


def deltasd(qtabhi, qtablo, qdmat, n1, tabhi, tablo, dmat, n2,
            ssemap, sse_i, old_j, new_j) -> int:
    """O(n1) score delta for remapping sse_i: old_j -> new_j
    (kernel.cu:502-535)."""
    delta = 0
    for k in range(n1):
        l = ssemap[k]
        if l < 0:
            continue
        d1 = qdmat[sse_i, k]
        if (old_j >= 0 and l != old_j and k != sse_i
                and abs(d1 - dmat[old_j, l]) <= MXSSED):
            delta -= tscord(qtabhi[sse_i, k], qtablo[sse_i, k],
                            tabhi[old_j, l], tablo[old_j, l])
        if (new_j >= 0 and l != new_j and k != sse_i
                and abs(d1 - dmat[new_j, l]) <= MXSSED):
            delta += tscord(qtabhi[sse_i, k], qtablo[sse_i, k],
                            tabhi[new_j, l], tablo[new_j, l])
    return delta


def lorder_window(ssemap, ssei, n1, n2) -> tuple[int, int]:
    """The order-constraint candidate window (kernel.cu:1053-1078)."""
    startj = ssemap[ssei]
    k = ssei
    while startj < 0 and k >= 0:
        startj = ssemap[k]
        k -= 1
    if startj < 0:
        startj = n2
    if ssei == n1 - 1:
        endj = n2
    elif ssemap[ssei + 1] < 0:
        endj = -1
        k = 1
        while endj == -1 and ssei + k < n1:
            endj = ssemap[ssei + k]
            k += 1
    else:
        endj = ssemap[ssei + 1]
    return startj, endj


def randtypeind(dbtypes, n2, startind, ssetype, smap, endind, u) -> int:
    """Uniform pick among same-type unmatched SSEs in [startind, endind)
    (kernel.cu:677-714).  ``u`` is this slot's uniform (used only when
    there are >= 2 candidates, as in the reference)."""
    indlist = [i for i in range(max(startind, 0), max(endind, 0))
               if dbtypes[i] == ssetype and smap[i] < 0]
    if len(indlist) == 0:
        return -1
    if len(indlist) == 1:
        return indlist[0]
    ridx = trunc_index(u, len(indlist))
    return indlist[ridx]


@dataclass
class ChainResult:
    maxscore: int
    bestmap: np.ndarray  # int32 [n1]
    final_ssemap: np.ndarray
    final_score: int


def sa_chain(query, db, lorder: bool, nrestarts: int,
             uniforms: np.ndarray, lsoln: bool = True,
             maxiter: int = MAXITER) -> ChainResult:
    """Run one SA chain: ``nrestarts`` sequential restarts carrying the
    running max (the per-thread restart loop, kernel.cu:1014-1192).

    query/db: objects with .types, .tabhi, .tablo, .dmat, .order
    uniforms: flat float32 array of length
              nrestarts * (round8(n1) + 3*maxiter) — the slot base is
              the ROUNDED order (uniforms_per_restart), per module doc.
    """
    n1, n2 = query.order, db.order
    n1r = max(8, -(-n1 // 8) * 8)  # == ops.common.round8
    uniforms = np.asarray(uniforms, dtype=np.float32)
    per_restart = n1r + 3 * maxiter
    assert uniforms.size >= nrestarts * per_restart

    ssemap = np.full(n1, -1, dtype=np.int64)
    revmap = np.full(n2, -1, dtype=np.int64)
    bestmap = np.full(n1, -1, dtype=np.int64)
    maxscore = MAXSCORE_INIT
    score = 0

    for restart in range(nrestarts):
        base = restart * per_restart
        thinit(query.types, n1, db.types, n2, ssemap, revmap,
               uniforms[base:base + n1])
        score = tmscord(query.tabhi, query.tablo, query.dmat, n1,
                        db.tabhi, db.tablo, db.dmat, n2, ssemap)
        if score > maxscore:
            maxscore = score
            bestmap[:] = ssemap  # unconditional at restart init (kernel.cu:1024-1028)
        temp = F32(TEMP0)
        for it in range(maxiter):
            s = base + n1r + 3 * it
            u_move, u_cand, u_acc = uniforms[s], uniforms[s + 1], uniforms[s + 2]
            ssei = trunc_index(u_move, n1)
            if lorder:
                startj, endj = lorder_window(ssemap, ssei, n1, n2)
            else:
                startj, endj = 0, n2
            newj = randtypeind(db.types, n2, startj, query.types[ssei],
                               revmap, endj, u_cand)
            oldj = ssemap[ssei]
            delta = deltasd(query.tabhi, query.tablo, query.dmat, n1,
                            db.tabhi, db.tablo, db.dmat, n2,
                            ssemap, ssei, oldj, newj)
            newscore = score + delta
            if newscore > maxscore:
                maxscore = newscore
                if lsoln:
                    bestmap[:] = ssemap
                    bestmap[ssei] = newj if newj > -1 else -1
            # acceptance in log domain: the accept slot carries ln(u)
            # (see engine.py log_acc_slots) so the test is pure f32
            # arithmetic — bit-identical across NumPy, XLA, and Mosaic,
            # unlike exp/log lowerings.  Equivalent to the reference's
            # expf(delta/temp) > u (kernel.cu:1166).
            if F32(delta) > temp * F32(u_acc):
                score = newscore
                if newj > -1:
                    ssemap[ssei] = newj
                    if oldj > -1:
                        revmap[oldj] = -1
                    revmap[newj] = ssei
                else:
                    if oldj > -1:
                        revmap[oldj] = -1
                    ssemap[ssei] = -1
            temp = F32(temp * F32(ALPHA))

    return ChainResult(maxscore=int(maxscore),
                       bestmap=bestmap.astype(np.int32),
                       final_ssemap=ssemap.astype(np.int32),
                       final_score=int(score))


def uniforms_per_restart(n1: int, maxiter: int = MAXITER) -> int:
    return max(8, -(-n1 // 8) * 8) + 3 * maxiter  # the n1r schedule


def search_entry(query, db, lorder: bool, uniforms: np.ndarray,
                 lsoln: bool = True,
                 maxiter: int = MAXITER) -> tuple[int, np.ndarray]:
    """One (query, entry) search as the engines run it: chain c runs
    ``sa_chain`` on column c of ``uniforms`` f32[r_seq, P, c_par] (the
    engines' layout for one query and entry, P the per-restart slot
    count), the score is the max over chains and the map is the best
    map of the first maximal chain.  Returns (score, int32[n1])."""
    uniforms = np.asarray(uniforms, dtype=np.float32)
    r_seq, _, c_par = uniforms.shape
    res = [sa_chain(query, db, lorder=lorder, nrestarts=r_seq,
                    uniforms=uniforms[:, :, c].reshape(-1), lsoln=lsoln,
                    maxiter=maxiter)
           for c in range(c_par)]
    scores = [r.maxscore for r in res]
    best = int(np.argmax(scores))  # the first maximal chain
    return scores[best], res[best].bestmap
