"""The plain reference against the scalar specification and against the
program's plain (-c) path; the control against the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from satbench.cells import BENCH
from satbench.reference import dbfile, sa, spec, stream

DB = str(BENCH / "data" / "astral586.ascii")
INDEX = dbfile.index_file(DB)


def spec_search(q, e, tag, index, seed, maxstart, lorder, lsoln):
    c_par, r_seq = stream.choose_chains(maxstart)
    n1r = stream.round8(q.order)
    P = n1r + 3 * spec.MAXITER
    key = stream.pair_keys(seed, [tag], [index])
    us = []
    for r in range(r_seq):
        u = stream.uniforms(stream.fold_in(key, r), P, c_par)[0].clone()
        acc = torch.arange(n1r + 2, P, 3)
        u[acc] = stream.ln_f32(u[acc])
        us.append(u.numpy())
    return spec.search_entry(q, e, lorder, np.stack(us), lsoln=lsoln)


@pytest.mark.parametrize("lorder", [True, False])
@pytest.mark.parametrize("maxstart", [8, 258])
def test_reference_is_the_scalar_specification(lorder, maxstart):
    """Pair by pair and chain by chain; 258 restarts run as 86 chains of
    3 restarts each."""
    rng = np.random.default_rng(maxstart)
    npairs = 12 if maxstart == 8 else 2
    qs = [int(i) for i in rng.choice(len(INDEX.names), npairs)]
    es = [int(i) for i in rng.choice(len(INDEX.names), npairs)]
    es[0] = int(np.argmax(INDEX.orders))  # the widest entry
    q = [INDEX.entry(i) for i in qs]
    e = [INDEX.entry(i) for i in es]
    tags = list(range(npairs))
    scores, maps = sa.search_pairs(q, e, tags, es, seed=-5, maxstart=maxstart,
                                   lorder=lorder, lsoln=True, device="cpu")
    for b in range(npairs):
        s, m = spec_search(q[b], e[b], tags[b], es[b], -5, maxstart, lorder,
                           True)
        assert scores[b] == s
        assert np.array_equal(maps[b], m)


def test_reference_is_the_programs_plain_path(tmp_path):
    """The session's -c path (plain engine on the CPU) at r = 8: every
    score, map and statistic of a list and of a single search."""
    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                     SessionConfig)
    from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats
    from satbench.reference.stats import score_stats as ref_stats

    lines = open(DB).read().split("\n")
    sel = list(range(0, len(INDEX.names), 25))
    path = tmp_path / "small.ascii"
    with open(path, "w") as fh:
        for i in sel:
            n = int(INDEX.orders[i])
            fh.write("\n".join(lines[INDEX.starts[i]:
                                     INDEX.starts[i] + 1 + 2 * n]) + "\n\n")
    index = dbfile.index_file(str(path))
    sess = SearchSession(str(path), SessionConfig(maxstart=8, seed=4321,
                                                  device="cpu"))
    queries = [0, 3, 7]
    many = sess.search_many([sess.resolve_query(index.names[i])
                             for i in queries], lsoln=False)
    one = sess.search(sess.resolve_query(index.names[5]), lsoln=True)
    entries = [index.entry(i) for i in range(len(index.names))]
    E = len(entries)
    for tag, (qi, res) in enumerate(zip(queries + [5], many + [one])):
        scores, maps = sa.search_pairs([entries[qi]] * E, entries, [tag] * E,
                                       list(range(E)), seed=4321,
                                       maxstart=8, lorder=True,
                                       lsoln=tag == 3, device="cpu")
        assert res.names == index.names
        assert np.array_equal(res.scores, scores)
        if tag == 3:
            assert all(np.array_equal(res.ssemaps[e], maps[e])
                       for e in range(E))
        got = score_stats(res.scores, entries[qi].order, res.orders)
        want = ref_stats(scores, entries[qi].order, index.orders)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_the_control_is_not_the_reference():
    """The reference in bfloat16 changes answers that float32 gives: at
    this seed, some of 300 pairs at r = 8."""
    rng = np.random.default_rng(1)
    qs = [int(i) for i in rng.choice(len(INDEX.names), 300)]
    es = [int(i) for i in rng.choice(len(INDEX.names), 300)]
    q = [INDEX.entry(i) for i in qs]
    e = [INDEX.entry(i) for i in es]
    kw = dict(seed=99, maxstart=8, lorder=True, lsoln=True, device="cpu")
    s32, m32 = sa.search_pairs(q, e, list(range(300)), es, **kw)
    s16, m16 = sa.search_pairs(q, e, list(range(300)), es,
                               precision="bfloat16", **kw)
    assert int((s32 != s16).sum()) + sum(
        not np.array_equal(a, b) for a, b in zip(m32, m16)) > 0
