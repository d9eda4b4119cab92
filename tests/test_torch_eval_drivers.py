"""The port's three evaluation drivers (``make_eval_artifact``,
``gumbel_fit_artifact``, ``acceptance_eval``) with ``-c`` at a small r,
against the same pipeline put together from the JAX package's pieces on
the CPU.

The port's drivers run as processes, as a user runs them, at the same
time as the JAX package's ``-c`` CLI (the JAX side of
``make_eval_artifact``); the JAX package's ``SearchSession`` searches in
this process meanwhile.  The JAX package's scripts/ drivers write into
eval_artifacts/ and are never run: only their pure functions
(``build_gold``, ``load_scores``, ``sample_queries``) are called.
Tables must be byte-identical apart from the program name and the time
columns, fits within 1e-12.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu.eval import __main__ as jmain  # noqa: E402
from cuda_satabsearch_tpu.eval import acceptance as jacc  # noqa: E402
from cuda_satabsearch_tpu.eval import gumbelfit as jgumbel  # noqa: E402
from cuda_satabsearch_tpu.eval import timestab as jtimestab  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import acceptance as tacc  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import (  # noqa: E402
    acceptance_eval, gumbel_fit_artifact, make_eval_artifact)
from cuda_satabsearch_tpu_torch.eval import timestab as ttimestab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
R = 8  # restarts of every search here
HEADER = re.compile(r"^# \S+ LTYPE = ", re.M)
DRIVERS = {
    "make_eval_artifact": ["-c", "--rows", "torch", "--restarts", str(R)],
    "gumbel_fit_artifact": ["-c", "--restarts", str(R), "--nqueries", "4"],
    "acceptance_eval": ["-c", "--restarts", str(R)],
}


def _script(name):
    """A module of the JAX package's scripts/, loaded for its functions
    (its ``main`` is never called)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _null_sample(q, res, drop_top=5):
    """scripts/gumbel_fit_artifact.py:83-96 (a closure there)."""
    from cuda_satabsearch_tpu.stats.gumbel import norm2

    n2s = np.asarray([norm2(s, q.order, res.orders[i])
                      for i, s in enumerate(res.scores)], dtype=np.float64)
    order = np.argsort(n2s)[::-1]
    keep = np.ones(len(n2s), bool)
    keep[order[:drop_top]] = False
    for i, name in enumerate(res.names):
        if name.lower() == q.name.lower():
            keep[i] = False
    return n2s[keep]


def _jax_searches():
    """The JAX package's CPU engine on the acceptance queries and on the
    Gumbel sample: {"acceptance": [(query, n1, ParityReport)],
    "gumbel": fits in gumbel_fit_artifact.fit_all's layout,
    "picks": the sampled names}.  Query tags follow each driver's
    input order, as one session per driver numbers them."""
    from cuda_satabsearch_tpu.io.pack import pack_query
    from cuda_satabsearch_tpu.io.parser import parse_search_input
    from cuda_satabsearch_tpu.session import SearchSession, SessionConfig
    from cuda_satabsearch_tpu.stats.gumbel import norm2

    jacc_script = _script("acceptance_eval")
    sess = SearchSession(acceptance_eval.DB586,
                         SessionConfig(maxstart=R, backend="xla"))
    rows = []
    for tag, (qname, n1) in enumerate(jacc_script.QUERIES.items()):
        with open(os.path.join(FIXTURES, f"{qname}.input")) as fp:
            q = pack_query(parse_search_input(fp).queries[0])
        res = sess.search(q, lorder=True, lsoln=False, query_tag=tag)
        ours = {res.names[i]: norm2(int(res.scores[i]), n1,
                                    int(res.orders[i]))
                for i in range(res.nentries)}
        ref = jacc_script.load_scores(os.path.join(
            acceptance_eval.GOLDEN, f"{qname}_small_r128.out"))
        rows.append((qname, n1, jacc.parity_report(ours, ref)))

    picks = _script("gumbel_fit_artifact").sample_queries(sess.db, 4)
    queries = [q for q in (sess.resolve_query(n) for n in picks)
               if q is not None and q.order >= 3]
    per_query, pooled = [], []
    by_regime = {r: [] for r in gumbel_fit_artifact.REGIMES}
    for tag, q in enumerate(queries):
        res = sess.search(q, lorder=True, lsoln=False, query_tag=tag)
        null = _null_sample(q, res)
        a, b = jgumbel.fit_gumbel(null)
        per_query.append((q.name, int(q.order), a, b, int(null.size)))
        for lo, hi in by_regime:
            if lo <= q.order <= hi:
                by_regime[lo, hi].append(null)
        pooled.append(null)
    regimes = []
    for (lo, hi), nulls in by_regime.items():
        if nulls:
            rn = np.concatenate(nulls)
            regimes.append((lo, hi, len(nulls), *jgumbel.fit_gumbel(rn),
                            int(rn.size)))
    allnull = np.concatenate(pooled)
    fits = {"queries": per_query, "regimes": regimes,
            "pooled": (*jgumbel.fit_gumbel(allnull), int(allnull.size))}
    return {"acceptance": rows, "gumbel": fits, "picks": picks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver's output directory and stderr, the JAX ``-c`` CLI's
    multiquery output, and the JAX package's searches."""
    tmp = tmp_path_factory.mktemp("drivers")
    # two threads per process: five processes share the host's cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = {}
    try:
        for name, argv in DRIVERS.items():
            err = open(tmp / f"{name}.err", "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m",
                 f"cuda_satabsearch_tpu_torch.eval.{name}", *argv,
                 "--out", str(tmp / name)],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err),
                err)
        with open(os.path.join(FIXTURES, "multiquery.input")) as fin:
            jout = open(tmp / "jax_multiquery.out", "w")
            err = open(tmp / "jax_cli.err", "w+")
            procs["jax_cli"] = (subprocess.Popen(
                [sys.executable, "-m", "cuda_satabsearch_tpu", "-c", "-r",
                 str(R)], cwd=FIXTURES, env=env, stdin=fin, stdout=jout,
                stderr=err), err)
            jout.close()
        jax = _jax_searches()
        out = {"tmp": tmp, "jax": jax}
        for name, (p, err) in procs.items():
            rc = p.wait(timeout=900)
            err.seek(0)
            out[name] = (rc, err.read())
    finally:
        for p, err in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    return out


def _check_rc(runs, name):
    rc, err = runs[name]
    assert rc == 0, err
    return runs["tmp"] / name if name in DRIVERS else runs["tmp"]


# ------------------------------------------------------ make_eval_artifact

def _jax_artifact(runs, tmp_path, capsys):
    """The JAX pipeline on the JAX CLI's output: gold file, AUC table,
    LaTeX rows, slrtabs, timestab."""
    _check_rc(runs, "jax_cli")
    jmq = str(runs["tmp"] / "jax_multiquery.out")
    gold = str(tmp_path / "gold_oracle_top5.txt")
    _script("make_eval_artifact").build_gold(gold)
    capsys.readouterr()
    out = {}
    for dest, argv in (("auc_table.txt", [jmq, "--gold", gold, "--roc50",
                                          "--slrtab-dir",
                                          str(tmp_path / "slrtabs")]),
                       ("auc_table.tex", [jmq, "--gold", gold, "--roc50",
                                          "--latex"])):
        assert jmain.main(argv) == 0
        out[dest] = capsys.readouterr().out
    secs = float(re.search(r"search time ([\d.]+) ms",
                           runs["jax_cli"][1]).group(1)) / 1e3
    man = tmp_path / "manifest.tsv"
    man.write_text(f"cpu-torch\t{jmq}\t{secs:.2f}\n")
    assert jtimestab.main([str(man), "--gold", gold]) == 0
    out["timestab.tex"] = capsys.readouterr().out
    return gold, out


def test_make_eval_artifact_search_output_equals_jax_cli(runs):
    art = _check_rc(runs, "make_eval_artifact")
    _check_rc(runs, "jax_cli")
    got = (art / "multiquery_cpu-torch.out").read_text()
    ref = (runs["tmp"] / "jax_multiquery.out").read_text()
    assert got.startswith("# torchsatabsearch LTYPE = ")
    assert HEADER.sub("# P LTYPE = ", got) == HEADER.sub("# P LTYPE = ", ref)
    assert got.count("\n") > 3 * 586


def test_make_eval_artifact_tables_equal_jax_pipeline(runs, tmp_path,
                                                      capsys):
    art = _check_rc(runs, "make_eval_artifact")
    gold, ref = _jax_artifact(runs, tmp_path, capsys)
    assert (art / "gold_oracle_top5.txt").read_bytes() == open(
        gold, "rb").read()
    for name in ("auc_table.txt", "auc_table.tex"):
        assert (art / name).read_text() == ref[name], name
    assert "# mean AUC over 2 queries: " in ref["auc_table.txt"]
    slr = {p.name: p.read_bytes() for p in (art / "slrtabs").iterdir()}
    assert slr == {p.name: p.read_bytes()
                   for p in (tmp_path / "slrtabs").iterdir()}
    assert sorted(slr) == ["D1AE6H1.slrtab", "D1UBIA_.slrtab"]

    def cells(tex):  # the time and speedup columns masked
        return [ln.split("&")[:2] if "&" in ln else ln
                for ln in tex.splitlines()]

    got = (art / "timestab.tex").read_text()
    assert cells(got) == cells(ref["timestab.tex"])
    assert got.count(" & ") == 2 * 3  # the header and one row


def test_make_eval_artifact_runs_record(runs):
    art = _check_rc(runs, "make_eval_artifact")
    rec = json.loads((art / "runs.json").read_text())
    assert rec["restarts"] == R
    [row] = rec["rows"]
    assert row["label"] == "cpu-torch"
    assert row["launches"] == 0  # the plain engine, no kernel
    assert 0 < row["seconds"] < row["wall"]
    man = (art / "timestab_manifest.tsv").read_text().splitlines()
    assert man[1] == f"cpu-torch\t{row['results']}\t{row['seconds']:.6f}"
    err = runs["make_eval_artifact"][1]
    assert "# searching on cpu, backend=torch" in err


def test_make_eval_artifact_manifest_keeps_a_fast_row(runs, tmp_path,
                                                    capsys):
    """A row whose search takes 4 ms (the kernel's on the card) keeps its
    time in the manifest, so timestab's speed-up is finite: rounded to
    0.01 s it was 0 and timestab divided by zero."""
    art = _check_rc(runs, "make_eval_artifact")
    results = str(art / "multiquery_cpu-torch.out")
    man = tmp_path / "manifest.tsv"
    make_eval_artifact.write_manifest(str(man), [
        dict(label="h100-cuda", results=results, seconds=0.004),
        dict(label="h100-torch", results=results, seconds=3.895)])
    assert man.read_text().splitlines()[1:] == [
        f"h100-torch\t{results}\t3.895000", f"h100-cuda\t{results}\t0.004000"]
    capsys.readouterr()
    assert ttimestab.main([str(man), "--gold",
                           str(art / "gold_oracle_top5.txt")]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines() if "h100" in ln]
    assert rows[1].split("&")[3].split()[0] == "973.75"


# ----------------------------------------------------- gumbel_fit_artifact

def test_gumbel_sample_equals_jax_script(runs):
    out = _check_rc(runs, "gumbel_fit_artifact")
    fits = json.loads((out / "gumbel_fit.json").read_text())
    picks = runs["jax"]["picks"]
    assert [r[0] for r in fits["queries"]] == picks
    assert len(picks) == 4
    assert fits["restarts"] == R and fits["drop_top"] == 5


def test_gumbel_fits_equal_jax_pipeline(runs):
    out = _check_rc(runs, "gumbel_fit_artifact")
    got = json.loads((out / "gumbel_fit.json").read_text())
    ref = runs["jax"]["gumbel"]
    assert len(got["queries"]) == len(ref["queries"]) == 4
    for g, r in zip(got["queries"], ref["queries"]):
        assert g[0] == r[0] and g[1] == r[1] and g[4] == r[4] == 581
        assert abs(g[2] - r[2]) <= 1e-12 and abs(g[3] - r[3]) <= 1e-12
    assert [g[:3] + g[5:] for g in got["regimes"]] == [
        list(r[:3] + r[5:]) for r in ref["regimes"]]
    for g, r in zip(got["regimes"], ref["regimes"]):
        assert abs(g[3] - r[3]) <= 1e-12 and abs(g[4] - r[4]) <= 1e-12
    (a, b, n), (ra, rb, rn) = got["pooled"], ref["pooled"]
    assert n == rn == 4 * 581
    assert abs(a - ra) <= 1e-12 and abs(b - rb) <= 1e-12
    assert np.isfinite([a, b]).all()


def test_gumbel_report_equals_jax_layout(runs):
    out = _check_rc(runs, "gumbel_fit_artifact")
    md = (out / "gumbel_fit.md").read_text()
    assert md == gumbel_fit_artifact.report(runs["jax"]["gumbel"], R, 5)
    assert md.startswith("# Gumbel fit on this framework's score "
                         "distributions\n")
    assert "a = 0.3780, b = 0.3583." in md
    assert len(re.findall(r"^\| d\w+ \| \d+ \| .* \| 581 \|$", md,
                          re.M)) == 4


# --------------------------------------------------------- acceptance_eval

def test_acceptance_rows_equal_jax_pipeline(runs):
    """The driver's parity rows of an r = 8 search against the r = 128
    oracle (it has none at r = 8) equal the JAX pipeline's."""
    import torch

    from cuda_satabsearch_tpu_torch.session import (SearchSession,
                                                    SessionConfig)

    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)  # the suite's other workers share the cores
        sess = SearchSession(acceptance_eval.DB586,
                             SessionConfig(maxstart=R, device="cpu"))
        got = [(q, n1, R, *acceptance_eval.parity_row(sess, q, 128))
               for q, n1 in acceptance_eval.QUERIES.items()]
    finally:
        torch.set_num_threads(threads)
    md = acceptance_eval.report(got, None, "cpu")
    rows = [ln for ln in md.splitlines() if ln.startswith("| d")]
    ref = [f"| {q} | {n1} | {R} | {rep.spearman:.4f} | {rep.top10:.2f} | "
           f"{rep.top50:.2f} | {rep.auc5:.4f} |  |"
           for q, n1, rep in runs["jax"]["acceptance"]]
    # the port adds a last column, ms per query
    assert [ln.rsplit(" | ", 1)[0] + " |" for ln in rows] == ref
    assert "No verdict: d2phlb1 at r=4096 was not run." in md
    assert "Reference noise floor" not in md  # no reference logs


def test_acceptance_driver_skips_queries_without_an_oracle(runs):
    """At r = 8 the driver finds no oracle output and reports no row."""
    out = _check_rc(runs, "acceptance_eval")
    md = (out / "acceptance.md").read_text()
    assert md.startswith("# Acceptance evaluation")
    assert "## This port vs reference CPU oracle (cpu, backend=torch)" in md
    assert not [ln for ln in md.splitlines() if ln.startswith("| d")]
    assert "No verdict: d2phlb1 at r=4096 was not run." in md
    err = runs["acceptance_eval"][1]
    for q in acceptance_eval.QUERIES:
        assert f"(skipping {q} r={R}: no oracle output at r={R})" in err


def _rows(auc5_by_query, r=4096):
    """Acceptance rows whose reports carry the given auc5."""
    rep = lambda a: tacc.ParityReport(spearman=0.9, top10=0.8, top50=0.7,
                                      auc5=a)
    return [(q, acceptance_eval.QUERIES[q], r, rep(a), 12.5)
            for q, a in auc5_by_query.items()]


@pytest.mark.parametrize("auc5,passed", [(0.9872, True), (0.9815, True),
                                         (0.9814, False)])
def test_acceptance_verdict_without_reference_logs(auc5, passed):
    rows = _rows({"d1ubia_": 1.0, "d2phlb1": auc5})
    ok, text = acceptance_eval.verdict(rows)
    assert ok is passed
    assert ("PASS" if passed else "FAIL") in text
    assert "bar >= 0.9815" in text
    assert "archived logs were not found" in text
    md = acceptance_eval.report(rows, None, "cpu")
    assert "Reference noise floor" not in md
    assert md.rstrip().endswith(text)
    assert acceptance_eval.verdict(_rows({"d2phlb1": auc5}, r=128)) is None


def test_acceptance_floor_from_reference_logs(tmp_path):
    """With the reference's archived logs under --reflog the bar is
    their GPU-vs-CPU auc5 less 0.01, and the report has the floor."""
    gold = os.path.join(acceptance_eval.GOLDEN, "d2phlb1_small_r4096.out")
    assert acceptance_eval.reference_floor(str(tmp_path)) is None
    assert acceptance_eval.reference_floor(None) is None
    for log in (acceptance_eval.CPU_LOG, acceptance_eval.GPU_LOG):
        with open(gold) as src:
            (tmp_path / log).write_text(src.read())
    floor = acceptance_eval.reference_floor(str(tmp_path))
    assert floor.auc5 == 1.0 and floor.spearman == 1.0
    ok, text = acceptance_eval.verdict(_rows({"d2phlb1": 0.9905}), floor)
    assert ok and "delta -0.0095" in text and "archived logs" in text
    ok, _ = acceptance_eval.verdict(_rows({"d2phlb1": 0.9895}), floor)
    assert not ok
    md = acceptance_eval.report(_rows({"d2phlb1": 0.99}), floor, "cpu")
    assert "## Reference noise floor" in md
    assert "| d2phlb1 | 19 | 4096 | 0.9000 | 0.80 | 0.70 | 0.9900 | " \
           "1.0000 | 12.500 |" in md


# ------------------------------------------------------ every driver's CLI

@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_without_card_and_without_c_exits_nonzero(name, tmp_path,
                                                         capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel path would run")
    mod = {"make_eval_artifact": make_eval_artifact,
           "gumbel_fit_artifact": gumbel_fit_artifact,
           "acceptance_eval": acceptance_eval}[name]
    assert mod.main(["--out", str(tmp_path / "out")]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "ERROR: no CUDA device found; run with -c" in cap.err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_never_writes_eval_artifacts(name, capsys):
    mod = {"make_eval_artifact": make_eval_artifact,
           "gumbel_fit_artifact": gumbel_fit_artifact,
           "acceptance_eval": acceptance_eval}[name]
    art = os.path.join(REPO, "eval_artifacts")
    before = sorted(os.listdir(art))
    for out in (art, os.path.join(art, "new"), REPO):
        assert mod.main(DRIVERS[name] + ["--out", out]) == 1
        assert "hold the JAX package's artifacts" in capsys.readouterr().err
    assert sorted(os.listdir(art)) == before
    for written in ("acceptance.md", "gumbel_fit.md", "runs.json"):
        assert not os.path.exists(os.path.join(REPO, written))


def test_acceptance_eval_refuses_the_kernel_with_c(tmp_path, capsys):
    assert acceptance_eval.main(["-c", "--backend", "cuda", "--out",
                                 str(tmp_path / "out")]) == 1
    assert "ERROR: the CUDA kernel needs a CUDA device" in (
        capsys.readouterr().err)
    assert not (tmp_path / "out").exists()


def test_gumbel_fit_artifact_takes_no_backend(capsys):
    with pytest.raises(SystemExit):
        gumbel_fit_artifact.main(["-c", "--backend", "torch"])
    assert "unrecognized arguments: --backend" in capsys.readouterr().err


def test_make_eval_artifact_c_runs_the_plain_row_only(tmp_path, capsys):
    with pytest.raises(SystemExit):
        make_eval_artifact.main(["-c", "--out", str(tmp_path)])
    assert "use it with --rows torch" in capsys.readouterr().err
