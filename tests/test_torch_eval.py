"""The port's evaluation modules (cuda_satabsearch_tpu_torch/eval/)
against the JAX package's, module by module, on the CPU.

The same inputs (the JAX package's committed multiquery output, the
fixtures, text embedded here) go through both.  Parsed lists and gold
dicts must be equal, text output byte-identical, Gumbel fits within
1e-12.  The one intended difference is the repair of the LSOLN pair-line
fault (``test_pair_line_fault_*``): the JAX ``iter_multiquery`` drops
any ``%3d %3d`` line, the port only those inside an LSOLN block.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from cuda_satabsearch_tpu import eval as jeval  # noqa: E402
from cuda_satabsearch_tpu.eval import __main__ as jmain  # noqa: E402
from cuda_satabsearch_tpu.eval import adapters as jadapters  # noqa: E402
from cuda_satabsearch_tpu.eval import cops as jcops  # noqa: E402
from cuda_satabsearch_tpu.eval import extrunner as jext  # noqa: E402
from cuda_satabsearch_tpu.eval import fischer as jfischer  # noqa: E402
from cuda_satabsearch_tpu.eval import gumbelfit as jgumbel  # noqa: E402
from cuda_satabsearch_tpu.eval import nh3d as jnh3d  # noqa: E402
from cuda_satabsearch_tpu.eval import plots as jplots  # noqa: E402
from cuda_satabsearch_tpu.eval import results as jresults  # noqa: E402
from cuda_satabsearch_tpu.eval import scop as jscop  # noqa: E402
from cuda_satabsearch_tpu.eval import tables as jtables  # noqa: E402
from cuda_satabsearch_tpu.eval import timestab as jtimestab  # noqa: E402
from cuda_satabsearch_tpu_torch import eval as teval  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import __main__ as tmain  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import adapters as tadapters  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import cops as tcops  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import extrunner as text_  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import fischer as tfischer  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import gumbelfit as tgumbel  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import nh3d as tnh3d  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import plots as tplots  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import results as tresults  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import scop as tscop  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import tables as ttables  # noqa: E402
from cuda_satabsearch_tpu_torch.eval import timestab as ttimestab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
ART = os.path.join(REPO, "eval_artifacts")
MQ_PALLAS = os.path.join(ART, "multiquery_tpu-pallas.out")
MQ_XLA = os.path.join(ART, "multiquery_tpu-xla-engine.out")
GOLD = os.path.join(ART, "gold_oracle_top5.txt")

# a multiquery stream on Fischer ids (test_eval.py's), and one on Nh3D
# compressed CATH ids (all-digit result ids)
FISCHER_STREAM = ("# QUERY ID = 1tie\n"
                  "8i1b 9.0\n1arb 3.0\n1mup 2.0\n"
                  "# QUERY ID = 1mdc\n"
                  "1mup 1.0\n8i1b 5.0\n1arb 4.0\n")
NH3D_STREAM = ("# QUERY ID = 1205\n"
               "120150 9.0\n34010 3.0\n25010 2.0\n1101290 4.5\n")
CLA = ("# dir.cla.scope.txt\n"
       "d1ubia_ 1ubi A: d.15.1.1 14982 cl=1,cf=2,sf=3,fa=4\n"
       "d1fxia_ 1fxi A: d.15.1.1 14983 cl=1,cf=2,sf=3,fa=4\n"
       "d2faza1 2faz A: d.15.2.1 14984 cl=1,cf=2,sf=5,fa=6\n"
       "d1arba_ 1arb A: b.47.1.2 20000 cl=7,cf=8,sf=9,fa=10\n"
       "d2sgaa_ 2sga A: b.47.1.1 20001 cl=7,cf=8,sf=9,fa=11\n"
       "d1aaaa_ 1aaa A: b.1.1.1 1001 cl=46456\n"
       "d1bbba_ 1bbb A: b.1.1.2 1002 cl=46456\n"
       "d1ccca_ 1ccc A: c.2.1.1 1003 cl=46456\n"
       "d1ddda_ 1ddd A: a.2.1.1 1004 cl=46456\n"
       "d1eeea_ 1eee A: g.3.1.1 1005 cl=46456\n")
DES = ("# dir.des\n"
       "46456 cl a - All alpha proteins\n"
       "46457 cf d.15 - beta-Grasp (ubiquitin-like)\n"
       "46458 sf d.15.1 - Ubiquitin-like\n"
       "46459 sf b.47.1 - Trypsin-like serine proteases\n"
       "short line\n")
TINY_DB = ("d1ubia_    2\ne  \nOT e  \n 0.000 \n 5.250  0.000 \n\n"
           "d1arba_    3\ne  \n")


def _tree(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for root, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


# ---------------------------------------------------------------- results

@pytest.mark.parametrize("path", [MQ_PALLAS, MQ_XLA])
@pytest.mark.parametrize("skip_self", [False, True])
def test_iter_multiquery_equal_on_committed_output(path, skip_self):
    with open(path) as a, open(path) as b:
        got = list(tresults.iter_multiquery(a, skip_self=skip_self))
        ref = list(jresults.iter_multiquery(b, skip_self=skip_self))
    assert got == ref
    assert [q for q, _ in got] == ["D1UBIA_", "D1AE6H1", "d1twfa_"]
    assert all(len(r) >= 585 for _q, r in got)


@pytest.mark.parametrize("negate,log10,sort", [
    (False, False, True), (True, False, True), (False, True, False)])
def test_parse_searchresult_equal(negate, log10, sort, capsys):
    text = ("# comment\nd1aaaa_ 5.0\nd2bbbb_ nan\nd3cccc_ 1.0\nbadline\n"
            "d4dddd_ ********\nd5eeee_ 2.5e-3\nd6ffff_ x1\n")
    kw = dict(negate=negate, log10=log10, sort=sort)
    assert (tresults.parse_searchresult(io.StringIO(text), **kw)
            == jresults.parse_searchresult(io.StringIO(text), **kw))
    err = capsys.readouterr().err
    assert err.count("skipping NaN") == 4  # two per package


def test_write_slrtab_identical():
    with open(MQ_PALLAS) as fh:
        (qid, results), *_ = list(tresults.iter_multiquery(fh))
    gold = jmain.load_gold_standard(GOLD)
    for lowercase in (True, False):
        a, b = io.StringIO(), io.StringIO()
        tresults.write_slrtab(a, results, gold[qid.lower()], lowercase)
        jresults.write_slrtab(b, results, gold[qid.lower()], lowercase)
        assert a.getvalue() == b.getvalue()
    assert "1\n" in a.getvalue() or lowercase is False


def test_pair_line_fault_jax_drops_port_keeps():
    """A '123 456' result row (all-digit id, 3-digit score) outside any
    LSOLN block: the JAX parser drops it, the port keeps it."""
    stream = ("# QUERY ID = q1\n"
              "d1abca_ 10\n"
              "123 456\n"
              "  7  12\n"
              "# QUERY ID = q2\n"
              " 12 345\n"
              "d2xyz__ 3\n")
    jax_out = list(jresults.iter_multiquery(io.StringIO(stream)))
    port = list(tresults.iter_multiquery(io.StringIO(stream)))
    assert jax_out == [("q1", [(10.0, "d1abca_")]),
                       ("q2", [(3.0, "d2xyz__")])]
    assert port == [("q1", [(10.0, "d1abca_"), (456.0, "123"),
                            (12.0, "7")]),
                    ("q2", [(345.0, "12"), (3.0, "d2xyz__")])]


def test_pair_line_fault_split_multiquery(tmp_path):
    """The adapters' splitter keeps such a row too (JAX drops it), and
    still drops pair lines inside an LSOLN block."""
    stream = ("# QUERY ID = q1\nd1abca_ 10 0.5 1.0 0.1\n  1   3\n 12  45\n"
              "# QUERY ID = q2\nd1abca_ 7\n123 456\n")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jadapters.split_multiquery(io.StringIO(stream), str(tmp_path / "j"))
    tadapters.split_multiquery(io.StringIO(stream), str(tmp_path / "t"))
    assert (tmp_path / "j" / "q1.out").read_text() == "d1abca_    10\n"
    assert (tmp_path / "t" / "q1.out").read_text() == "d1abca_    10\n"
    assert (tmp_path / "j" / "q2.out").read_text() == "d1abca_    7\n"
    assert (tmp_path / "t" / "q2.out").read_text() == (
        "d1abca_    7\n123    456\n")


@pytest.fixture(scope="module")
def lsoln_outputs():
    """The port's ``-c`` CLI stdout with LSOLN on (options 'T T T'):
    d1ubia_.input (1-entry DB, r = 128) and multiquery.input (586
    entries, r = 8)."""
    import torch

    from cuda_satabsearch_tpu_torch import cli

    outs = {}
    cwd, stdin, threads = os.getcwd(), sys.stdin, torch.get_num_threads()
    try:
        # two threads: the suite's other workers share the host's cores
        torch.set_num_threads(2)
        os.chdir(FIXTURES)
        for name, argv in (("d1ubia_.input", ["-c"]),
                           ("multiquery.input", ["-c", "-r", "8"])):
            with open(name) as fp:
                lines = fp.read().splitlines(keepends=True)
            sys.stdin = io.StringIO(lines[0] + "T T T\n" + "".join(lines[2:]))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                assert cli.main(argv) == 0
            outs[name] = buf.getvalue()
    finally:
        os.chdir(cwd)
        sys.stdin = stdin
        torch.set_num_threads(threads)
    return outs


@pytest.mark.parametrize("name", ["d1ubia_.input", "multiquery.input"])
def test_real_lsoln_output_parses_the_same(lsoln_outputs, name):
    text = lsoln_outputs[name]
    assert "LSOLN = T" in text
    assert sum(1 for ln in text.splitlines()
               if jresults._PAIR_LINE.match(ln)) > 3
    got = list(tresults.iter_multiquery(io.StringIO(text)))
    assert got == list(jresults.iter_multiquery(io.StringIO(text)))
    nrows = sum(1 for ln in text.splitlines()
                if not ln.startswith("#") and len(ln.split()) == 5)
    assert sum(len(r) for _q, r in got) == nrows


# -------------------------------------------------------------- gumbelfit

def _gumbel_samples(seed, n):
    rng = np.random.default_rng(seed)
    return 0.378 - 0.358 * np.log(-np.log(rng.random(n)))


@pytest.mark.parametrize("seed,n", [(0, 581), (1, 5000), (2, 40)])
def test_fit_gumbel_scipy_path_equal(seed, n):
    x = _gumbel_samples(seed, n)
    a, b = tgumbel.fit_gumbel(x)
    ja, jb = jgumbel.fit_gumbel(x)
    assert abs(a - ja) <= 1e-12 and abs(b - jb) <= 1e-12
    assert abs(a - 0.378) < 0.2 and abs(b - 0.358) < 0.2


@pytest.mark.parametrize("seed,n", [(0, 581), (1, 5000), (2, 40)])
def test_fit_gumbel_newton_path_equal(seed, n, monkeypatch):
    """Without scipy both fall back to the Newton iteration."""
    x = _gumbel_samples(seed, n)
    nt = tgumbel._fit_gumbel_newton(x)
    nj = jgumbel._fit_gumbel_newton(x)
    assert np.allclose(nt, nj, rtol=0, atol=1e-12)
    monkeypatch.setitem(sys.modules, "scipy", None)
    a, b = tgumbel.fit_gumbel(x)
    ja, jb = jgumbel.fit_gumbel(x)
    assert abs(a - ja) <= 1e-12 and abs(b - jb) <= 1e-12
    assert (a, b) == nt


def test_fit_from_slrtab_equal():
    x = _gumbel_samples(5, 300)
    text = "# header\n" + "".join(
        f"{s:.17g} {int(i % 7 == 0)}\n" for i, s in enumerate(x)) + "bad\n"
    for label in (0, 1, None):
        a = tgumbel.fit_from_slrtab(io.StringIO(text), label)
        b = jgumbel.fit_from_slrtab(io.StringIO(text), label)
        assert np.allclose(a, b, rtol=0, atol=1e-12)


def test_package_exports_match():
    names = ("fit_from_slrtab", "fit_gumbel", "iter_multiquery",
             "parse_searchresult", "write_slrtab", "auc", "compute_auc",
             "roc_curve", "roc_n")
    for name in names:
        assert hasattr(jeval, name)
        assert getattr(teval, name).__name__ == getattr(jeval, name).__name__
    assert teval.fit_gumbel is tgumbel.fit_gumbel


# ------------------------------------------------- gold standards: built in

@pytest.mark.parametrize("level", ["fold", "class"])
def test_fischer_gold_equal(level, tmp_path):
    assert tfischer.FISCHER_TABLE == jfischer.FISCHER_TABLE
    assert tfischer.FISCHER_FOLD_IDS == jfischer.FISCHER_FOLD_IDS
    assert tfischer.FISCHER_CLASS_IDS == jfischer.FISCHER_CLASS_IDS
    assert tfischer.fischer_gold(level) == jfischer.fischer_gold(level)
    tfischer.write_fischer_gold(str(tmp_path / "t"), level)
    jfischer.write_fischer_gold(str(tmp_path / "j"), level)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("level", ["arch", "class"])
def test_nh3d_gold_equal(level, tmp_path):
    assert tnh3d.all_cath_ids() == jnh3d.all_cath_ids()
    assert tnh3d.NH3D_QUERIES == jnh3d.NH3D_QUERIES
    assert tnh3d.cathmap() == jnh3d.cathmap()
    for cid in tnh3d.all_cath_ids()[::37]:
        assert tnh3d.compress(cid) == jnh3d.compress(cid)
        assert tnh3d.architecture(cid) == jnh3d.architecture(cid)
        assert tnh3d.cath_class(cid) == jnh3d.cath_class(cid)
    assert tnh3d.nh3d_gold(level) == jnh3d.nh3d_gold(level)
    tnh3d.write_nh3d_gold(str(tmp_path / "t"), level)
    jnh3d.write_nh3d_gold(str(tmp_path / "j"), level)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_cops_gold_equal(tmp_path):
    tp = tmp_path / "cops.tp"
    tp.write_text("# header\n"
                  "c1abcA_ T1 T2 T3 T4 T5 T6\n"
                  "badline only three\n"
                  "c2defB_ U1 U2 U3 U4 U5 U6 U7\n")
    assert tcops.parse_cops_tp(str(tp)) == jcops.parse_cops_tp(str(tp))
    for mod in (tcops, jcops):
        with pytest.raises(ValueError):
            mod.parse_cops_tp(str(tp), strict=True)


# ------------------------------------------------------------------- scop

def test_scop_functions_equal(tmp_path):
    tdoms = tscop.parse_cla(io.StringIO(CLA))
    jdoms = jscop.parse_cla(io.StringIO(CLA))
    assert [d.__dict__ for d in tdoms] == [d.__dict__ for d in jdoms]
    for level in tscop.LEVEL_PARTS:
        assert (tscop.group_by_level(tdoms, level)
                == jscop.group_by_level(jdoms, level))
        assert (tscop.scop_gold(tdoms, level=level)
                == jscop.scop_gold(jdoms, level=level))
        assert (tscop.scop_gold(tdoms, queries=["d1ubia_", "D1ARBA_"],
                                level=level, restrict_to=["d1fxia_"])
                == jscop.scop_gold(jdoms, queries=["d1ubia_", "D1ARBA_"],
                                   level=level, restrict_to=["d1fxia_"]))
    sids = ["d1arba_", "nope", "D1UBIA_"]
    assert tscop.domain_info(tdoms, sids) == jscop.domain_info(jdoms, sids)
    tdes = tscop.parse_des(io.StringIO(DES))
    assert tdes == jscop.parse_des(io.StringIO(DES))
    assert (tscop.dominfo_dict(tdoms, tdes)
            == jscop.dominfo_dict(jdoms, tdes))
    for n, seed in ((5, 1), (3, 7), (20, 2)):
        assert (tscop.sample_query_list(tdoms, n, seed)
                == jscop.sample_query_list(jdoms, n, seed))
    assert (tscop.sample_query_list(tdoms, 4, 3, available=["d1ubia_"])
            == jscop.sample_query_list(jdoms, 4, 3, available=["d1ubia_"]))
    db = tmp_path / "db.ascii"
    db.write_text(TINY_DB + "1e50    2\nx.y    3\n")
    assert tscop.db_headers(str(db)) == jscop.db_headers(str(db))
    assert tscop._db_names(str(db)) == jscop._db_names(str(db))


@pytest.mark.parametrize("argv", [
    ["--make-gold", "fold"], ["--make-gold", "superfamily"],
    ["--make-gold", "family", "--restrict-db", "{db}"],
    ["--make-gold", "class", "--queries", "{queries}"],
    ["--dominfo", "d1ubia_", "d9zzza_"],
    ["--sample-queries", "5", "--seed", "2"],
    ["--sample-queries", "3", "--restrict-db", "{db}"],
])
def test_scop_cli_identical(argv, tmp_path, capsys):
    cla = tmp_path / "dir.cla"
    cla.write_text(CLA)
    (tmp_path / "db.ascii").write_text(TINY_DB)
    (tmp_path / "queries").write_text("d1ubia_\nd1ccca_\n\n")
    argv = ["--cla", str(cla)] + [a.format(db=tmp_path / "db.ascii",
                                           queries=tmp_path / "queries")
                                  for a in argv]
    outs = []
    for main in (tscop.main, jscop.main):
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
        assert main(argv + ["-o", str(tmp_path / "o")]) == 0
        outs.append((tmp_path / "o").read_text())
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert outs[0]


# --------------------------------------------------------------- eval CLI

@pytest.mark.parametrize("argv", [
    [MQ_PALLAS, "--gold", GOLD],
    [MQ_PALLAS, "--gold", GOLD, "--roc50"],
    [MQ_PALLAS, "--gold", GOLD, "--roc50", "--latex"],
    [MQ_XLA, "--gold", GOLD, "--latex"],
    [MQ_XLA, "--gold", GOLD, "--negate", "--roc50"],
    [MQ_PALLAS, "--gold", GOLD, "--keep-self"],
    ["{fischer}", "--fischer", "fold", "--roc50"],
    ["{fischer}", "--fischer", "class", "--latex"],
    ["{nh3d}", "--nh3d", "arch"],
    ["{nh3d}", "--nh3d", "class", "--roc50"],
    ["{fischer}", "--cops-tp", "{cops}"],
])
def test_eval_cli_identical(argv, tmp_path, capsys):
    (tmp_path / "fischer.out").write_text(FISCHER_STREAM)
    (tmp_path / "nh3d.out").write_text(NH3D_STREAM)
    (tmp_path / "cops.tp").write_text("1tie 8i1b 1arb x y z w\n"
                                      "1mdc 1arb q r s t u\n")
    argv = [a.format(fischer=tmp_path / "fischer.out",
                     nh3d=tmp_path / "nh3d.out", cops=tmp_path / "cops.tp")
            for a in argv]
    outs = []
    for main in (tmain.main, jmain.main):
        assert main(argv) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    assert outs[0].err == outs[1].err
    # every hit of a Fischer class query is a positive: all skipped
    assert (outs[0].out.count("\n") >= 2
            or outs[0].err.count("degenerate labels") == 2)


def test_eval_cli_slrtab_dir_identical(tmp_path, capsys):
    for main, d in ((tmain.main, "t"), (jmain.main, "j")):
        assert main([MQ_PALLAS, "--gold", GOLD, "--roc50",
                     "--slrtab-dir", str(tmp_path / d)]) == 0
    assert capsys.readouterr().out.count("mean AUC") == 2
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t == j
    assert sorted(t) == ["D1AE6H1.slrtab", "D1UBIA_.slrtab"]


def test_eval_cli_from_stdin_identical(monkeypatch, capsys):
    outs = []
    for main in (tmain.main, jmain.main):
        with open(MQ_PALLAS) as fh:
            monkeypatch.setattr("sys.stdin", fh)
            assert main(["-", "--gold", GOLD]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_eval_cli_needs_one_gold_source(capsys):
    for main in (tmain.main, jmain.main):
        with pytest.raises(SystemExit):
            main([MQ_PALLAS])
        with pytest.raises(SystemExit):
            main([MQ_PALLAS, "--gold", GOLD, "--fischer", "fold"])
    assert "exactly one of" in capsys.readouterr().err


def test_gold_loaders_equal():
    assert tmain.load_gold_standard(GOLD) == jmain.load_gold_standard(GOLD)


def test_plot_dir_without_matplotlib_fails_first(tmp_path, monkeypatch,
                                                 capsys):
    """Where matplotlib is missing (as on the card's host) --plot-dir
    fails at once, with a clear message and no output."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as e:
        tmain.main([MQ_PALLAS, "--gold", GOLD,
                    "--plot-dir", str(tmp_path / "plots")])
    assert e.value.code == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "--plot-dir: plots need matplotlib" in cap.err
    assert not (tmp_path / "plots").exists()
    # without --plot-dir nothing needs it
    assert tmain.main([MQ_PALLAS, "--gold", GOLD]) == 0


def test_plots_equal(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(4)
    methods = {f"m{i}": (rng.random(60), rng.random(60) < 0.3)
               for i in range(2)}
    for log_x in (False, True):
        a = tplots.plot_roc(methods, str(tmp_path / "t.png"), "t", log_x)
        b = jplots.plot_roc(methods, str(tmp_path / "j.png"), "t", log_x)
        assert a == b
        assert (tmp_path / "t.png").read_bytes() == (
            tmp_path / "j.png").read_bytes()
    cov = {k: (s, l, 3) for k, (s, l) in methods.items()}
    tplots.plot_coverage_epq(cov, str(tmp_path / "tc.png"), "c")
    jplots.plot_coverage_epq(cov, str(tmp_path / "jc.png"), "c")
    assert (tmp_path / "tc.png").read_bytes() == (
        tmp_path / "jc.png").read_bytes()
    for main, d in ((tmain.main, "t"), (jmain.main, "j")):
        assert main([MQ_PALLAS, "--gold", GOLD,
                     "--plot-dir", str(tmp_path / d)]) == 0
    assert capsys.readouterr().out.count("mean AUC") == 2
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert len(_tree(tmp_path / "t")) == 3


# --------------------------------------------------------------- timestab

@pytest.mark.parametrize("source", [["--gold", GOLD],
                                    ["--gold", GOLD, "--negate"]])
def test_timestab_identical(source, tmp_path, capsys):
    man = tmp_path / "manifest.tsv"
    man.write_text("# label\tresults\tseconds\n"
                   f"slow row\t{MQ_XLA}\t3723.4\n"
                   "bad line\n"
                   f"fast row\t{MQ_PALLAS}\t19.35\n")
    outs = []
    for main in (ttimestab.main, jtimestab.main):
        assert main([str(man)] + source) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    assert outs[0].err == outs[1].err
    assert r"\begin{tabular}{lrrr}" in outs[0].out


def test_timestab_builtin_gold_identical(tmp_path, capsys):
    (tmp_path / "f.out").write_text(FISCHER_STREAM)
    (tmp_path / "n.out").write_text(NH3D_STREAM)
    for src, res in ((["--fischer", "fold"], "f.out"),
                     (["--nh3d", "arch"], "n.out")):
        man = tmp_path / "m.tsv"
        man.write_text(f"a\t{tmp_path / res}\t10\nb\t{tmp_path / res}\t2\n")
        outs = []
        for main in (ttimestab.main, jtimestab.main):
            assert main([str(man)] + src) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    for v in (0.4, 59.5, 3600, 7384.6):
        assert ttimestab.hms(v) == jtimestab.hms(v)
    with pytest.raises(ValueError):
        ttimestab.mean_auc(str(tmp_path / "f.out"), {})


# ----------------------------------------------------------------- tables

STAR_RESULTS = ('\t"A"\t"B"\t"C"\n'
                '"A"\t0\t0.05\t0.01\n'
                '"B"\t0.001\t0\t0.02\n'
                '"C"\t0.9\t0.4\t0\n')
STAR_CI = ("pair\tdelta\tci\n"
           '"A"/"B"\t-0.05\t( -0.06 , -0.04 )\n'
           '"A"/"C"\t0.01\t( -0.005 , 0.025 )\n')


def test_tables_functions_equal(tmp_path):
    (tmp_path / "a.slrtab").write_text("5.0 1\n3.0 0\n2.0 1\n1.0 0\n")
    (tmp_path / "b.slrtab").write_text("9.0 1\n8.0 0\n")
    listing = [("Method A", str(tmp_path / "a.slrtab")),
               ("Method B", str(tmp_path / "b.slrtab"))]
    for mod, d in ((ttables, "t"), (jtables, "j")):
        mod.slrtabs_to_star(listing, str(tmp_path / f"{d}.pos"),
                            str(tmp_path / f"{d}.neg"))
    for ext in ("pos", "neg"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (
            tmp_path / f"j.{ext}").read_bytes()
    for p in (0.05, 0.5):
        rows = ttables.star_auc_table(io.StringIO(STAR_RESULTS),
                                      io.StringIO(STAR_CI), "A", p)
        assert rows == jtables.star_auc_table(io.StringIO(STAR_RESULTS),
                                              io.StringIO(STAR_CI), "A", p)
        for inc in (True, False):
            assert (ttables.star_auc_latex(rows, inc)
                    == jtables.star_auc_latex(rows, inc))
    texts = ["blah 123user 4.5system 2:05.50elapsed 99%CPU\n",
             "first 0:30.00elapsed\nthen 1:02:03elapsed more\n", "none\n"]
    for fmt in ("hms", "ms", "hm"):
        assert ttables.sum_elapsed(texts, fmt) == jtables.sum_elapsed(
            texts, fmt)
    res = "# c\nd1a__ 5 x\nd1b__ 9 x\nd1c__ 1 x\n"
    assert ttables.result_rank(io.StringIO(res), "d1b__") == (
        jtables.result_rank(io.StringIO(res), "d1b__"))
    slr = "1.5 1\n2 0\n\n3e-2 1\n"
    assert (list(ttables.iter_slrtab(io.StringIO(slr)))
            == list(jtables.iter_slrtab(io.StringIO(slr))))


def _tables_fixture(tmp_path):
    d1, d2 = tmp_path / "m1", tmp_path / "m2"
    d1.mkdir()
    d2.mkdir()
    (d1 / "d1q__.out").write_text("# hdr\nd1a__ 5\nd1b__ 3\nd1c__ 1\n")
    (d2 / "d1q__.out").write_text("d1b__ 30\nd1a__ 50\nbad ERROR\n")
    (tmp_path / "a.slrtab").write_text("5.0 1\n3.0 0\n2.0 1\n1.0 0\n")
    (tmp_path / "b.slrtab").write_text("9.0 1\n8.0 0\n")
    (tmp_path / "results.txt").write_text(STAR_RESULTS)
    (tmp_path / "ci.txt").write_text(STAR_CI)
    (tmp_path / "r.out").write_text("# c\nd1a__ 5 x\nd1b__ 9 x\nd1c__ 1\n")
    (tmp_path / "t1.err").write_text("x 2:05.50elapsed\n")
    (tmp_path / "t2.err").write_text("y 1:02:03elapsed\n")
    db = tmp_path / "db.ascii"
    db.write_text("d1aaaa_ 5\n0.0\nd2bbbb_ 7\n0.0\n")
    (tmp_path / "d1qqqq_.input").write_text("db.ascii\nT T F\nd1qqqq_ 9\n")
    stdin = {"star": (f"Method A\t{tmp_path / 'a.slrtab'}\n"
                      f"Method B\t{tmp_path / 'b.slrtab'}\n"),
             "timertab": ("# QUERY ID = D1QQQQ_\n"
                          f"# DBFILE = {db}\n"
                          "d1aaaa_ 42 1.25\n\nd2bbbb_ 17 0.75\n")}
    return stdin


@pytest.mark.parametrize("argv", [
    ["star", "{tmp}/pos", "{tmp}/neg", "-v"],
    ["auctable", "{tmp}/results.txt", "{tmp}/ci.txt", "A"],
    ["auctable", "{tmp}/results.txt", "{tmp}/ci.txt", "A", "-p", "0.5",
     "--latex"],
    ["auctable", "{tmp}/results.txt", "{tmp}/ci.txt", "A", "--latex", "-n"],
    ["merge", "{tmp}/m1", "{tmp}/m2"],
    ["rank", "d1b__", "{tmp}/r.out"],
    ["timertab", "--input-dir", "{tmp}"],
    ["timertab", "--input-dir", "{tmp}", "--dbfile", "{tmp}/none"],
    ["sumtimes", "{tmp}/t1.err", "{tmp}/t2.err"],
    ["sumtimes", "{tmp}/t1.err", "-m"],
    ["sumtimes", "{tmp}/t2.err", "-H"],
])
def test_tables_cli_identical(argv, tmp_path, monkeypatch, capsys):
    stdin = _tables_fixture(tmp_path)
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    outs = []
    for main in (ttables.main, jtables.main):
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin.get(argv[0], "")))
        assert main(argv) == 0
        cap = capsys.readouterr()
        files = ({f: (tmp_path / f).read_bytes() for f in ("pos", "neg")}
                 if argv[0] == "star" else {})
        outs.append((cap.out, cap.err, files))
    assert outs[0] == outs[1]
    assert outs[0][0] or outs[0][2]


# --------------------------------------------------------------- adapters

ADAPTER_INPUTS = {
    "dalilite": (
        " DCCP   1   940.2  2.9  211   21.5   211  0001  1timA 1atnA\n"
        " DCCP   1   900.0  2.9  211   30.0   211  0002  1timA 1atnA\n"
        " DCCP   1   100.0  2.9   50    9.5    50  0003  1timA 1atnA\n"
        " DCCP   1   100.0  2.9   50    5.0    50  0003  1timA 1cewA\n"),
    "vast": ("d1abca_ Nclique= 3\nNres a b c d e Pcli x\n"
             "100 1 2 3 4 5 0.9 y\nd1abca_ Nclique= 1\n"
             "Nres a b c d e Pcli x\n100 1 2 3 4 5 0.4 y\n"),
    "ssm": ("<SSMResults><Match><Q-score>0.61</Q-score>"
            "<Target><name>d1ubia_</name></Target></Match>"
            "<Match><Q-score>0.32</Q-score>"
            "<Target><name>d2fazA1</name></Target></Match></SSMResults>"),
    "tableausearch": (
        "/db/d1u3ya_.ent.angles   Score-of-comparison:    -149.2\n"
        "/db/d1geea_.ent.angles   Score-of-comparison:    -593.7\n"),
    "sheba": ("junk\n pdb1   na       pdb2   nb   id    m   %ma    %mb \n"
              " 1timA  247  d1abca_  100  10  55  20  30\n"
              " 1timA  247  d2defb_  200  11  66  21  31\n"
              " 1timA  247  footer   0  0  0  0  0\n\nafter\n"),
    "yakusa": ("Query: d1ubia_\nDescription query : a b c d1ubia_\n"
               "Protein rank: 1 score: 118.48 Z-score: 24.29 name: "
               "d1u6ra1 : x\n"
               "Protein rank: 2 score: 90.0 Z-score: inf name: d2abca_ : x\n"),
    "topscompare": "12.5 d1abca_extra\n3.5 probe\n4.0 d2defb_\n",
    "lock2": ("** Query = /x/d1ubia_.pdb\n** Target = /x/d1abca_.pdb\n"
              "final score: 41.5\n** Target = /x/d2defb_.pdb\n"
              "final score: 12.0\n"),
}


@pytest.mark.parametrize("fmt", sorted(ADAPTER_INPUTS))
@pytest.mark.parametrize("flag", [[], ["-q"], ["--no-fischer-ids"]])
def test_adapters_identical(fmt, flag, monkeypatch, capsys):
    text = ADAPTER_INPUTS[fmt]
    assert sorted(tadapters.ADAPTERS) == sorted(jadapters.ADAPTERS)
    outs = []
    for mod in (tadapters, jadapters):
        buf = io.StringIO()
        mod.write_2col(mod.ADAPTERS[fmt](io.StringIO(text)), buf)
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        assert mod.main([fmt] + flag) == 0
        outs.append((buf.getvalue(), capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0].strip()


def test_adapter_helpers_equal():
    for did in ("1atnA", "1cewA", "1tim", "8i1bA"):
        assert (tadapters.dali_to_fischer_id(did)
                == jadapters.dali_to_fischer_id(did))
    scores = [("b", "9.5"), ("a", "1"), ("b", "30.0"), ("a", "2")]
    assert tadapters._dedup_max(scores) == jadapters._dedup_max(scores)


def test_split_identical_without_the_fault(tmp_path, monkeypatch, capsys):
    """The splitter on the committed output and on a two-pass stream:
    the same files in both packages (the CLI's split mode too)."""
    stream = ("# QUERY ID = d1ubia_\nd1abca_ 10\n"
              "# QUERY ID = d2phlb1\nd1abca_ 5\nbad\nd2x__ 25.10\n"
              "# QUERY ID = d1ubia_\nd9bigx_ 20\nd8x__ nan1\n")
    for name, text in (("two-pass", stream),
                       ("committed", open(MQ_PALLAS).read())):
        for mod in (tadapters, jadapters):
            d = tmp_path / name / mod.__name__.split(".")[0]
            d.mkdir(parents=True)
            mod.split_multiquery(io.StringIO(text), str(d))
            monkeypatch.setattr("sys.stdin", io.StringIO(text))
            assert mod.main(["split", str(d / "cli")]) == 0
        capsys.readouterr()
        t = _tree(tmp_path / name / "cuda_satabsearch_tpu_torch")
        j = _tree(tmp_path / name / "cuda_satabsearch_tpu")
        assert t == j and len(t) >= 4


# -------------------------------------------------------------- extrunner

def _query_dir(tmp_path):
    qdir = tmp_path / "queries"
    qdir.mkdir()
    (qdir / "d1abca_.tableaudistmatrix").write_text("A\n")
    (qdir / "d2defb_.tableaudistmatrix").write_text("B\n")
    (qdir / "ignored.txt").write_text("x\n")
    return qdir


@pytest.mark.parametrize("command,kw", [
    ("echo {name} 12.5; echo hit2 3.5", dict(db_file="dbf")),
    ("cat; echo {db} 1.0 >&2", dict(stdin=True, db_file="dbf")),
    ("echo x{name} 2; exit 3", dict(out_suffix=".res")),
    ("sleep 5", dict(timeout=0.2)),
])
def test_extrunner_per_file_identical(command, kw, tmp_path):
    qdir = _query_dir(tmp_path)
    res = {}
    for mod, d in ((text_, "t"), (jext, "j")):
        rs = mod.run_per_file(command, str(qdir), str(tmp_path / d), **kw)
        res[d] = [(r.name, os.path.basename(r.out_path), r.returncode)
                  for r in rs]
    assert res["t"] == res["j"]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert len(res["t"]) == 2


def test_extrunner_pairs_and_collect_identical(tmp_path):
    qdir = _query_dir(tmp_path)
    trees = []
    for mod, d in ((text_, "t"), (jext, "j")):
        pairs = mod.run_all_pairs("echo /db/{name}.ent.angles "
                                  "Score-of-comparison: -1.5",
                                  str(qdir), str(tmp_path / d / "pairs"))
        assert [r.returncode for r in pairs] == [0] * 4
        mod.collect_2col(pairs, "tableausearch", str(tmp_path / d / "cols"))
        trees.append(_tree(tmp_path / d))
    assert trees[0] == trees[1]
    assert len(trees[0]) == 4 * 2 + 4


@pytest.mark.parametrize("argv,rc", [
    (["--program", "echo hit 1.0"], 0),
    (["--program", "false"], 1),
    (["--program", "echo {name} 4.0", "--pairs"], 0),
    (["--program", "cat", "--stdin", "--adapter", "topscompare",
      "--adapter-outdir", "{tmp}/cols"], 0),
])
def test_extrunner_cli_identical(argv, rc, tmp_path, capsys):
    qdir = tmp_path / "q"
    qdir.mkdir()
    (qdir / "x.td").write_text("7.5 d1abca_\n")
    (qdir / "y.td").write_text("2.5 d2defb_\n")
    outs = []
    for main, d in ((text_.main, "t"), (jext.main, "j")):
        args = [a.replace("{tmp}", str(tmp_path / d)) for a in argv]
        assert main(args + ["--query-dir", str(qdir), "--results-dir",
                            str(tmp_path / d / "out"), "--suffix",
                            ".td"]) == rc
        outs.append((capsys.readouterr().err, _tree(tmp_path / d)))
    assert outs[0] == outs[1]
