"""The port's CLI against the JAX package's, end to end on the CPU.

``python -m cuda_satabsearch_tpu_torch -c`` (plain engine on the CPU)
must print stdout byte-identical to ``python -m cuda_satabsearch_tpu -c``
apart from the program name in the ``# ... LTYPE`` header.  Both run as
separate processes, concurrently (the JAX side compiles per bucket and
dominates the time); the port's process never imports jax.
"""

import io
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
HEADER = re.compile(r"^# \S+ LTYPE = ", re.M)

CASES = {
    "d1ubia_": (["-c"], "d1ubia_.input"),  # LSOLN on, 1-entry DB
    "multiquery_r8": (["-c", "-r", "8"], "multiquery.input"),  # 586 entries
    "querylist": (["-c", "-q", "tableauxdistmatrixdb.test2.ascii", "-r",
                   "64"], "d1kcul1\nnosuchid\n"),
}


def _start(pkg, argv, stdin_text, outdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    files = [open(outdir / f"{pkg}.{s}", "w+") for s in ("out", "err")]
    p = subprocess.Popen([sys.executable, "-m", pkg, *argv], cwd=FIXTURES,
                         env=env, stdin=subprocess.PIPE, stdout=files[0],
                         stderr=files[1], text=True)
    p.stdin.write(stdin_text)
    p.stdin.close()
    return p, files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: {package: (rc, stdout, stderr)}}, all processes at once."""
    procs = {}
    for case, (argv, stdin) in CASES.items():
        if stdin.endswith(".input"):
            with open(os.path.join(FIXTURES, stdin)) as fp:
                stdin = fp.read()
        outdir = tmp_path_factory.mktemp(case)
        for pkg in ("cuda_satabsearch_tpu", "cuda_satabsearch_tpu_torch"):
            procs[case, pkg] = _start(pkg, argv, stdin, outdir)
    out = {}
    try:
        for (case, pkg), (p, files) in procs.items():
            rc = p.wait(timeout=600)
            texts = []
            for f in files:
                f.seek(0)
                texts.append(f.read())
            out.setdefault(case, {})[pkg] = (rc, *texts)
    finally:
        for p, files in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in files:
                f.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_stdout_identical_to_jax_package(runs, case):
    (jrc, jout, jerr) = runs[case]["cuda_satabsearch_tpu"]
    (trc, tout, terr) = runs[case]["cuda_satabsearch_tpu_torch"]
    assert jrc == 0, jerr
    assert trc == 0, terr
    assert jout.count("\n") > 3
    assert HEADER.sub("# P LTYPE = ", tout) == HEADER.sub("# P LTYPE = ",
                                                          jout)
    assert tout.startswith("# torchsatabsearch LTYPE = ")
    assert ("not found in db" in terr) == ("not found in db" in jerr)


def _run_inprocess(argv, stdin_text, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin_text))
    monkeypatch.chdir(FIXTURES)
    rc = cli.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def test_without_card_and_without_c_exits_nonzero(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel path would run")
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        text = fp.read()
    rc, out, err = _run_inprocess([], text, monkeypatch, capsys)
    assert rc == 1
    assert out == ""
    assert "ERROR: no CUDA device found; run with -c" in err


def test_mesh_is_not_ported(monkeypatch, capsys):
    """``--mesh`` is ported: with ``-c`` it shards over the CPU device and
    prints what ``-c`` alone prints (d1ubia_, LSOLN on)."""
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        text = fp.read()
    rc, out, err = _run_inprocess(["-c", "--mesh"], text, monkeypatch,
                                  capsys)
    assert rc == 0, err
    assert "not ported yet" not in err
    assert (rc, out) == _run_inprocess(["-c"], text, monkeypatch, capsys)[:2]
    assert out.startswith("# torchsatabsearch LTYPE = ")


def test_kernel_backend_with_c_is_refused(monkeypatch, capsys):
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        text = fp.read()
    rc, out, err = _run_inprocess(["-c", "--backend", "cuda"], text,
                                  monkeypatch, capsys)
    assert rc == 1 and out == ""
    assert "needs a CUDA device" in err


def test_empty_db_prints_headers_only(tmp_path, monkeypatch, capsys):
    """An empty DB file: both packages print the query headers and no
    result lines, and exit 0."""
    from cuda_satabsearch_tpu import cli as jcli

    db = tmp_path / "empty.ascii"
    db.write_text("")
    with open(os.path.join(FIXTURES, "d1ubia_.input")) as fp:
        text = f"{db}\n" + "".join(fp.readlines()[1:])
    outs = []
    for main in (jcli.main, cli.main):
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        assert main(["-c"]) == 0
        outs.append(HEADER.sub("# P LTYPE = ", capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[1].count("\n") == 3
