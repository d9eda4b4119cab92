"""The port's native DB loader (cuda_satabsearch_tpu_torch/io/native.py)
against the port's Python parse + pack and the JAX package's: bitwise
on every fixture DB with mesh padding, the same errors as the Python
parser, the C++ score statistics and writer against their Python
versions, and the build: into the port's _build/ directory, never into
native/, raising with the compiler's output when it fails."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from cuda_satabsearch_tpu.io import pack as jpack  # noqa: E402
from cuda_satabsearch_tpu.io import parser as jparser  # noqa: E402
from cuda_satabsearch_tpu.io import writer as jwriter  # noqa: E402
from cuda_satabsearch_tpu_torch import session as tsession  # noqa: E402
from cuda_satabsearch_tpu_torch.core.constants import (  # noqa: E402
    GUMBEL_A, GUMBEL_B)
from cuda_satabsearch_tpu_torch.io import native  # noqa: E402
from cuda_satabsearch_tpu_torch.io import writer as twriter  # noqa: E402
from cuda_satabsearch_tpu_torch.io.pack import pack_database  # noqa: E402
from cuda_satabsearch_tpu_torch.io.parser import read_database  # noqa: E402
from cuda_satabsearch_tpu_torch.stats.gumbel import score_stats  # noqa: E402

from conftest import random_entry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
NATIVE_DIR = os.path.join(REPO, "native")

pytestmark = pytest.mark.skipif(native.find_cxx() is None,
                                 reason="no C++ compiler (g++) here")


def _assert_packed_equal(a, b):
    assert a.nentries == b.nentries and a.names == b.names
    np.testing.assert_array_equal(a.orders, b.orders)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.dim == y.dim and x.names == y.names
        for f in ("tabhi", "tablo", "types", "dmat", "orders", "index"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u.view(np.uint8), v.view(np.uint8))


def _python_pack(path, **kw):
    pad_to = kw.pop("pad_to", 1)
    return pack_database(read_database(path, **kw), pad_to=pad_to)


@pytest.mark.parametrize("pad_to", [1, 3, 8])
@pytest.mark.parametrize("dbname", ["tableauxdistmatrixdb.test.ascii",
                                    "tableauxdistmatrixdb.test2.ascii",
                                    "tableauxdistmatrixdb.small.ascii"])
def test_native_pack_equals_python_packs(dbname, pad_to):
    path = os.path.join(FIXTURES, dbname)
    got = native.pack_database_file(path, pad_to=pad_to)
    _assert_packed_equal(got, _python_pack(path, pad_to=pad_to))
    _assert_packed_equal(got, jpack.pack_database(
        jparser.read_database(path), pad_to=pad_to))


def _big_entry_lines(n=20):
    lines = [f"dbig__ {n}"]
    lines += [" ".join(["e " if i == j else "OS" for j in range(i + 1)])
              for i in range(n)]
    lines += [" ".join(["%6.3f" % (0.0 if i == j else 5.0)
                        for j in range(i + 1)]) for i in range(n)]
    return "\n".join(lines) + "\n"


# the inputs of tests/test_native.py:109-158
BAD_INPUTS = {
    "garbage_distance": ("d1x__ 2\ne \nOS e \n0.000\ngarbage 0.000\n", {}),
    "partial_order": ("d1x__ 2x\ne \nOS e \n0.000\n1.0 0.000\n", {}),
    "beyond_last_cap": (_big_entry_lines(), dict(buckets=(8, 16),
                                                 maxdim=111)),
}


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_native_errors_are_the_python_parsers(case, tmp_path):
    text, kw = BAD_INPUTS[case]
    kw = dict(kw)
    path = tmp_path / f"{case}.ascii"
    path.write_text(text)
    buckets = kw.pop("buckets", None)
    pkw = dict(buckets=buckets) if buckets else {}
    got = _raised(lambda: native.pack_database_file(str(path), **pkw, **kw))
    ref = _raised(lambda: pack_database(read_database(str(path), **kw),
                                        **pkw))
    assert got == ref
    assert got[0] is ValueError


@pytest.mark.parametrize("what", ["missing", "directory"])
def test_native_unreadable_path_raises_as_python(what, tmp_path):
    path = str(tmp_path / "no_such.ascii") if what == "missing" else str(
        tmp_path)
    got = _raised(lambda: native.pack_database_file(path))
    assert got == _raised(lambda: read_database(path))
    assert issubclass(got[0], OSError)
    if what == "missing":
        assert got[0] is FileNotFoundError


def test_native_edge_inputs_parse_as_python(tmp_path):
    """No trailing newline, and names up to (and beyond) the native
    127-character label: the same packed DB as the Python path."""
    files = {"no_newline": "d1y__ 2\ne \nOS e \n0.000\n1.500 0.000",
             "long_name": f"d{'x' * 60} 2\ne \nOS e \n0.000\n1.500 0.000\n",
             "longer_than_label": f"d{'y' * 140} 2\ne \nOS e \n0.000\n"
                                  "1.500 0.000\n"}
    for name, text in files.items():
        path = tmp_path / f"{name}.ascii"
        path.write_text(text)
        _assert_packed_equal(native.pack_database_file(str(path)),
                             _python_pack(str(path)))


def test_native_score_stats_match_python():
    """norm2 and z bitwise; p within 1e-15 absolute (1e-9 relative):
    the C++ twin evaluates 1 - exp(-exp(-x)) with its own rounding of
    the constants, which near p = 0 leaves a last-bit difference."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 60, 500).astype(np.int32)
    orders = rng.integers(2, 100, 500).astype(np.int32)
    for compat in (False, True):
        n2p, zp, pp = score_stats(scores, 8, orders, compat=compat)
        n2n, zn, pn = native.score_stats_native(scores, orders, 8, GUMBEL_A,
                                                GUMBEL_B, compat=compat)
        np.testing.assert_array_equal(n2n, n2p)
        np.testing.assert_array_equal(zn, zp)
        np.testing.assert_allclose(pn, pp, rtol=1e-9, atol=1e-15)


def test_native_writer_matches_both_python_writers():
    entries = read_database(os.path.join(
        FIXTURES, "tableauxdistmatrixdb.small.ascii"))[:40]
    entries += read_database(os.path.join(FIXTURES, "d1qlpa_.ascii"))
    rng = np.random.default_rng(5)
    entries += [random_entry(rng, int(n), f"syn{n}")
                for n in rng.integers(2, 60, size=8)]
    entries.append(random_entry(rng, 5, "x" * 90))
    for e in entries:
        text = native.format_entry_native(e)
        assert text == twriter.format_entry(e) == jwriter.format_entry(e), \
            e.name


def test_writer_round_trip_through_native_pack(tmp_path):
    """Random entries (orders 2-111) written by the port's writer pack
    the same natively as in Python, with mesh padding."""
    rng = np.random.default_rng(99)
    entries = [random_entry(rng, int(o), f"d{i:04d}")
               for i, o in enumerate(rng.integers(2, 112, size=25))]
    path = tmp_path / "fuzz.ascii"
    path.write_text(twriter.format_database(entries))
    assert twriter.format_database(entries) == jwriter.format_database(
        entries)
    for pad_to in (1, 8):
        _assert_packed_equal(native.pack_database_file(str(path),
                                                       pad_to=pad_to),
                             _python_pack(str(path), pad_to=pad_to))


def _tree_state(root):
    return sorted((name, os.stat(os.path.join(root, name)).st_mtime_ns,
                   os.stat(os.path.join(root, name)).st_size)
                  for name in os.listdir(root))


def test_build_goes_to_build_dir_never_native(tmp_path):
    before = _tree_state(NATIVE_DIR)
    so = native.build(build_dir=tmp_path)
    assert so.parent == tmp_path and so.name.startswith("satab_io_")
    assert native.build(build_dir=tmp_path) == so  # built once per hash
    lib = native.load_library()
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert _tree_state(NATIVE_DIR) == before


def test_failed_build_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="failed") as info:
        native.build(source=bad, build_dir=tmp_path / "b")
    assert "bad.cpp" in str(info.value) and "error" in str(info.value)
    assert not (tmp_path / "b").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "b").iterdir())


@pytest.mark.parametrize("why", ["no_compiler", "SATAB_NATIVE=0"])
def test_session_parses_in_python_without_the_loader(why, monkeypatch,
                                                     capsys):
    db = os.path.join(FIXTURES, "tableauxdistmatrixdb.test2.ascii")
    cfg = tsession.SessionConfig(device="cpu")
    native_db = tsession.SearchSession(db, cfg).db
    assert "native DB loader not used" not in capsys.readouterr().err
    if why == "no_compiler":
        monkeypatch.setattr(native, "find_cxx", lambda: None)
    else:
        monkeypatch.setenv("SATAB_NATIVE", "0")
    sess = tsession.SearchSession(db, cfg)
    err = capsys.readouterr().err
    assert err.count("native DB loader not used") == 1
    assert ("no C++ compiler" in err) == (why == "no_compiler")
    _assert_packed_equal(sess.db, native_db)
