"""The port imports torch and numpy, never jax or the JAX package, and
builds nothing when imported: the CUDA kernel is compiled at its first
launch, so every module imports on a machine without nvcc."""

import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every module of the JAX package's eval/ has its counterpart, plus the
# three drivers that search (the JAX package's scripts/)
EVAL_MODULES = tuple(f"eval.{m}" for m in (
    "roc", "acceptance", "results", "gumbelfit", "fischer", "nh3d", "cops",
    "scop", "timestab", "tables", "plots", "adapters", "extrunner",
    "acceptance_eval", "make_eval_artifact", "gumbel_fit_artifact"))
# the structure-to-hits path and the last modules, the benchmark runner
# among them: every other module of the JAX package has its counterpart
# too
PATH_MODULES = tuple(f"build.{m}" for m in (
    "geom", "pdbfile", "secstruct", "domains", "domeval", "builder", "mfile")
) + ("build", "tools", "tools.superimpose", "tools.ssemap", "tools.tophits",
     "ops.golden", "ops.balance", "graft_entry", "latency_budget",
     "synthetic", "bench")


def _port_modules():
    import cuda_satabsearch_tpu_torch as pkg

    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def _run(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "cuda_satabsearch_tpu_torch.ops.sa_kernel" in mods
    assert "cuda_satabsearch_tpu_torch.cli" in mods
    assert "cuda_satabsearch_tpu_torch.core.warmup" in mods
    for name in ("io.native", "io.writer", "parallel.mesh",
                 "parallel.distributed") + EVAL_MODULES + PATH_MODULES:
        assert f"cuda_satabsearch_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes'))\n"
        "             or m == 'cuda_satabsearch_tpu'\n"
        "             or m.startswith('cuda_satabsearch_tpu.'))\n"
        "print('BAD', bad)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_eval_modules_import_without_scipy_or_matplotlib():
    """Every module of eval/ (the CLI's __main__ too) imports without
    jax, scipy or matplotlib: scipy is imported by a Gumbel fit and
    matplotlib by a plot, and the card's host has no matplotlib."""
    mods = [f"cuda_satabsearch_tpu_torch.{m}"
            for m in EVAL_MODULES + ("eval.__main__",)]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'scipy', 'matplotlib',\n"
        "              'cuda_satabsearch_tpu'))\n"
        "print('BAD', bad)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_path_modules_import_without_scipy_or_matplotlib():
    """build/, tools/ (the CLIs' __main__ too), the golden model, the
    balance accounting, the graft entry and the latency budget import
    without jax, scipy or matplotlib; build/ and tools/ without torch."""
    mods = [f"cuda_satabsearch_tpu_torch.{m}"
            for m in PATH_MODULES + ("build.__main__",)]
    light = [m for m in mods if m.split(".")[1] in ("build", "tools")]
    code = (
        "import importlib, sys\n"
        f"for m in {light!r}:\n"
        "    importlib.import_module(m)\n"
        "torch = 'torch' in sys.modules\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'scipy', 'matplotlib',\n"
        "              'cuda_satabsearch_tpu'))\n"
        "print('BAD', bad, 'TORCH', torch)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "BAD [] TORCH False" in res.stdout, res.stdout


def test_kernel_module_imports_without_nvcc(tmp_path):
    """No nvcc anywhere: the imports succeed, build nothing, and asking
    for the compiler raises a clear error (only a launch on a card
    would ask)."""
    code = (
        "from cuda_satabsearch_tpu_torch.ops import sa_kernel\n"
        "from cuda_satabsearch_tpu_torch.core import warmup\n"
        "assert sa_kernel.sa_search.launches == 0\n"
        "assert warmup.add_one.launches == 0\n"
        "assert sa_kernel.load_library.cache_info().currsize == 0\n"
        "from cuda_satabsearch_tpu_torch.io import native\n"
        "assert native.load_library.cache_info().currsize == 0\n"
        "try:\n"
        "    sa_kernel.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('NO NVCC:', e)\n")
    res = _run(code, env_extra={"PATH": str(tmp_path),
                                "CUDA_HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default place")
    assert "NO NVCC: nvcc not found" in res.stdout
