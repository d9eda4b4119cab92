"""Variants of the port's SA kernel (cuda_satabsearch_tpu_torch/csrc/
sa_search.cu), timed in turns in one process on one NVIDIA GPU.

    python3 scripts/torch_sa_kernel_ab.py

Each variant is the kernel's source with one part rewritten, built with
the port's nvcc flags into cuda_satabsearch_tpu_torch/_build/variants/
(one nvcc per variant, all at once) and run through the port's own
wrapper.  Two groups:

* design variants, which must stay bitwise equal to the kernel (the
  script checks it): ``no_ahead`` draws a move's uniforms in that move
  instead of one move ahead; ``ahead_nobranch`` draws ahead without the
  branch on the last move; ``popc_pick`` picks the (rpick+1)-th
  candidate with a popc binary search instead of ``__fns``;
* knock-outs, which give other results and are timed only, to see where
  a move's time goes: ``knock_log`` takes ln u as ``__logf`` instead of
  float(log(double)), ``knock_rng`` replaces threefry by one multiply,
  ``knock_delta`` skips the O(n1) delta loop, ``knock_all`` does all
  three.

Times (CUDA events) on the 586-entry fixture DB with the d1ubia_ query
at r = 128 (the full plan, and the plan of the one 80-wide entry alone:
one CTA, the latency of one chain) and the d2phlb1 query at r = 4096,
in the order base, variants..., variants reversed, base.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cuda_satabsearch_tpu_torch.ops import sa_kernel  # noqa: E402
from cuda_satabsearch_tpu_torch.ops.kernel_search import (  # noqa: E402
    make_plan, pack_queries)
from cuda_satabsearch_tpu_torch.session import (  # noqa: E402
    SearchSession, SessionConfig)

AHEAD = """      const float u_move = nx_move, u_cand = nx_cand, ln_acc = nx_acc;
      if (it + 1 < p.maxiter) {  // move it+1's draws, off the chain
        const int base = n1r + 3 * (it + 1);
        nx_move = draw(base);
        nx_cand = draw(base + 1);
        nx_acc = draw_log(base + 2);
      }"""
NO_AHEAD = """      const int base0 = n1r + 3 * it;
      const float u_move = draw(base0), u_cand = draw(base0 + 1);
      const float ln_acc = draw_log(base0 + 2);"""
AHEAD_NOBRANCH = """      const float u_move = nx_move, u_cand = nx_cand, ln_acc = nx_acc;
      {
        const int base = n1r + 3 * min(it + 1, p.maxiter - 1);
        nx_move = draw(base);
        nx_cand = draw(base + 1);
        nx_acc = draw_log(base + 2);
      }"""
FNS = "newj = 32 * w + static_cast<int>(__fns(cand[w], 0, rank + 1));"
POPC = """{
            uint32_t m = cand[w];
            int pos = 0, rk = rank;
#pragma unroll
            for (int sh = 16; sh; sh >>= 1) {
              const int cnt = __popc(m & ((1u << sh) - 1u));
              if (rk >= cnt) {
                rk -= cnt;
                m >>= sh;
                pos += sh;
              }
            }
            newj = 32 * w + pos;
          }"""
LOG = ("return static_cast<float>(log(static_cast<double>(u)));"
       "  // ops/rng.ln_f32")
THREEFRY = "  uint32_t x0 = 0, x1 = i;\n  threefry2x32(k0, k1, x0, x1);\n"
DELTA = "        uint32_t m = word(mapped, w);\n"


def rewrite(src: str, *edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the kernel source no longer holds:\n{old}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> tuple[dict, dict]:
    """({name: source} bitwise variants, {name: source} knock-outs)."""
    log = (LOG, "return __logf(u);")
    rng = (THREEFRY, "  uint32_t x0 = i * 0x9E3779B9u ^ k0, x1 = i + k1;\n")
    delta = (DELTA, "        uint32_t m = 0u;\n")
    design = {"base": src,
              "no_ahead": rewrite(src, (AHEAD, NO_AHEAD)),
              "ahead_nobranch": rewrite(src, (AHEAD, AHEAD_NOBRANCH)),
              "popc_pick": rewrite(src, (FNS, POPC))}
    knock = {"knock_log": rewrite(src, log),
             "knock_rng": rewrite(src, rng),
             "knock_delta": rewrite(src, delta),
             "knock_all": rewrite(src, log, rng, delta)}
    return design, knock


def build(sources: dict) -> dict:
    """{name: Library} of each variant, built side by side."""
    vdir = sa_kernel.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    nvcc = sa_kernel.find_nvcc()
    warm = str(sa_kernel.SOURCES[1])
    procs = {}
    for name, text in sources.items():
        cu = vdir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *sa_kernel.NVCC_FLAGS, "-shared", "-o",
             str(vdir / f"{name}.so"), str(cu), warm],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = sa_kernel.load_library().lib
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in log.splitlines() if "registers" in ln})
        print(f"{name}: ptxas registers {regs}", flush=True)
        lib = ctypes.CDLL(str(vdir / f"{name}.so"))
        for fn in ("sa_search_launch", "sa_search_prepare",
                   "sa_search_smem_bytes", "sa_search_occupancy",
                   "sa_search_error_string", "add_one_launch"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = sa_kernel.Library(lib=lib, path=vdir / f"{name}.so",
                                       build_s=0.0, log=log)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    src = sa_kernel.SOURCES[0].read_text()
    design, knock = variants(src)
    libs = build({**design, **knock})
    dev = torch.device("cuda", 0)
    sess = SearchSession(chip_smoke.DB586, SessionConfig(maxstart=128,
                                                         device=str(dev)))
    (full,) = sess.device_db
    one80 = make_plan([b for b in full.buckets if b.dim == 80])
    q8 = pack_queries(chip_smoke.read_query("d1ubia_.input"), 8, dev)
    q19 = pack_queries(chip_smoke.read_query("d2phlb1.input"), 24, dev)
    runs = {"586db d1ubia_ r=128, full plan": (q8, full, 1),
            "586db d1ubia_ r=128, the 80-wide entry alone": (q8, one80, 1),
            "586db d2phlb1 r=4096, full plan": (q19, full, 32)}
    real = sa_kernel.load_library

    def search(name, q, plan, r_seq):
        sa_kernel.load_library = lambda: libs[name]
        try:
            return sa_kernel.sa_search(*q, plan, seed=1234, tags=[0],
                                       c_par=128, r_seq=r_seq, lorder=True,
                                       lsoln=True)
        finally:
            sa_kernel.load_library = real

    ref = {r: search("base", *args) for r, args in runs.items()}
    for name in design:
        for r, args in runs.items():
            s, m = search(name, *args)
            torch.cuda.synchronize()
            if not (torch.equal(s, ref[r][0]) and torch.equal(m, ref[r][1])):
                raise SystemExit(f"{name} differs from the kernel on {r}")
    print(f"design variants {list(design)[1:]} == the kernel bitwise "
          f"(scores and maps) on every run", flush=True)
    names = list(design) + list(knock)
    times = {}
    for name in names + names[::-1]:
        for r, args in runs.items():
            reps = 5 if args[2] > 1 else 20
            times.setdefault((r, name), []).append(
                chip_smoke.cuda_ms(lambda: search(name, *args), reps))
    print(chip_smoke.card_line())
    for r in runs:
        print(f"{r} (ms, CUDA events):")
        for name in names:
            print(f"  {name:15s} " + " / ".join(
                f"{t:.4f}" for t in times[(r, name)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
