// SA tableau search kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cuda_satabsearch_tpu/ops/pallas_sa2.py
// make_pallas2_bucket_search (body `kernel` :535-1091, pallas_call
// :1163): the whole simulated-annealing search of DB entries against K
// queries -- random initial match, integer initial score, maxiter
// annealing moves over r_seq restarts per chain, and the per-entry max
// over chains with the first maximal chain's best map.  Plain PyTorch
// version: ops/engine.py search_plan_plain.  Wrapper, build, launch
// plan and launch counter: ops/sa_kernel.py, ops/kernel_search.py.
//
// Design.  One launch covers every bucket of a launch class (a plan's
// narrow buckets, d2 <= 32, or its wide ones): the buckets' tables are
// passed by value as descriptors, grid x runs over their entries, widest
// bucket first so that the longest chains start first, and grid y over
// the K queries.  One CTA per (entry, query), one thread per chain
// (blockDim = c_par <= 128); each thread runs its r_seq restarts in
// order, the loop that replaces the TPU kernel's sequential grid axis.
// The entry's and the query's distances (bf16: every distance of the
// packed DB and query is on the bf16 grid, io/pack.quantize_dmat, so
// widening back to float is exact) and hi*8+lo codes are staged once in
// shared memory, with four per-type bit masks of the entry's SSEs.  A
// chain's state is its ssemap (an int8 [index][chain] plane) and two
// 128-bit masks in registers: the DB SSEs it uses and the query SSEs it
// maps.  So a move's LORDER window is a find-last / find-first set bit,
// its candidate count a popc of typemask & ~used & window, its pick the
// (rpick+1)-th set bit (__fns), and the delta and the initial score walk
// only the mapped SSEs.  The random numbers of move it+1 are drawn
// before the dependent part of move it (on an H100 this timed the same
// as drawing them in their own move).
//
// Bound.  A launch lasts as long as its longest chain's maxiter x r_seq
// dependent moves: on an H100 a move takes ~4 us whether the CTA is
// alone on the card or shares it with the whole 586-entry DB.  Timed by
// knocking parts out, the O(n1) delta's shared-memory reads (two
// dependent levels per mapped SSE) take about half of a move, the
// threefry draws about a tenth and the double-precision log less
// (scripts/torch_sa_kernel_ab.py).  Device-memory bytes do not bound
// it: each CTA reads its tables once.  Budget: <= 64 registers per
// thread with 0 spills (__launch_bounds__(128, 8); ptxas -v prints
// both: 46-48) and 40,480 B of shared memory per CTA at n1r 8, d2 112,
// LSOLN, c_par 128 (sa_search_smem_bytes; 5 CTAs per SM).
//
// Bitwise contract with the plain version and the JAX package: scores
// are integers; (u - eps) * n and temp * ln u are single IEEE float ops
// (__fsub_rn / __fmul_rn, and the file is built with -fmad=false and
// without --use_fast_math).  ln u is float(log(double(u))), the value
// ops/rng.py ln_f32 computes with the same libdevice log on the card.
// The first maximal chain wins.
//
// Random numbers: either a supplied stream f32[K, E, r_seq, P, c_par]
// (E = the plan's output columns) with ln u in the acceptance slots, or
// threefry2x32 drawn in-kernel exactly as jax.random draws
// uniform(fold_in(fold_in(fold_in(PRNGKey(seed), tag), index), r),
// (P, c_par)) (ops/rng.py): each CTA derives its entry key from the
// seed, its query's tag and its entry's file-order index (-1 for a
// padding row, 0xffffffff as uint32); slot s of chain c is flat index
// s * c_par + c.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch descriptors have external linkage: the C entry points
// below take them.
constexpr int MAX_BUCKETS = 8;  // buckets of one launch

// One bucket of a launch: its resident tables (ops/kernel_search.py
// DeviceBucket), its first block in grid x and its first output column.
struct BucketDesc {
  const int8_t* types;   // [E, d2]
  const uint8_t* tab;    // [E, d2, d2], hi*8 + lo
  const float* dmat;     // [E, d2, d2], on the bf16 grid
  const int* n2;         // [E]
  const int* index;      // [E], file-order index, -1 = padding
  int d2, E, first, out;
};

struct PlanDesc {
  BucketDesc b[MAX_BUCKETS];  // first blocks ascending
  int nb;
};

namespace {

constexpr int NTYPES = 4;       // SSE types 0..3 (core/codes.py)
constexpr int MAXW = 4;         // 32-bit words of a mask: d2, n1r <= 128

struct SAParams {
  int maxiter;
  float temp0;
  float alpha;
  float mxssed;
  float init_matchprob;
  float eps;
  int maxscore_init;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout; offsets in bytes, each region 16-byte aligned.
struct Layout {
  size_t qdmat, edmat, qcode, ecode, qtypes, tmask, map, best, red, total;
  __host__ __device__ Layout(int n1r, int d2, int C, bool lsoln) {
    size_t o = 0;
    qdmat = o; o = align16(o + sizeof(__nv_bfloat16) * n1r * n1r);
    edmat = o; o = align16(o + sizeof(__nv_bfloat16) * d2 * d2);
    qcode = o; o = align16(o + static_cast<size_t>(n1r) * n1r);
    ecode = o; o = align16(o + static_cast<size_t>(d2) * d2);
    qtypes = o; o = align16(o + n1r);
    tmask = o; o = align16(o + sizeof(uint32_t) * NTYPES * MAXW);
    map = o; o = align16(o + static_cast<size_t>(n1r) * C);
    best = o; o = align16(o + (lsoln ? static_cast<size_t>(n1r) * C : 0));
    red = o; o = align16(o + sizeof(int) * (C + 2));
    total = o;
  }
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, as jax.random's threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.uniform's float32 at flat index i of key (k0, k1).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry2x32(k0, k1, x0, x1);
  return __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

// Tableau pair score on packed hi*8 + lo codes (+2 / +1 / -2).
__device__ __forceinline__ int tscord(int x, int y) {
  const bool he = (x >> 3) == (y >> 3);
  const bool le = (x & 7) == (y & 7);
  return (he && le) ? 2 : ((he || le) ? 1 : -2);
}

// Bits [0, k) of a 32-bit word (k may lie outside [0, 32]).
__device__ __forceinline__ uint32_t low_bits(int k) {
  return k <= 0 ? 0u : (k >= 32 ? ~0u : (1u << k) - 1u);
}

// Register masks of W words, indexed without local memory.
template <int W>
__device__ __forceinline__ void set_bit(uint32_t (&m)[W], int j) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if ((j >> 5) == w) m[w] |= 1u << (j & 31);
}

template <int W>
__device__ __forceinline__ void clear_bit(uint32_t (&m)[W], int j) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if ((j >> 5) == w) m[w] &= ~(1u << (j & 31));
}

// m[w] for a w the compiler may not know (a loop it does not unroll).
template <int W>
__device__ __forceinline__ uint32_t word(const uint32_t (&m)[W], int w) {
  uint32_t r = 0;
#pragma unroll
  for (int u = 0; u < W; ++u) r = u == w ? m[u] : r;
  return r;
}

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// EW / QW: mask words of the entry's / the query's SSEs (1 for <= 32).
template <int EW, int QW>
__global__ void __launch_bounds__(128, 8) sa_plan_kernel(
    const __grid_constant__ PlanDesc plan,
    const int8_t* __restrict__ qtypes, const uint8_t* __restrict__ qtab,
    const float* __restrict__ qdmat, const int* __restrict__ n1s, int n1r,
    uint32_t seed, const int* __restrict__ tags,
    const float* __restrict__ uniforms, int ecols, int r_seq, int lorder,
    int lsoln, SAParams p, int* __restrict__ out_scores,
    int* __restrict__ out_maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.y;
  const int c = threadIdx.x;
  const int C = blockDim.x;

  // this block's bucket: the last one whose first block is <= blockIdx.x
  int bi = 0;
  for (int i = 1; i < plan.nb; ++i)
    if (static_cast<int>(blockIdx.x) >= plan.b[i].first) bi = i;
  const BucketDesc& B = plan.b[bi];
  const int e = blockIdx.x - B.first;
  const int d2 = B.d2;

  const Layout L(n1r, d2, C, lsoln != 0);
  __nv_bfloat16* s_qd = reinterpret_cast<__nv_bfloat16*>(smem + L.qdmat);
  __nv_bfloat16* s_ed = reinterpret_cast<__nv_bfloat16*>(smem + L.edmat);
  uint8_t* s_qc = smem + L.qcode;
  uint8_t* s_ec = smem + L.ecode;
  int8_t* s_qt = reinterpret_cast<int8_t*>(smem + L.qtypes);
  uint32_t* s_tm = reinterpret_cast<uint32_t*>(smem + L.tmask);
  int8_t* s_map = reinterpret_cast<int8_t*>(smem + L.map) + c;
  int8_t* s_best = reinterpret_cast<int8_t*>(smem + L.best) + c;
  int* s_red = reinterpret_cast<int*>(smem + L.red);

  // stage the tables: 16-byte loads (d2 and n1r are multiples of 8, so
  // every table is a whole number of 64-byte rows)
  {
    const size_t qoff = static_cast<size_t>(q) * n1r * n1r;
    const size_t eoff = static_cast<size_t>(e) * d2 * d2;
    const float4* qd4 = reinterpret_cast<const float4*>(qdmat + qoff);
    const float4* ed4 = reinterpret_cast<const float4*>(B.dmat + eoff);
    __nv_bfloat162* sq2 = reinterpret_cast<__nv_bfloat162*>(s_qd);
    __nv_bfloat162* se2 = reinterpret_cast<__nv_bfloat162*>(s_ed);
    for (int t = c; t < n1r * n1r / 4; t += C) {
      const float4 v = qd4[t];
      sq2[2 * t] = __floats2bfloat162_rn(v.x, v.y);
      sq2[2 * t + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    for (int t = c; t < d2 * d2 / 4; t += C) {
      const float4 v = ed4[t];
      se2[2 * t] = __floats2bfloat162_rn(v.x, v.y);
      se2[2 * t + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    const uint4* qc16 = reinterpret_cast<const uint4*>(qtab + qoff);
    const uint4* ec16 = reinterpret_cast<const uint4*>(B.tab + eoff);
    for (int t = c; t < n1r * n1r / 16; t += C)
      reinterpret_cast<uint4*>(s_qc)[t] = qc16[t];
    for (int t = c; t < d2 * d2 / 16; t += C)
      reinterpret_cast<uint4*>(s_ec)[t] = ec16[t];
    for (int t = c; t < n1r; t += C) s_qt[t] = qtypes[q * n1r + t];
  }
  const int n2 = B.n2[e];
  // per-type masks of the entry's SSEs j < n2
  for (int t = c; t < NTYPES * EW; t += C) {
    const int ty = t / EW, w = t % EW;
    const int8_t* et = B.types + static_cast<size_t>(e) * d2;
    uint32_t m = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * w + b;
      if (j < n2 && j < d2 && et[j] == ty) m |= 1u << b;
    }
    s_tm[ty * EW + w] = m;
  }
  __syncthreads();

  const int n1 = n1s[q];
  const float n1f = static_cast<float>(n1);
  const int P = n1r + 3 * p.maxiter;
  const size_t row = static_cast<size_t>(q) * ecols + B.out + e;
  uint32_t ek0 = 0, ek1 = 0;
  if (tags != nullptr) {
    // fold_in(fold_in(PRNGKey(seed), tag), index): ops/rng.entry_keys
    uint32_t t0 = 0, t1 = static_cast<uint32_t>(tags[q]);
    threefry2x32(0u, seed, t0, t1);
    ek1 = static_cast<uint32_t>(B.index[e]);
    threefry2x32(t0, t1, ek0, ek1);
  }

  int maxscore = p.maxscore_init;
  if (lsoln)
    for (int i = 0; i < n1r; ++i) s_best[i * C] = -1;

  for (int r = 0; r < r_seq; ++r) {
    // restart key fold_in(entry_key, r), or this restart's supplied rows
    uint32_t rk0 = 0, rk1 = static_cast<uint32_t>(r);
    threefry2x32(ek0, ek1, rk0, rk1);
    const float* ur = uniforms == nullptr
                          ? nullptr
                          : uniforms + ((row * r_seq + r) * P) * C;
    auto draw = [&](int s) -> float {
      return ur != nullptr ? ur[static_cast<size_t>(s) * C + c]
                           : uniform_at(rk0, rk1,
                                        static_cast<uint32_t>(s * C + c));
    };
    auto draw_log = [&](int s) -> float {  // acceptance slots carry ln u
      if (ur != nullptr) return ur[static_cast<size_t>(s) * C + c];
      const float u = uniform_at(rk0, rk1, static_cast<uint32_t>(s * C + c));
      return static_cast<float>(log(static_cast<double>(u)));  // ops/rng.ln_f32
    };

    for (int i = 0; i < n1r; ++i) s_map[i * C] = -1;
    uint32_t used[EW], mapped[QW];
#pragma unroll
    for (int w = 0; w < EW; ++w) used[w] = 0;
#pragma unroll
    for (int w = 0; w < QW; ++w) mapped[w] = 0;

    // thinit: greedy random initial match, monotone DB cursor
    int cursor = 0;
    bool stopped = false;
    for (int i = 0; i < n1; ++i) {
      const float u = draw(i);
      if (u < p.init_matchprob && !stopped) {
        const int t1 = s_qt[i];
        int found = -1;  // the first SSE of type t1 at or after the cursor
        if (t1 >= 0 && t1 < NTYPES) {
#pragma unroll
          for (int w = EW - 1; w >= 0; --w) {
            const uint32_t m = s_tm[t1 * EW + w] & ~low_bits(cursor - 32 * w);
            if (m) found = 32 * w + __ffs(m) - 1;
          }
        }
        if (found >= 0) {
          s_map[i * C] = static_cast<int8_t>(found);
          set_bit(used, found);
          set_bit(mapped, i);
          cursor = found + 1;
        } else {
          stopped = true;
        }
      }
    }

    // initial score: integer sum over mapped pairs i < k
    int score = 0;
    for (int wi = 0; wi < QW; ++wi) {
      uint32_t mi = word(mapped, wi);
      while (mi) {
        const int i = 32 * wi + __ffs(mi) - 1;
        mi &= mi - 1;
        const int li = s_map[i * C];
        for (int wk = 0; wk < QW; ++wk) {
          uint32_t mk = word(mapped, wk) & ~low_bits(i + 1 - 32 * wk);
          while (mk) {
            const int k = 32 * wk + __ffs(mk) - 1;
            mk &= mk - 1;
            const int lk = s_map[k * C];
            if (fabsf(__fsub_rn(widen(s_qd[i * n1r + k]),
                                widen(s_ed[li * d2 + lk]))) <= p.mxssed)
              score += tscord(s_qc[i * n1r + k], s_ec[li * d2 + lk]);
          }
        }
      }
    }
    if (score > maxscore) {
      maxscore = score;
      if (lsoln)
        for (int i = 0; i < n1; ++i) s_best[i * C] = s_map[i * C];
    }

    float temp = p.temp0;
    float nx_move = 0.0f, nx_cand = 0.0f, nx_acc = 0.0f;
    if (p.maxiter > 0) {
      nx_move = draw(n1r);
      nx_cand = draw(n1r + 1);
      nx_acc = draw_log(n1r + 2);
    }
    for (int it = 0; it < p.maxiter; ++it) {
      const float u_move = nx_move, u_cand = nx_cand, ln_acc = nx_acc;
      if (it + 1 < p.maxiter) {  // move it+1's draws, off the chain
        const int base = n1r + 3 * (it + 1);
        nx_move = draw(base);
        nx_cand = draw(base + 1);
        nx_acc = draw_log(base + 2);
      }
      const int ssei = static_cast<int>(__fmul_rn(__fsub_rn(u_move, p.eps), n1f));

      // candidate window (kernel.cu:1053-1083, with its quirks):
      // startj = map of the last mapped SSE at or below ssei, else n2;
      // endj = n2 at ssei = n1 - 1, else map of the first mapped SSE
      // above ssei, else -1
      int startj = 0, endj = n2;
      if (lorder) {
        int kb = -1, kn = -1;
#pragma unroll
        for (int w = 0; w < QW; ++w) {
          const uint32_t m = mapped[w] & low_bits(ssei + 1 - 32 * w);
          if (m) kb = 32 * w + 31 - __clz(m);
        }
#pragma unroll
        for (int w = QW - 1; w >= 0; --w) {
          const uint32_t m = mapped[w] & ~low_bits(ssei + 1 - 32 * w);
          if (m) kn = 32 * w + __ffs(m) - 1;
        }
        startj = kb >= 0 ? s_map[kb * C] : n2;
        endj = ssei == n1 - 1 ? n2 : (kn >= 0 ? s_map[kn * C] : -1);
      }

      // uniform pick among same-type unused DB SSEs in the window
      const int qt = s_qt[ssei];
      const int hi = min(endj, d2);
      uint32_t cand[EW];
      int count = 0;
#pragma unroll
      for (int w = 0; w < EW; ++w) {
        const uint32_t win = low_bits(hi - 32 * w) & ~low_bits(startj - 32 * w);
        cand[w] = (qt >= 0 && qt < NTYPES) ? s_tm[qt * EW + w] & ~used[w] & win
                                           : 0u;
        count += __popc(cand[w]);
      }
      const int rpick = static_cast<int>(
          __fmul_rn(__fsub_rn(u_cand, p.eps), static_cast<float>(count)));
      int newj = -1;  // -1 = unmap
      if (rpick >= 0) {
        int rank = rpick;  // the (rpick + 1)-th candidate in index order
#pragma unroll
        for (int w = 0; w < EW; ++w) {
          const int nw = __popc(cand[w]);
          if (newj < 0 && rank < nw)
            newj = 32 * w + static_cast<int>(__fns(cand[w], 0, rank + 1));
          rank -= nw;
        }
      }
      const int oldj = s_map[ssei * C];

      // incremental delta over the mapped query SSEs k != ssei
      int delta = 0;
      for (int w = 0; w < QW; ++w) {
        uint32_t m = word(mapped, w);
        if ((ssei >> 5) == w) m &= ~(1u << (ssei & 31));
        while (m) {
          const int k = 32 * w + __ffs(m) - 1;
          m &= m - 1;
          const int l = s_map[k * C];
          const float qd = widen(s_qd[k * n1r + ssei]);
          const int qc = s_qc[k * n1r + ssei];
          if (oldj >= 0 && l != oldj &&
              fabsf(__fsub_rn(qd, widen(s_ed[oldj * d2 + l]))) <= p.mxssed)
            delta -= tscord(qc, s_ec[oldj * d2 + l]);
          if (newj >= 0 && l != newj &&
              fabsf(__fsub_rn(qd, widen(s_ed[newj * d2 + l]))) <= p.mxssed)
            delta += tscord(qc, s_ec[newj * d2 + l]);
        }
      }

      // max tracking before acceptance
      const int newscore = score + delta;
      if (newscore > maxscore) {
        maxscore = newscore;
        if (lsoln)
          for (int k = 0; k < n1; ++k)
            s_best[k * C] = k == ssei ? static_cast<int8_t>(newj) : s_map[k * C];
      }

      // log-domain Metropolis acceptance
      if (static_cast<float>(delta) > __fmul_rn(temp, ln_acc)) {
        score = newscore;
        s_map[ssei * C] = static_cast<int8_t>(newj);
        if (oldj >= 0) clear_bit(used, oldj);
        if (newj >= 0) {
          set_bit(used, newj);
          set_bit(mapped, ssei);
        } else {
          clear_bit(mapped, ssei);
        }
      }
      temp = __fmul_rn(temp, p.alpha);
    }
  }

  // per-entry max over chains; the lowest-index maximal chain wins
  s_red[c] = maxscore;
  __syncthreads();
  if (c == 0) {
    int best = s_red[0], winner = 0;
    for (int t = 1; t < C; ++t) {
      if (s_red[t] > best) {
        best = s_red[t];
        winner = t;
      }
    }
    s_red[C] = best;
    s_red[C + 1] = winner;
    out_scores[row] = best;
  }
  __syncthreads();
  if (lsoln) {
    const int8_t* wbest =
        reinterpret_cast<const int8_t*>(smem + L.best) + s_red[C + 1];
    for (int i = c; i < n1r; i += C) out_maps[row * n1r + i] = wbest[i * C];
  }
}

using KernelFn = void (*)(PlanDesc, const int8_t*, const uint8_t*,
                          const float*, const int*, int, uint32_t,
                          const int*, const float*, int, int, int, int,
                          SAParams, int*, int*);

// The instantiation for a launch class whose widest bucket is d2max.
KernelFn kernel_for(int d2max, int n1r) {
  if (d2max <= 32) return n1r <= 32 ? sa_plan_kernel<1, 1> : sa_plan_kernel<1, 4>;
  return n1r <= 32 ? sa_plan_kernel<4, 1> : sa_plan_kernel<4, 4>;
}

const KernelFn ALL_KERNELS[] = {sa_plan_kernel<1, 1>, sa_plan_kernel<1, 4>,
                                sa_plan_kernel<4, 1>, sa_plan_kernel<4, 4>};

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs.
size_t sa_search_smem_bytes(int n1r, int d2, int c_par, int lsoln) {
  return Layout(n1r, d2, c_par, lsoln != 0).total;
}

// One-time set-up of the kernels on the current device: loads their
// module (cudaFuncGetAttributes forces the lazy load that the first
// launch would otherwise pay) and allows each `device_max_smem` bytes of
// dynamic shared memory, the device's opt-in limit, so that no launch
// has to set the attribute.  Returns the cudaError_t (0 = success).
int sa_search_prepare(int device_max_smem) {
  for (KernelFn fn : ALL_KERNELS) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        device_max_smem - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// CTAs of c_par threads per SM for a launch class whose widest bucket is
// d2max (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks,
// and the kernel's registers per thread and local (spill) bytes into
// *regs and *local.  Returns the cudaError_t.
int sa_search_occupancy(int d2max, int n1r, int c_par, int lsoln,
                        int* blocks, int* regs, int* local) {
  const KernelFn fn = kernel_for(d2max, n1r);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, c_par, sa_search_smem_bytes(n1r, d2max, c_par, lsoln)));
}

// Launches one launch class of a plan on `stream`: grid (the buckets'
// entries, K), c_par threads, shared memory for the widest bucket
// d2max.  Returns the cudaError_t of the launch (0 = success).
// sa_search_prepare must have run on the device first.  `uniforms`
// (supplied stream) or `tags` (in-kernel threefry from seed, tags and
// the buckets' file-order indices): exactly one is non-null.  Scores go
// to out_scores[q * ecols + column], maps (may be null when lsoln == 0)
// to out_maps[(q * ecols + column) * n1r + i].
int sa_search_launch(const PlanDesc* plan, int d2max, const int8_t* qtypes,
                     const uint8_t* qtab, const float* qdmat, const int* n1s,
                     int K, int n1r, uint32_t seed, const int* tags,
                     const float* uniforms, int ecols, int c_par, int r_seq,
                     int lorder, int lsoln, int maxiter, float temp0,
                     float alpha, float mxssed, float init_matchprob,
                     float eps, int maxscore_init, int* out_scores,
                     int* out_maps, void* stream) {
  const SAParams p{maxiter, temp0, alpha, mxssed, init_matchprob, eps,
                   maxscore_init};
  int nblocks = 0;
  for (int i = 0; i < plan->nb; ++i) nblocks += plan->b[i].E;
  const size_t smem = sa_search_smem_bytes(n1r, d2max, c_par, lsoln);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(K));
  kernel_for(d2max, n1r)<<<grid, c_par, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      *plan, qtypes, qtab, qdmat, n1s, n1r, seed, tags, uniforms, ecols,
      r_seq, lorder, lsoln, p, out_scores, out_maps);
  return static_cast<int>(cudaGetLastError());
}

const char* sa_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
