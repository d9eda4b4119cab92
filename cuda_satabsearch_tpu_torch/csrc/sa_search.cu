// SA tableau search kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cuda_satabsearch_tpu/ops/pallas_sa2.py
// make_pallas2_bucket_search (body `kernel` :535-1091, pallas_call
// :1163): the whole simulated-annealing search of one bucket of DB
// entries against K queries -- random initial match, integer initial
// score, maxiter annealing moves over r_seq restarts per chain, and the
// per-entry max over chains with the first maximal chain's best map.
// Plain PyTorch version: ops/engine.py search_plain.  Wrapper, build and
// launch counter: ops/sa_kernel.py.
//
// Design.  One CTA per (entry, query): grid (E, K), one thread per
// chain (blockDim = c_par <= 128); each thread runs its r_seq restarts
// in order, the loop that replaces the TPU kernel's sequential grid
// axis (the reference's own thread-per-chain layout).  The entry's and
// the query's types, hi*8+lo codes and distances are staged once in
// shared memory (<= 63 KB each at 112 SSEs), beside per-chain
// ssemap / revmap / bestmap as int8 [index][chain] planes (<= 43 KB),
// so a warp's per-chain reads of one index hit neighbouring bytes.
//
// Bound: per-chain serial latency.  Every move is a chain of
// data-dependent shared-memory reads (LORDER window walk, candidate
// scan over the window, O(n1) delta over the mapped SSEs); the tables
// are read from device memory once per CTA, so device-memory bytes do
// not bound it.  The simple design leaves the imbalance between small
// and large entries of a launch, and low occupancy at wide buckets, to
// later work.
//
// Bitwise contract with the plain version and the JAX package: scores
// are integers; (u - eps) * n and temp * ln u are single IEEE float ops
// (__fsub_rn / __fmul_rn, and the file is built with -fmad=false and
// without --use_fast_math).  ln u is float(log(double(u))), the value
// ops/rng.py ln_f32 computes with the same libdevice log on the card.
//
// Random numbers: either a supplied stream f32[K, E, r_seq, P, c_par]
// with ln u in the acceptance slots, or threefry2x32 drawn in-kernel
// from entry keys u32[K, E, 2] exactly as jax.random draws
// uniform(fold_in(entry_key, r), (P, c_par)): slot s of chain c is flat
// index s * c_par + c.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

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
  size_t qdmat, edmat, qcode, ecode, qtypes, etypes, map, rev, best, red,
      total;
  __host__ __device__ Layout(int n1r, int d2, int C, bool lsoln) {
    size_t o = 0;
    qdmat = o; o = align16(o + sizeof(float) * n1r * n1r);
    edmat = o; o = align16(o + sizeof(float) * d2 * d2);
    qcode = o; o = align16(o + static_cast<size_t>(n1r) * n1r);
    ecode = o; o = align16(o + static_cast<size_t>(d2) * d2);
    qtypes = o; o = align16(o + n1r);
    etypes = o; o = align16(o + d2);
    map = o; o = align16(o + static_cast<size_t>(n1r) * C);
    rev = o; o = align16(o + static_cast<size_t>(d2) * C);
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

__global__ void __launch_bounds__(128) sa_search_kernel(
    const int8_t* __restrict__ qtypes, const uint8_t* __restrict__ qtab,
    const float* __restrict__ qdmat, const int* __restrict__ n1s, int n1r,
    const int8_t* __restrict__ types, const uint8_t* __restrict__ tab,
    const float* __restrict__ dmat, const int* __restrict__ n2s, int E,
    int d2, const float* __restrict__ uniforms,
    const uint32_t* __restrict__ keys, int r_seq, int lorder, int lsoln,
    SAParams p, int* __restrict__ out_scores, int* __restrict__ out_maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.x;
  const int q = blockIdx.y;
  const int c = threadIdx.x;
  const int C = blockDim.x;
  const Layout L(n1r, d2, C, lsoln != 0);
  float* s_qd = reinterpret_cast<float*>(smem + L.qdmat);
  float* s_ed = reinterpret_cast<float*>(smem + L.edmat);
  uint8_t* s_qc = smem + L.qcode;
  uint8_t* s_ec = smem + L.ecode;
  int8_t* s_qt = reinterpret_cast<int8_t*>(smem + L.qtypes);
  int8_t* s_et = reinterpret_cast<int8_t*>(smem + L.etypes);
  int8_t* s_map = reinterpret_cast<int8_t*>(smem + L.map) + c;
  int8_t* s_rev = reinterpret_cast<int8_t*>(smem + L.rev) + c;
  int8_t* s_best = reinterpret_cast<int8_t*>(smem + L.best) + c;
  int* s_red = reinterpret_cast<int*>(smem + L.red);

  const size_t qoff = static_cast<size_t>(q) * n1r * n1r;
  const size_t eoff = static_cast<size_t>(e) * d2 * d2;
  for (int t = c; t < n1r * n1r; t += C) {
    s_qd[t] = qdmat[qoff + t];
    s_qc[t] = qtab[qoff + t];
  }
  for (int t = c; t < d2 * d2; t += C) {
    s_ed[t] = dmat[eoff + t];
    s_ec[t] = tab[eoff + t];
  }
  for (int t = c; t < n1r; t += C) s_qt[t] = qtypes[q * n1r + t];
  for (int t = c; t < d2; t += C) s_et[t] = types[static_cast<size_t>(e) * d2 + t];
  __syncthreads();

  const int n1 = n1s[q];
  const int n2 = n2s[e];
  const float n1f = static_cast<float>(n1);
  const int P = n1r + 3 * p.maxiter;
  const size_t row = static_cast<size_t>(q) * E + e;
  uint32_t ek0 = 0, ek1 = 0;
  if (keys != nullptr) {
    ek0 = keys[2 * row];
    ek1 = keys[2 * row + 1];
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
    for (int j = 0; j < d2; ++j) s_rev[j * C] = -1;

    // thinit: greedy random initial match, monotone DB cursor
    int cursor = 0;
    bool stopped = false;
    for (int i = 0; i < n1; ++i) {
      const float u = draw(i);
      if (u < p.init_matchprob && !stopped) {
        const int t1 = s_qt[i];
        int found = -1;
        for (int j = cursor; j < n2; ++j) {
          if (s_et[j] == t1) {
            found = j;
            break;
          }
        }
        if (found >= 0) {
          s_map[i * C] = static_cast<int8_t>(found);
          s_rev[found * C] = static_cast<int8_t>(i);
          cursor = found + 1;
        } else {
          stopped = true;
        }
      }
    }

    // initial score: integer sum over matched pairs i < k
    int score = 0;
    for (int i = 0; i < n1; ++i) {
      const int li = s_map[i * C];
      if (li < 0) continue;
      for (int k = i + 1; k < n1; ++k) {
        const int lk = s_map[k * C];
        if (lk < 0) continue;
        if (fabsf(__fsub_rn(s_qd[i * n1r + k], s_ed[li * d2 + lk])) <=
            p.mxssed)
          score += tscord(s_qc[i * n1r + k], s_ec[li * d2 + lk]);
      }
    }
    if (score > maxscore) {
      maxscore = score;
      if (lsoln)
        for (int i = 0; i < n1; ++i) s_best[i * C] = s_map[i * C];
    }

    float temp = p.temp0;
    for (int it = 0; it < p.maxiter; ++it) {
      const int base = n1r + 3 * it;
      const float u_move = draw(base);
      const float u_cand = draw(base + 1);
      const float ln_acc = draw_log(base + 2);
      const int ssei = static_cast<int>(__fmul_rn(__fsub_rn(u_move, p.eps), n1f));

      // candidate window (kernel.cu:1053-1083, with its quirks)
      int startj = 0, endj = n2;
      if (lorder) {
        startj = n2;
        for (int k = ssei; k >= 0; --k) {
          const int v = s_map[k * C];
          if (v >= 0) {
            startj = v;
            break;
          }
        }
        if (ssei != n1 - 1) {
          endj = -1;
          for (int k = ssei + 1; k < n1; ++k) {
            const int v = s_map[k * C];
            if (v >= 0) {
              endj = v;
              break;
            }
          }
        }
      }

      // uniform pick among same-type unmatched DB SSEs in the window
      const int qt = s_qt[ssei];
      const int hi = min(endj, d2);
      int count = 0;
      for (int j = startj; j < hi; ++j)
        count += (s_et[j] == qt && s_rev[j * C] < 0) ? 1 : 0;
      const int rpick = static_cast<int>(
          __fmul_rn(__fsub_rn(u_cand, p.eps), static_cast<float>(count)));
      int newj = -1;  // -1 = unmap
      if (count > 0) {
        int seen = 0;
        for (int j = startj; j < hi; ++j) {
          if (s_et[j] == qt && s_rev[j * C] < 0 && ++seen == rpick + 1) {
            newj = j;
            break;
          }
        }
      }
      const int oldj = s_map[ssei * C];

      // O(n1) incremental delta over the mapped query SSEs
      int delta = 0;
      for (int k = 0; k < n1; ++k) {
        const int l = s_map[k * C];
        if (l < 0 || k == ssei) continue;
        const float qd = s_qd[k * n1r + ssei];
        const int qc = s_qc[k * n1r + ssei];
        if (oldj >= 0 && l != oldj &&
            fabsf(__fsub_rn(qd, s_ed[oldj * d2 + l])) <= p.mxssed)
          delta -= tscord(qc, s_ec[oldj * d2 + l]);
        if (newj >= 0 && l != newj &&
            fabsf(__fsub_rn(qd, s_ed[newj * d2 + l])) <= p.mxssed)
          delta += tscord(qc, s_ec[newj * d2 + l]);
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
        if (oldj >= 0) s_rev[oldj * C] = -1;
        if (newj >= 0) s_rev[newj * C] = static_cast<int8_t>(ssei);
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs.
size_t sa_search_smem_bytes(int n1r, int d2, int c_par, int lsoln) {
  return Layout(n1r, d2, c_par, lsoln != 0).total;
}

// One-time set-up of the kernel on the current device: loads its module
// (cudaFuncGetAttributes forces the lazy load that the first launch
// would otherwise pay) and allows it `device_max_smem` bytes of dynamic
// shared memory, the device's opt-in limit, so that no launch has to set
// the attribute.  Returns the cudaError_t (0 = success).
int sa_search_prepare(int device_max_smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sa_search_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(sa_search_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             device_max_smem - static_cast<int>(
                                 attr.sharedSizeBytes));
  return static_cast<int>(err);
}

// Launches the search on `stream`; returns the cudaError_t of the launch
// (0 = success).  sa_search_prepare must have run on the device first.
// `uniforms` (supplied stream) or `keys` (in-kernel threefry): exactly
// one is non-null.  `out_maps` may be null when lsoln == 0.
int sa_search_launch(const int8_t* qtypes, const uint8_t* qtab,
                     const float* qdmat, const int* n1s, int K, int n1r,
                     const int8_t* types, const uint8_t* tab,
                     const float* dmat, const int* n2s, int E, int d2,
                     const float* uniforms, const uint32_t* keys,
                     int c_par, int r_seq, int lorder, int lsoln,
                     int maxiter, float temp0, float alpha, float mxssed,
                     float init_matchprob, float eps, int maxscore_init,
                     int* out_scores, int* out_maps, void* stream) {
  const SAParams p{maxiter, temp0, alpha, mxssed, init_matchprob, eps,
                   maxscore_init};
  const size_t smem = sa_search_smem_bytes(n1r, d2, c_par, lsoln);
  const dim3 grid(static_cast<unsigned>(E), static_cast<unsigned>(K));
  sa_search_kernel<<<grid, c_par, smem, static_cast<cudaStream_t>(stream)>>>(
      qtypes, qtab, qdmat, n1s, n1r, types, tab, dmat, n2s, E, d2, uniforms,
      keys, r_seq, lorder, lsoln, p, out_scores, out_maps);
  return static_cast<int>(cudaGetLastError());
}

const char* sa_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
