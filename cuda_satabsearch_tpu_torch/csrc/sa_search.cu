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
// Restart split: where a launch would fill few waves of the card's CTA
// slots (ops/sa_kernel.restart_split: one query at r = 4096 is 586
// CTAs against ~1,320 narrow slots), grid z = S splits each chain's
// restarts over S CTAs per (entry, query), split z running restarts
// [z r_seq / S, (z + 1) r_seq / S) of all c_par chains
// (sa_plan_kernel<EW, QW, true, 1>); each split writes its best score,
// its first maximal chain and that chain's map, and sa_split_reduce,
// launched after it on the same stream, makes the entry's result.
// Lanes: where an unsplit launch pair fits in one wave
// (ops/sa_kernel.chain_lanes), a class may run each chain on G = 2 or
// 4 adjacent lanes of one warp (sa_plan_kernel<EW, QW, false, G>,
// blockDim = c_par x G).  Every lane holds the chain's whole state and
// updates it alike; lane 0 writes the map plane.  Lane g draws slot
// min(g, 2) of the next move (G = 2: slot g, and both the acceptance
// slot), walks the mapped SSEs of rank = g (mod G) in the delta and the
// initial score, and copies the map rows i = g (mod G) at a new max;
// shuffles trade the draws and sum the integer partial scores, so every
// chain runs the same states as at G = 1, bit for bit.
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
// Bound.  An unsplit launch that fits in one wave lasts as long as its
// longest chain's maxiter x r_seq dependent moves: on an H100 a move
// takes ~3-4 us whether the CTA is alone on the card or shares it with
// the whole 586-entry DB.  So one query at r = 4096 (3,200 moves a
// chain) leaves most of the card idle; split into many waves of short
// CTAs, the launch runs at the card's throughput instead (13.5 -> 6.3
// ms a query at S = 32).  At r = 128 (one restart) lanes shorten the
// move where the SMs' warp schedulers idle: a class of fewer CTAs
// than SMs (the 586-entry DB's 30 wide ones: 0.46 -> 0.32 ms alone at
// G = 4), or long queries (n1r >= 24); where a class already gives each
// SM ~4 CTAs, the work every lane repeats (window, pick, bookkeeping)
// costs more scheduler cycles than the shared delta saves (n1r 16:
// 0.47 -> 0.51 ms at G = 2).  Timed by knocking parts out
// (scripts/torch_sa_kernel_ab.py), a move's cost depends on the regime.
// On one 586-entry query (about 4 CTAs a SM) the O(n1) delta's
// shared-memory reads (two dependent levels per mapped SSE) took about
// half of a move.  On a full card (tiles of 8 queries against 14,291
// entries at r = 4096, ~58 waves) the move's fixed path dominates: at
// n1r 8 / 16 the three threefry draws take 48 / 43 %, the delta 13 /
// 22 %, the screened Metropolis test 2.6 / 1.8 % (the double-precision
// log it replaced took 11 / 10 %); the window, the pick and the
// bookkeeping the rest.  Device-memory bytes do not bound it: each CTA
// reads its tables once.  Budget: <= 64 registers per thread with 0
// spills (__launch_bounds__(128, 8); ptxas -v prints both: 47-48; the
// split instantiations take (128, 10), which holds them to the same
// 47-48 and 10 narrow CTAs per SM, where they would take 54-56 and 9;
// the lane ones (128 G, 10 / G): 47-48 at G = 2, so 5 CTAs of 256
// threads per SM, 50-55 at G = 4; G = 8 timed slower than G = 4 in
// every class and width, and is not built) and 40,480 B of shared
// memory per CTA at n1r 8, d2 112, LSOLN, c_par 128
// (sa_search_smem_bytes; 5 CTAs per SM), whatever G.
//
// Bitwise contract with the plain version and the JAX package: scores
// are integers; (u - eps) * n and temp * ln u are single IEEE float ops
// (__fsub_rn / __fmul_rn, and the file is built with -fmad=false and
// without --use_fast_math).  ln u is float(log(double(u))), the value
// ops/rng.py ln_f32 computes with the same libdevice log on the card.
// The Metropolis screen keeps it: with in-kernel draws (and a
// temperature schedule that sa_kernel.screens admits) a move is decided
// by the float32 fast_ln(u) where temp * fast_ln(u) lies more than
// temp * sa_kernel.SCREEN_MARGIN from delta, a margin that bounds the
// gap to temp * ln u and every rounding of the test
// (tests/test_torch_accept_screen.py checks it on every grid u and
// temperature); elsewhere ln u decides, read from a table of exact_ln
// over the grid made once per device (sa_ln_grid), in one branch per
// warp that ~2 in 10^4 of a warp's moves take.
// The first maximal chain wins, its map the one of the first time
// (restart, then move) it reached the max.  A split keeps that: each
// chain's running max starts from maxscore_init in every split and is
// replaced only by a strictly greater score, so split z holds, per
// chain, the max over its restarts and its first occurrence there.  Let
// G be the entry's max and c* the lowest chain that reaches it in any
// split: every split in which c* reaches G has c* as its own first
// maximal chain, and the lowest of those holds c*'s first occurrence in
// restart order.  So the reduction takes the largest best score, then
// the lowest winner, then the lowest split.  Where nothing beats
// maxscore_init, every split reports chain 0 and a map of -1s, as the
// unsplit kernel does.
//
// Random numbers: either a supplied stream f32[K, E, r_seq, P, c_par]
// (E = the plan's output columns) with ln u in the acceptance slots, or
// threefry2x32 drawn in-kernel exactly as jax.random draws
// uniform(fold_in(fold_in(fold_in(PRNGKey(seed), tag), index), r),
// (P, c_par)) (ops/rng.py): each CTA derives its entry key from the
// seed, its query's tag and its entry's file-order index (-1 for a
// padding row, 0xffffffff as uint32); slot s of chain c is flat index
// s * c_par + c.

#include <climits>
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
  float screen;  // the Metropolis screen's margin over temp
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

// ln u as the bitwise contract takes it (ops/rng.ln_f32).
__device__ __forceinline__ float exact_ln(float u) {
  return static_cast<float>(log(static_cast<double>(u)));
}

// The in-kernel draws are the uniform grid u = k 2^-23, k < 2^23: k.
__device__ __forceinline__ uint32_t grid_index(float u) {
  return __float2uint_rz(u * 8388608.0f);
}

// exact_ln of every grid value, ln_grid[k] = exact_ln(k 2^-23): the
// table that the Metropolis test reads where the screen leaves a move
// in doubt (made once per device, sa_search_ln_grid).
__global__ void sa_ln_grid(float* __restrict__ ln_grid) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  ln_grid[k] = exact_ln(static_cast<float>(k) * 0x1p-23f);
}

// ln u in float32 from the hardware's log2 (lg2.approx, -inf at u = 0):
// within sa_kernel.FAST_LN_ERR of exact_ln(u) on the uniform grid
// (tests/test_torch_accept_screen_card.py measures it).
__device__ __forceinline__ float fast_ln(float u) {
  float l2;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l2) : "f"(u));
  return __fmul_rn(l2, 0.693147180559945309f);
}

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The bucket of block x of a launch: the last one whose first block is
// <= x.
__device__ __forceinline__ const BucketDesc& block_bucket(
    const PlanDesc& plan, int x) {
  int bi = 0;
  for (int i = 1; i < plan.nb; ++i)
    if (x >= plan.b[i].first) bi = i;
  return plan.b[bi];
}

// Sum of an int over the G lanes of a chain, on every one of them.
template <int G>
__device__ __forceinline__ int lane_sum(int x, unsigned gmask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(gmask, x, off, G);
  return x;
}

// Drop the lowest set bits of m that precede this lane's first one: the
// lane's bits are those of rank = lane (mod G) among the chain's set
// bits, `before` of which lie in earlier words (G a power of two).
template <int G>
__device__ __forceinline__ uint32_t lane_first(uint32_t m, int lane,
                                               int before) {
  const int skip = (lane - before) & (G - 1);
#pragma unroll
  for (int s = 0; s < G - 1; ++s)
    if (s < skip) m &= m - 1;
  return m;
}

// Drop the G - 1 set bits after the lowest one, which this lane just
// took (m & (m - 1) is 0 once m is).
template <int G>
__device__ __forceinline__ uint32_t lane_next(uint32_t m) {
#pragma unroll
  for (int s = 0; s < G; ++s) m &= m - 1;
  return m;
}

// EW / QW: mask words of the entry's / the query's SSEs (1 for <= 32).
// SPLIT: grid z splits the restarts; the CTA writes its split's best
// score and first maximal chain to part[2 p], part[2 p + 1] and that
// chain's map to part_maps[p * n1r + i], p = (q * gridDim.x + x) *
// gridDim.z + z, for sa_split_reduce.
// G: lanes per chain (1, 2 or 4; G > 1 only unsplit).  blockDim =
// c_par x G; chain threadIdx.x / G runs on the G consecutive lanes of
// one warp.  Every lane keeps the chain's whole state in registers and
// updates it from the same values; lane 0 alone writes its map plane.
// The lanes share out a move's draws and its delta, and the initial
// score's and the LSOLN copy's loops, and sum by shuffles.
// ln_grid: sa_ln_grid's table (in-kernel draws); exact: a counter of
// the moves whose Metropolis test read it, one per warp-move, or null
// (the loop's acceptance).
template <int EW, int QW, bool SPLIT, int G>
__global__ void __launch_bounds__(128 * G, G > 1 ? 10 / G : SPLIT ? 10 : 8)
    sa_plan_kernel(
    const __grid_constant__ PlanDesc plan,
    const int8_t* __restrict__ qtypes, const uint8_t* __restrict__ qtab,
    const float* __restrict__ qdmat, const int* __restrict__ n1s, int n1r,
    uint32_t seed, const int* __restrict__ tags,
    const float* __restrict__ uniforms, int ecols, int r_seq, int lorder,
    int lsoln, SAParams p, int* __restrict__ out_scores,
    int* __restrict__ out_maps, int* __restrict__ part,
    int8_t* __restrict__ part_maps, const float* __restrict__ ln_grid,
    unsigned long long* __restrict__ exact) {
  static_assert(G == 1 || ((G == 2 || G == 4) && !SPLIT),
                "lanes per chain: 1, or 2 or 4 unsplit");
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int c = tid / G;  // the chain
  const int g = tid % G;  // its lane
  const int C = T / G;    // chains
  // the chain's lanes in its warp
  [[maybe_unused]] const unsigned gmask = G == 1 ? 1u
                                : ((1u << G) - 1u) << ((tid & 31) & -G);

  const BucketDesc& B = block_bucket(plan, blockIdx.x);
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
    for (int t = tid; t < n1r * n1r / 4; t += T) {
      const float4 v = qd4[t];
      sq2[2 * t] = __floats2bfloat162_rn(v.x, v.y);
      sq2[2 * t + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    for (int t = tid; t < d2 * d2 / 4; t += T) {
      const float4 v = ed4[t];
      se2[2 * t] = __floats2bfloat162_rn(v.x, v.y);
      se2[2 * t + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
    const uint4* qc16 = reinterpret_cast<const uint4*>(qtab + qoff);
    const uint4* ec16 = reinterpret_cast<const uint4*>(B.tab + eoff);
    for (int t = tid; t < n1r * n1r / 16; t += T)
      reinterpret_cast<uint4*>(s_qc)[t] = qc16[t];
    for (int t = tid; t < d2 * d2 / 16; t += T)
      reinterpret_cast<uint4*>(s_ec)[t] = ec16[t];
    for (int t = tid; t < n1r; t += T) s_qt[t] = qtypes[q * n1r + t];
  }
  const int n2 = B.n2[e];
  // per-type masks of the entry's SSEs j < n2
  for (int t = tid; t < NTYPES * EW; t += T) {
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
  if (lsoln)  // lane g keeps the rows i = g (mod G) of the best map
    for (int i = g; i < n1r; i += G) s_best[i * C] = -1;

  // this CTA's restarts: all of them, or split z's share
  const int r_per = SPLIT ? r_seq / static_cast<int>(gridDim.z) : r_seq;
  const int r_first = SPLIT ? static_cast<int>(blockIdx.z) * r_per : 0;
  for (int r = r_first; r < r_first + r_per; ++r) {
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
    // a move's draws, slots base .. base + 2, into (move, candidate,
    // acceptance; a supplied stream's acceptance slot carries ln u); with
    // lanes, lane g draws slot base + min(g, 2) (G = 2: slot base + g,
    // and both slot base + 2) and the lanes trade them
    auto draw_move = [&](int base, float& um, float& uc, float& ua) {
      if constexpr (G == 1) {
        um = draw(base);
        uc = draw(base + 1);
        ua = draw(base + 2);
      } else if constexpr (G == 2) {
        const float v = draw(base + g);
        ua = draw(base + 2);
        um = __shfl_sync(gmask, v, 0, G);
        uc = __shfl_sync(gmask, v, 1, G);
      } else {
        const float v = draw(base + min(g, 2));
        um = __shfl_sync(gmask, v, 0, G);
        uc = __shfl_sync(gmask, v, 1, G);
        ua = __shfl_sync(gmask, v, 2, G);
      }
    };

    if constexpr (G > 1) __syncwarp(gmask);  // the last restart's reads
    if (g == 0)
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
          if (g == 0) s_map[i * C] = static_cast<int8_t>(found);
          set_bit(used, found);
          set_bit(mapped, i);
          cursor = found + 1;
        } else {
          stopped = true;
        }
      }
    }

    if constexpr (G > 1) __syncwarp(gmask);  // lane 0's map

    // initial score: integer sum over mapped pairs i < k (lanes: of the
    // i of rank = g (mod G) among the mapped SSEs, summed over the lanes)
    int score = 0;
    [[maybe_unused]] int seen = 0;  // mapped SSEs in the words before wi
    for (int wi = 0; wi < QW; ++wi) {
      uint32_t mi = word(mapped, wi);
      if constexpr (G > 1) {
        const int nw = __popc(mi);
        mi = lane_first<G>(mi, g, seen);
        seen += nw;
      }
      while (mi) {
        const int i = 32 * wi + __ffs(mi) - 1;
        mi = lane_next<G>(mi);
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
    if constexpr (G > 1) score = lane_sum<G>(score, gmask);
    if (score > maxscore) {
      maxscore = score;
      if (lsoln)
        for (int i = g; i < n1; i += G) s_best[i * C] = s_map[i * C];
    }

    float temp = p.temp0;
    float nx_move = 0.0f, nx_cand = 0.0f, nx_acc = 0.0f;
    if (p.maxiter > 0) draw_move(n1r, nx_move, nx_cand, nx_acc);
    for (int it = 0; it < p.maxiter; ++it) {
      const float u_move = nx_move, u_cand = nx_cand, u_acc = nx_acc;
      if (it + 1 < p.maxiter)  // move it+1's draws, off the chain
        draw_move(n1r + 3 * (it + 1), nx_move, nx_cand, nx_acc);
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

      // incremental delta over the mapped query SSEs k != ssei (lanes:
      // of the k of rank = g (mod G) among them, summed over the lanes)
      int delta = 0;
      [[maybe_unused]] int before = 0;  // such k in the words before w
      for (int w = 0; w < QW; ++w) {
        uint32_t m = word(mapped, w);
        if ((ssei >> 5) == w) m &= ~(1u << (ssei & 31));
        if constexpr (G > 1) {
          const int nw = __popc(m);
          m = lane_first<G>(m, g, before);
          before += nw;
        }
        while (m) {
          const int k = 32 * w + __ffs(m) - 1;
          m = lane_next<G>(m);
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

      if constexpr (G > 1) delta = lane_sum<G>(delta, gmask);

      // max tracking before acceptance
      const int newscore = score + delta;
      if (newscore > maxscore) {
        maxscore = newscore;
        if (lsoln)
          for (int k = g; k < n1; k += G)
            s_best[k * C] = k == ssei ? static_cast<int8_t>(newj) : s_map[k * C];
      }

      // log-domain Metropolis acceptance, delta > temp * ln u.  Drawn
      // in the kernel, fast_ln decides where temp * fast_ln(u) lies
      // farther than temp * p.screen from delta (sa_kernel.SCREEN_MARGIN:
      // the same decision as exact_ln's; a NaN margin leaves every move
      // in doubt); else exact_ln does, read from ln_grid (computed here
      // in double precision it would add registers to every move), in
      // one branch for the warp (a chain's lanes agree), which its
      // lowest lane counts
      const float fdelta = static_cast<float>(delta);
      bool accept;
      if (ur != nullptr) {
        accept = fdelta > __fmul_rn(temp, u_acc);  // the slot holds ln u
      } else {
        const float prod = __fmul_rn(temp, fast_ln(u_acc));
        const float margin = __fmul_rn(temp, p.screen);
        accept = fdelta > __fadd_rn(prod, margin);
        const bool near = !accept && !(fdelta < __fsub_rn(prod, margin));
        const unsigned active = __activemask();
        if (__any_sync(active, near)) {
          if (near)
            accept = fdelta >
                     __fmul_rn(temp, __ldg(ln_grid + grid_index(u_acc)));
          if (exact != nullptr && (tid & 31) == __ffs(active) - 1)
            atomicAdd(exact, 1ull);
        }
      }
      if (accept) {
        score = newscore;
        if (g == 0) s_map[ssei * C] = static_cast<int8_t>(newj);
        if (oldj >= 0) clear_bit(used, oldj);
        if (newj >= 0) {
          set_bit(used, newj);
          set_bit(mapped, ssei);
        } else {
          clear_bit(mapped, ssei);
        }
        if constexpr (G > 1) __syncwarp(gmask);  // lane 0's map
      }
      temp = __fmul_rn(temp, p.alpha);
    }
  }

  // per-entry (per-split) max over chains; the lowest-index maximal
  // chain wins
  const size_t prow =
      (static_cast<size_t>(q) * gridDim.x + blockIdx.x) * gridDim.z +
      blockIdx.z;
  if (g == 0) s_red[c] = maxscore;
  __syncthreads();
  if (tid == 0) {
    int best = s_red[0], winner = 0;
    for (int t = 1; t < C; ++t) {
      if (s_red[t] > best) {
        best = s_red[t];
        winner = t;
      }
    }
    s_red[C] = best;
    s_red[C + 1] = winner;
    if (SPLIT) {
      part[2 * prow] = best;
      part[2 * prow + 1] = winner;
    } else {
      out_scores[row] = best;
    }
  }
  __syncthreads();
  if (lsoln) {
    const int8_t* wbest =
        reinterpret_cast<const int8_t*>(smem + L.best) + s_red[C + 1];
    for (int i = tid; i < n1r; i += T) {
      if (SPLIT)
        part_maps[prow * n1r + i] = wbest[i * C];
      else
        out_maps[row * n1r + i] = wbest[i * C];
    }
  }
}

// The result of each (entry, query) of a split launch from its S
// splits' (best, winner) pairs and maps (sa_plan_kernel<EW, QW, true>):
// the largest best score; of the splits that reach it, the one with the
// lowest winner, then the lowest split, whose map is the entry's.  One
// warp per (entry, query), on the split launch's grid x and y: lane l
// keeps the first best of splits l, l + 32, ..., then the warp reduces
// on the same order (score down, winner up, split up).
__global__ void __launch_bounds__(32) sa_split_reduce(
    const __grid_constant__ PlanDesc plan, int ecols, int n1r, int splits,
    const int* __restrict__ part, const int8_t* __restrict__ part_maps,
    int* __restrict__ out_scores, int* __restrict__ out_maps) {
  const BucketDesc& B = block_bucket(plan, blockIdx.x);
  const size_t row = static_cast<size_t>(blockIdx.y) * ecols + B.out +
                     (blockIdx.x - B.first);
  const size_t p0 =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * splits;
  const int lane = threadIdx.x;
  int best = INT_MIN, winner = INT_MAX, pick = INT_MAX;
  for (int z = lane; z < splits; z += 32) {
    const int s = part[2 * (p0 + z)], w = part[2 * (p0 + z) + 1];
    if (s > best || (s == best && w < winner)) {
      best = s;
      winner = w;
      pick = z;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int s = __shfl_down_sync(~0u, best, off);
    const int w = __shfl_down_sync(~0u, winner, off);
    const int z = __shfl_down_sync(~0u, pick, off);
    if (s > best || (s == best && (w < winner || (w == winner && z < pick)))) {
      best = s;
      winner = w;
      pick = z;
    }
  }
  if (lane == 0) out_scores[row] = best;
  if (out_maps != nullptr) {
    const int8_t* m = part_maps + (p0 + __shfl_sync(~0u, pick, 0)) * n1r;
    for (int i = lane; i < n1r; i += 32) out_maps[row * n1r + i] = m[i];
  }
}

using KernelFn = void (*)(PlanDesc, const int8_t*, const uint8_t*,
                          const float*, const int*, int, uint32_t,
                          const int*, const float*, int, int, int, int,
                          SAParams, int*, int*, int*, int8_t*,
                          const float*, unsigned long long*);

// The instantiation for a launch class whose widest bucket is d2max.
template <bool SPLIT, int G>
KernelFn kernel_for(int d2max, int n1r) {
  if (d2max <= 32)
    return n1r <= 32 ? sa_plan_kernel<1, 1, SPLIT, G>
                     : sa_plan_kernel<1, 4, SPLIT, G>;
  return n1r <= 32 ? sa_plan_kernel<4, 1, SPLIT, G>
                   : sa_plan_kernel<4, 4, SPLIT, G>;
}

// ... split or unsplit at `lanes` lanes per chain; nullptr where there
// is no such instantiation (lanes not 1, 2 or 4, or lanes > 1 split).
KernelFn kernel_for(int d2max, int n1r, bool split, int lanes) {
  if (split) return lanes == 1 ? kernel_for<true, 1>(d2max, n1r) : nullptr;
  switch (lanes) {
    case 1: return kernel_for<false, 1>(d2max, n1r);
    case 2: return kernel_for<false, 2>(d2max, n1r);
    case 4: return kernel_for<false, 4>(d2max, n1r);
    default: return nullptr;
  }
}

const KernelFn ALL_KERNELS[] = {
    sa_plan_kernel<1, 1, false, 1>, sa_plan_kernel<1, 4, false, 1>,
    sa_plan_kernel<4, 1, false, 1>, sa_plan_kernel<4, 4, false, 1>,
    sa_plan_kernel<1, 1, true, 1>,  sa_plan_kernel<1, 4, true, 1>,
    sa_plan_kernel<4, 1, true, 1>,  sa_plan_kernel<4, 4, true, 1>,
    sa_plan_kernel<1, 1, false, 2>, sa_plan_kernel<1, 4, false, 2>,
    sa_plan_kernel<4, 1, false, 2>, sa_plan_kernel<4, 4, false, 2>,
    sa_plan_kernel<1, 1, false, 4>, sa_plan_kernel<1, 4, false, 4>,
    sa_plan_kernel<4, 1, false, 4>, sa_plan_kernel<4, 4, false, 4>};

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

// CTAs of c_par x lanes threads per SM for a launch class whose widest
// bucket is d2max (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into
// *blocks, and the kernel's registers per thread and local (spill)
// bytes into *regs and *local, for the unsplit instantiation at `lanes`
// lanes per chain or (split != 0, lanes 1) the split one.  Returns the
// cudaError_t.
int sa_search_occupancy(int d2max, int n1r, int c_par, int lsoln, int split,
                        int lanes, int* blocks, int* regs, int* local) {
  const KernelFn fn = kernel_for(d2max, n1r, split != 0, lanes);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, c_par * lanes,
      sa_search_smem_bytes(n1r, d2max, c_par, lsoln)));
}

// Launches one launch class of a plan on `stream`: grid (the buckets'
// entries, K, splits), c_par x lanes threads (lanes per chain: 1, or 2
// or 4 unsplit), shared memory for the widest bucket d2max; with
// splits > 1 (a power of two dividing r_seq) the split instantiation,
// then sa_split_reduce on the same stream.
// Returns the cudaError_t of the launches (0 = success).
// sa_search_prepare must have run on the device first.  `uniforms`
// (supplied stream) or `tags` (in-kernel threefry from seed, tags and
// the buckets' file-order indices): exactly one is non-null.  Scores go
// to out_scores[q * ecols + column], maps (may be null when lsoln == 0)
// to out_maps[(q * ecols + column) * n1r + i].  A split launch's
// scratch: `part` int32[K * entries * splits * 2] and, under lsoln,
// `part_maps` int8[K * entries * splits * n1r] (both null unsplit).
// In-kernel draws screen the Metropolis test with margin `screen` over
// the temperature (sa_kernel.screens says where a margin holds; NaN
// screens nothing), read the exact log of a move left in doubt from
// `ln_grid` (sa_search_ln_grid's table) and add each warp-move that did
// to `exact`, a device counter, unless it is null.
int sa_search_launch(const PlanDesc* plan, int d2max, const int8_t* qtypes,
                     const uint8_t* qtab, const float* qdmat, const int* n1s,
                     int K, int n1r, uint32_t seed, const int* tags,
                     const float* uniforms, int ecols, int c_par, int r_seq,
                     int lorder, int lsoln, int maxiter, float temp0,
                     float alpha, float mxssed, float init_matchprob,
                     float eps, int maxscore_init, float screen,
                     const float* ln_grid, unsigned long long* exact,
                     int splits, int lanes, int* part, int8_t* part_maps,
                     int* out_scores, int* out_maps, void* stream) {
  const SAParams p{maxiter, temp0, alpha, mxssed, init_matchprob, eps,
                   maxscore_init, screen};
  int nblocks = 0;
  for (int i = 0; i < plan->nb; ++i) nblocks += plan->b[i].E;
  const size_t smem = sa_search_smem_bytes(n1r, d2max, c_par, lsoln);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(K),
                  static_cast<unsigned>(splits));
  const KernelFn fn = kernel_for(d2max, n1r, splits > 1, lanes);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<grid, c_par * lanes, smem, st>>>(
      *plan, qtypes, qtab, qdmat, n1s, n1r, seed, tags, uniforms, ecols,
      r_seq, lorder, lsoln, p, out_scores, out_maps, part, part_maps, ln_grid,
      exact);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  sa_split_reduce<<<dim3(grid.x, grid.y), 32, 0, st>>>(
      *plan, ecols, n1r, splits, part, lsoln ? part_maps : nullptr,
      out_scores, lsoln ? out_maps : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Fills ln_grid[k] = float(log(double(k 2^-23))), k < 2^23 (float[2^23]
// on the current device), on `stream`.  Returns the cudaError_t.
int sa_search_ln_grid(float* ln_grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sa_ln_grid<<<(1 << 23) / 256, 256, 0, st>>>(ln_grid);
  return static_cast<int>(cudaGetLastError());
}

const char* sa_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
