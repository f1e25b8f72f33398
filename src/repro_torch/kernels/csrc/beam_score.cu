// Fused beam-search expansion step: adjacency-prefix gather + vector gather +
// score against the query, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/beam_score/kernel.py : beam_score_tiles
//           (_beam_score_body) with beam_score_kernel (f32 and bf16 rows), and
//           beam_score_int8_tiles (_beam_score_int8_body: the same over int8
//           code rows) with beam_score_int8_kernel.
//
// What bounds it on an H100: irregular row gathers. Per lane it reads one
// adjacency prefix (k ids) and the rows of its valid candidates scattered
// over the corpus, and does 2 flops per element read (bytes, not flops,
// bound it: (v*d*bytes + B*k*4 + B*d*4) / 3.35 TB/s for v valid candidates).
// At B = 1024, d = 128 that is a few us of bytes, so what the card waits for
// is the chain of dependent latencies: frontier id -> prefix -> rows.
//
// Both kernels work on each lane's valid candidates v (about 17 of k = 64
// on random frontier ids of the 1M graph, about 47 on the search's own
// frontier), not on k:
//  * A warp reads its lane's prefix in one coalesced pass (lane l: slots l,
//    l + 32, ...), finds the ids in [0, n) with one __ballot_sync per 32
//    slots and compacts them, in slot order, into a per-warp list in shared
//    memory at __popc(mask & lanemask_lt) (beam_prefix.cuh, shared with the
//    PQ kernel). Padding slots are written right there and never loaded; a
//    frontier id outside [0, n) reads no prefix (and no query) and writes a
//    lane of padding.
//  * A group of G threads scores one candidate, each thread owning whole
//    16-byte pieces of the row (read with ld.global.nc.v4) and holding the
//    query (and, for int8, scale and zero) of those pieces in registers from
//    the start: no shared memory for them, no __syncthreads, no dynamic
//    shared memory, so a launch sets no attribute. |q|^2 is reduced once per
//    lane in log2(G) shfl_xor steps.
//  * All row loads of a few rounds of candidates are issued before any
//    arithmetic, so a warp waits about one memory latency per few rounds,
//    not one per candidate.
//  * The score mirrors score_block: l2 = max(|q|^2 + |v|^2 - 2 q.v, 0),
//    ip = -q.v, cos = 1 - q.v / (max(|v|, 1e-12) max(|q|, 1e-12)); every sum
//    is f32. Padded slots give id -1 and +inf; the int32 key is the port's
//    order-preserving key of the f32 distance, so the distance decodes from
//    it exactly.
//
// f32/bf16 (beam_score_kernel<T, G, PPT>): a row has pieces = d * sizeof(T)
// / 16 pieces (32 for f32 at d = 128, 16 for bf16; 24 / 12 at d = 96; 240 /
// 120 at d = 960, GIST1M's width). G = min(32, pow2ceil(pieces)) and each
// thread owns PPT = pieces / G pieces (rounded up to 1, 2, 4 or 8: pieces
// t, t + G, ... so each load instruction of a warp is coalesced), a template
// parameter, so d = 96, 128 and 960 in f32 and in bf16 all take a vector
// instance; bf16 pieces upcast by a shift (exact). Rows of 5 to 256 pieces
// (f32 d = 20..1024, bf16 d = 40..1024) take a vector instance.
//  * LANE_WARPS = 4 warps a lane, one lane a 128-thread block: every warp
//    compacts the prefix (the first writes the padding) and takes every
//    fourth round of candidates. The kernel's time is its heaviest lanes'
//    (a hub row holds 64 valid candidates), and one warp per lane left the
//    SM with 8 warps: 2x slower at d = 128 (below).
//  * ROWS_ROUNDS<PPT> rounds in flight per warp: 4 rows of one piece a
//    thread (16 registers), 2 of two, 1 of four or eight.
//  * The rounds' 2R sums (R = ROWS_ROUNDS<PPT>, 2R <= G) reduce together:
//    each shfl_xor step sends half of the values a thread carries and keeps
//    the other half, 2R + log2(G / 2R) shuffles in all (10 at R = 4,
//    G = 32) instead of 2R log2(G) (40), in a dependent chain of log2(G) + 1
//    steps.
//  * __launch_bounds__(128, 8) at PPT = 1 (at most 64 registers, so 8
//    lanes an SM and all 1024 lanes of a tile at once), (128, 4) at
//    PPT = 2, 4, (128, 2) at PPT = 8; 48-102 registers, no spills.
//  * Any other d (rows of at most 4 pieces or not whole pieces, d above
//    1024, or an unaligned x) takes the generic instance (G = 0): the same
//    prefix pass, then each warp on one candidate at a time with scalar
//    loads.
//
// int8 (beam_score_int8_kernel<G>): a warp per lane, LANES lanes a block;
// G = pow2ceil(d / 16) threads a candidate (8 at d = 128, so a warp covers
// 4 candidates per instruction), thread t reading code bytes 16t .. 16t +
// 15; up to ROUNDS = 8 rounds (32 candidates at d = 128) in flight. Each
// code decodes as __fadd_rn(__fmul_rn(c, scale), zero) (multiply, then
// add, two roundings: the plain version's codes.float() * scale + zero, so
// no FMA contraction), then scores as an f32 row; log2(G) shfl_xor steps a
// round. Any other d (not a multiple of 16, above 512, or an unaligned
// codes pointer) takes the generic instance (G = 0).
//
// Where the time goes (B = 1024, k = 64, l2; NVIDIA H100 80GB HBM3, 700.00 W
// power limit; scripts/beam_ab.py, the kernel's own time in a torch.profiler
// trace).
//  * f32 rows on the 1M f32 graph: 7.4 us a call on random frontier ids
//    (15.5 before this design), 6.8 us on the search's own frontier (its
//    rows stay in L2 between calls), 9.3 us with L2 flushed before each
//    call; 9.6-9.7 ms over the 856 calls of the 1M search (15.2-15.6). A
//    copy that reads no prefix takes 1.8 us (launch, frontier ids, padding
//    writes), one that loads no rows 3.5 us, so the rows cost about 3.9 us.
//    One warp per lane took 15.1 us, two 10.3, eight 8.1; without the joint
//    reduction 8.8-9.2.
//  * bf16 rows: 5.3 us a call (15.5 before), 6.8 flushed.
//  * f32 rows at d = 960: 34.2 us on random ids (42.0 before; bound about
//    21 us of bytes), 73.3 us on the search's frontier (80.0; bound about
//    60 us).
//  * int8 on the 1M int8 graph: 7.65 us a call on random frontier ids,
//    7.2 us on the search's own frontier, 8.8 us with L2 flushed before each
//    call; a copy that reads no prefix takes 2.5 us (the launch, the
//    frontier ids, the query slices and the padding writes), one that loads
//    no rows 5.7 us. So the time follows the chain frontier id -> prefix ->
//    rows, one memory latency each, not v. Launch shape: LANES = 4 under
//    __launch_bounds__(128, 4) (at most 128 registers; 111-119 used, no
//    spills); LANES = 2 took the same time, LANES = 8 spilled, and 64 rows
//    in flight (ROUNDS = 16) made the search's beam time worse (9.5 against
//    7.4 ms).
// TMA and wgmma do not fit: the rows are 128- to 3840-byte pieces at
// data-dependent addresses (a TMA copy per row would cost more to issue
// than the row), and a lane's work is a handful of dot products, not a tile
// product.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "beam_prefix.cuh"
#include "launch_shape.cuh"

namespace {

using beam::FULL;
using beam::LANES;
using beam::put;
using beam::WIN;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float score(int metric, float qq, float vv, float qv) {
  if (metric == 0) return fmaxf(qq + vv - 2.f * qv, 0.f);
  if (metric == 1) return -qv;
  return 1.f - qv / (fmaxf(sqrtf(vv), 1e-12f) * fmaxf(sqrtf(qq), 1e-12f));
}

// --------------------------------------------------------------- f32, bf16
template <typename T>
constexpr int ELEMS = 16 / sizeof(T);   // elements in a 16-byte piece of a row

// Rounds of candidates whose rows a warp keeps in flight when each thread
// owns PPT pieces of a row (4 registers a piece).
template <int PPT>
constexpr int ROWS_ROUNDS = PPT == 1 ? 4 : PPT == 2 ? 2 : 1;
// Warps a lane's candidates are dealt to: a block is one lane.
constexpr int LANE_WARPS = 4;

// vv += e e and qv += e q over the elements e of one 16-byte piece, q its
// query elements; bf16 -> f32 is exact (the bf16 bits are the f32's high half).
template <typename T>
__device__ __forceinline__ void acc_piece(const uint4& raw, const float* q, float& vv,
                                          float& qv) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if constexpr (sizeof(T) == 4) {
      const float e = __uint_as_float(w[h]);
      vv = fmaf(e, e, vv);
      qv = fmaf(e, q[h], qv);
    } else {
      const float lo = __uint_as_float(w[h] << 16), hi = __uint_as_float(w[h] & 0xffff0000u);
      vv = fmaf(lo, lo, vv);
      qv = fmaf(lo, q[2 * h], qv);
      vv = fmaf(hi, hi, vv);
      qv = fmaf(hi, q[2 * h + 1], qv);
    }
  }
}

__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// Scores this warp's share of the v compacted candidates: a round is P =
// 32 / G candidates, G threads each, thread t of a group owning pieces t,
// t + G, ... (PPT of them) of a row, whose query elements it holds in q;
// warp w of the lane's LANE_WARPS takes rounds w, w + LANE_WARPS, ...
template <typename T, int G, int PPT>
__device__ __forceinline__ void score_rows(const uint4* x, int pieces, int metric, int v,
                                           const int* s_id, const int* s_slot, int w,
                                           int lane, const float (&q)[PPT * ELEMS<T>],
                                           float qq, int* ids_out, float* dist_out,
                                           int* key_out, long long obase) {
  constexpr int P = 32 / G, R = ROWS_ROUNDS<PPT>, W = LANE_WARPS;
  const int g = lane / G, t = lane % G;
  for (int m0 = w; m0 * P < v; m0 += R * W) {
    uint4 raw[R][PPT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ci = (m0 + r * W) * P + g;
      const uint4* row = x + (long long)(ci < v ? s_id[ci] : 0) * pieces;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int p = t + G * j;
        raw[r][j] = ci < v && p < pieces ? __ldg(row + p) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float a[2 * R];                    // vv, qv of each round
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[2 * r] = a[2 * r + 1] = 0.f;
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        acc_piece<T>(raw[r][j], q + ELEMS<T> * j, a[2 * r], a[2 * r + 1]);
    }
    // All rounds reduce at once: each shfl_xor step sends half of the values
    // a thread still carries and keeps the other half, so thread t ends with
    // value (t / S) % N summed over its group, in 2R - 1 + log2(S) shuffles
    // (and one more brings each round's qv beside its vv), not 2R log2(G).
    constexpr int N = 2 * R, S = G / N;
    static_assert(S >= 1, "a group must be at least as wide as the sums it reduces");
#pragma unroll
    for (int h = N / 2, o = G / 2; h >= 1; h /= 2, o /= 2) {
      const bool up = t & o;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float keep = up ? a[h + i] : a[i], send = up ? a[i] : a[h + i];
        a[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
#pragma unroll
    for (int o = S / 2; o > 0; o /= 2) a[0] += __shfl_xor_sync(FULL, a[0], o);
    const float qv = __shfl_down_sync(FULL, a[0], S);   // the round's qv, S threads up
    const int idx = (t / S) % N, ci = (m0 + idx / 2 * W) * P + g;
    if (idx % 2 == 0 && t % S == 0 && ci < v)
      put(ids_out, dist_out, key_out, obase + s_slot[ci], s_id[ci],
          score(metric, qq, a[0], qv));
  }
}

// The generic instance: the whole warp on one candidate at a time (this
// warp's share: candidates w, w + LANE_WARPS, ...).
template <typename T>
__device__ __forceinline__ void score_rows_generic(const T* x, const float* qrow, int d,
                                                   int metric, int v, const int* s_id,
                                                   const int* s_slot, int w, int lane,
                                                   float qq, int* ids_out, float* dist_out,
                                                   int* key_out, long long obase) {
  for (int ci = w; ci < v; ci += LANE_WARPS) {
    const T* row = x + (long long)s_id[ci] * d;
    float vv = 0.f, qv = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float e = load_elem(row + i);
      vv = fmaf(e, e, vv);
      qv = fmaf(e, __ldg(qrow + i), qv);
    }
    vv = warp_sum(vv);
    qv = warp_sum(qv);
    if (lane == 0)
      put(ids_out, dist_out, key_out, obase + s_slot[ci], s_id[ci], score(metric, qq, vv, qv));
  }
}

template <typename T, int G, int PPT>
__global__ void __launch_bounds__(LANE_WARPS * 32, PPT == 1 ? 8 : PPT >= 8 ? 2 : 4)
beam_score_kernel(const T* __restrict__ x, const int* __restrict__ nbrs,
                  const int* __restrict__ u, const float* __restrict__ queries, int n, int d,
                  int m, int k, int metric, int* __restrict__ ids_out,
                  float* __restrict__ dist_out, int* __restrict__ key_out) {
  constexpr int E = ELEMS<T>;
  __shared__ int s_id[LANE_WARPS][WIN];
  __shared__ int s_slot[LANE_WARPS][WIN];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, lb = blockIdx.x;
  const int uid = __ldg(u + lb);
  const bool urow = uid >= 0 && uid < n;
  const long long row = (long long)(urow ? uid : 0) * m, obase = (long long)lb * k;
  const float* qrow = queries + (long long)lb * d;
  int id[WIN / 32];
  beam::load_window(nbrs, row, urow, k, 0, lane, id);

  // the query slice while the prefix is in flight (a retired lane reads none)
  float q[G > 0 ? PPT * E : 1], qq = 0.f;
  if constexpr (G > 0) {
    const int t = lane % G;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
#pragma unroll
      for (int h = 0; h < E; ++h) {
        const int i = E * (t + G * j) + h;
        q[E * j + h] = urow && i < d ? __ldg(qrow + i) : 0.f;
        qq = fmaf(q[E * j + h], q[E * j + h], qq);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) qq += __shfl_xor_sync(FULL, qq, o);
  } else if (urow) {                   // warp-uniform
    for (int i = lane; i < d; i += 32) {
      const float e = __ldg(qrow + i);
      qq = fmaf(e, e, qq);
    }
    qq = warp_sum(qq);
  }

  for (int base = 0; base < k; base += WIN) {
    if (base > 0) beam::load_window(nbrs, row, urow, k, base, lane, id);
    // every warp of the lane compacts the window; the first writes its padding
    const int v = beam::compact_window(id, n, k, base, lane, s_id[w], s_slot[w], ids_out,
                                       dist_out, key_out, obase, w == 0);
    if constexpr (G > 0)
      score_rows<T, G, PPT>(reinterpret_cast<const uint4*>(x), d / E, metric, v, s_id[w],
                            s_slot[w], w, lane, q, qq, ids_out, dist_out, key_out, obase);
    else
      score_rows_generic(x, qrow, d, metric, v, s_id[w], s_slot[w], w, lane, qq, ids_out,
                         dist_out, key_out, obase);
    __syncwarp();                      // the list is read before the next window
  }
}

using RowsLaunch = cudaError_t (*)(const void*, const int*, const int*, const float*, int, int,
                                   int, int, int, int, int*, float*, int*, cudaStream_t);

template <typename T, int G, int PPT>
cudaError_t launch_rows(const void* x, const int* nbrs, const int* u, const float* q, int n,
                        int d, int m, int b, int k, int metric, int* ids, float* dists,
                        int* keys, cudaStream_t stream) {
  beam_score_kernel<T, G, PPT><<<b, LANE_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), nbrs, u, q, n, d, m, k, metric, ids, dists, keys);
  return cudaGetLastError();
}

// The rows instances by index (launch_shape.cuh's out[6]): f32 (G, PPT) =
// 0 (0, 1), 1 (8, 1), 2 (16, 1), 3 (32, 1), 4 (32, 2), 5 (32, 4), 6 (32, 8);
// bf16 7 (0, 1), 8 (8, 1), 9 (16, 1), 10 (32, 1), 11 (32, 2), 12 (32, 4).
// The int8 instances follow: INT8_BASE + 0..6, G = 0, 1, 2, 4, 8, 16, 32.
const RowsLaunch ROWS[] = {
    launch_rows<float, 0, 1>,          launch_rows<float, 8, 1>,
    launch_rows<float, 16, 1>,         launch_rows<float, 32, 1>,
    launch_rows<float, 32, 2>,         launch_rows<float, 32, 4>,
    launch_rows<float, 32, 8>,         launch_rows<__nv_bfloat16, 0, 1>,
    launch_rows<__nv_bfloat16, 8, 1>,  launch_rows<__nv_bfloat16, 16, 1>,
    launch_rows<__nv_bfloat16, 32, 1>, launch_rows<__nv_bfloat16, 32, 2>,
    launch_rows<__nv_bfloat16, 32, 4>};
constexpr int BF16_BASE = 7;
constexpr int INT8_BASE = 13;

// The instance for rows of d elements: G = min(32, pow2ceil(pieces))
// threads a candidate, each owning PPT = pieces / G (rounded up to 1, 2, 4
// or 8) pieces; the generic instance (G = 0) when a row is not whole 16-byte
// pieces or at most 4 of them, x is not 16-byte aligned, or d > 1024.
template <typename T>
int rows_index(int d, bool aligned) {
  constexpr int E = ELEMS<T>;
  constexpr int base = E == 4 ? 0 : BF16_BASE;
  const int pieces = d % E == 0 && d <= 1024 && aligned ? d / E : 0;
  if (pieces <= 4) return base;
  if (pieces <= 8) return base + 1;
  if (pieces <= 16) return base + 2;
  if (pieces <= 32) return base + 3;
  if (pieces <= 64) return base + 4;
  if constexpr (E == 4) {              // f32: up to 256 pieces
    if (pieces > 128) return base + 6;
  }
  return base + 5;
}

// The launch of the rows instance: a block (LANE_WARPS warps) per lane.
kshape::Shape rows_shape(int d, int b, int x_bf16, bool aligned) {
  kshape::Shape s;
  s.grid[0] = b;
  s.threads = LANE_WARPS * 32;
  s.instance = x_bf16 ? rows_index<__nv_bfloat16>(d, aligned) : rows_index<float>(d, aligned);
  return s;
}

// ------------------------------------------------------------------- int8
constexpr int ROUNDS = 8;         // rounds of candidates whose rows are in flight together
constexpr int SLICE = 16;         // code bytes (dimensions) a thread owns

__device__ __forceinline__ float decode(int c, float scale, float zero) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), scale), zero);
}

// Scores the v compacted candidates, G threads a candidate (G > 0), thread t
// of a group owning code bytes SLICE t .. SLICE t + 15 of each row.
template <int G>
__device__ __forceinline__ void score_grouped(const int8_t* codes, int d, int metric, int v,
                                              const int* s_id, const int* s_slot, int lane,
                                              const float (&q)[SLICE], const float (&sc)[SLICE],
                                              const float (&ze)[SLICE], float qq, int* ids_out,
                                              float* dist_out, int* key_out, long long obase) {
  constexpr int P = 32 / G;            // candidates per round
  const int g = lane / G, t = lane % G;
  const bool own = SLICE * t < d;
  for (int c0 = 0; c0 < v; c0 += ROUNDS * P) {
    uint4 raw[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int ci = c0 + r * P + g;
      raw[r] = make_uint4(0u, 0u, 0u, 0u);
      if (ci < v && own)
        raw[r] = __ldg(reinterpret_cast<const uint4*>(codes + (long long)s_id[ci] * d +
                                                      SLICE * t));
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      if (c0 + r * P < v) {            // warp-uniform
        const uint32_t w[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
        float vv = 0.f, qv = 0.f;
#pragma unroll
        for (int h = 0; h < SLICE; ++h) {
          const float e = decode(static_cast<int8_t>(w[h / 4] >> (8 * (h % 4))), sc[h], ze[h]);
          vv = fmaf(e, e, vv);
          qv = fmaf(e, q[h], qv);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
          vv += __shfl_xor_sync(FULL, vv, o);
          qv += __shfl_xor_sync(FULL, qv, o);
        }
        const int ci = c0 + r * P + g;
        if (t == 0 && ci < v)
          put(ids_out, dist_out, key_out, obase + s_slot[ci], s_id[ci],
              score(metric, qq, vv, qv));
      }
    }
  }
}

// The generic instance: the whole warp on one candidate at a time.
__device__ __forceinline__ void score_generic(const int8_t* codes, const float* scale,
                                              const float* zero, const float* qrow, int d,
                                              int metric, int v, const int* s_id,
                                              const int* s_slot, int lane, float qq,
                                              int* ids_out, float* dist_out, int* key_out,
                                              long long obase) {
  for (int ci = 0; ci < v; ++ci) {
    const int8_t* row = codes + (long long)s_id[ci] * d;
    float vv = 0.f, qv = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float e = decode(__ldg(row + i), __ldg(scale + i), __ldg(zero + i));
      vv = fmaf(e, e, vv);
      qv = fmaf(e, __ldg(qrow + i), qv);
    }
    vv = warp_sum(vv);
    qv = warp_sum(qv);
    if (lane == 0)
      put(ids_out, dist_out, key_out, obase + s_slot[ci], s_id[ci], score(metric, qq, vv, qv));
  }
}

template <int G>
__global__ void __launch_bounds__(LANES * 32, 4)
beam_score_int8_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scale,
                       const float* __restrict__ zero, const int* __restrict__ nbrs,
                       const int* __restrict__ u, const float* __restrict__ queries, int n,
                       int d, int m, int b, int k, int metric, int* __restrict__ ids_out,
                       float* __restrict__ dist_out, int* __restrict__ key_out) {
  __shared__ int s_id[LANES][WIN];
  __shared__ int s_slot[LANES][WIN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lb = blockIdx.x * LANES + warp;
  if (lb >= b) return;                 // a whole warp
  const int uid = __ldg(u + lb);
  const bool urow = uid >= 0 && uid < n;
  const long long row = (long long)(urow ? uid : 0) * m, obase = (long long)lb * k;
  const float* qrow = queries + (long long)lb * d;
  int id[WIN / 32];
  beam::load_window(nbrs, row, urow, k, 0, lane, id);

  // the query slice (and its scale and zero) while the prefix is in flight
  float q[SLICE], sc[SLICE], ze[SLICE], qq = 0.f;
  if constexpr (G > 0) {
    const int t = lane % G;
#pragma unroll
    for (int h = 0; h < SLICE; ++h) {
      const int i = SLICE * t + h;
      const bool own = i < d;
      q[h] = own ? __ldg(qrow + i) : 0.f;
      sc[h] = own ? __ldg(scale + i) : 0.f;   // a piece past d decodes to 0
      ze[h] = own ? __ldg(zero + i) : 0.f;
      qq = fmaf(q[h], q[h], qq);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) qq += __shfl_xor_sync(FULL, qq, o);
  } else {
    for (int i = lane; i < d; i += 32) {
      const float e = __ldg(qrow + i);
      qq = fmaf(e, e, qq);
    }
    qq = warp_sum(qq);
  }

  for (int base = 0; base < k; base += WIN) {
    if (base > 0) beam::load_window(nbrs, row, urow, k, base, lane, id);
    const int v = beam::compact_window(id, n, k, base, lane, s_id[warp], s_slot[warp],
                                       ids_out, dist_out, key_out, obase);
    if constexpr (G > 0)
      score_grouped<G>(codes, d, metric, v, s_id[warp], s_slot[warp], lane, q, sc, ze, qq,
                       ids_out, dist_out, key_out, obase);
    else
      score_generic(codes, scale, zero, qrow, d, metric, v, s_id[warp], s_slot[warp], lane,
                    qq, ids_out, dist_out, key_out, obase);
    __syncwarp();                      // the list is read before the next window
  }
}

template <int G>
cudaError_t launch_int8(const kshape::Shape& s, const int8_t* codes, const float* scale,
                        const float* zero, const int* nbrs, const int* u, const float* q,
                        int n, int d, int m, int b, int k, int metric, int* ids, float* dists,
                        int* keys, cudaStream_t stream) {
  beam_score_int8_kernel<G><<<s.dims(), s.threads, s.smem, stream>>>(
      codes, scale, zero, nbrs, u, q, n, d, m, b, k, metric, ids, dists, keys);
  return cudaGetLastError();
}

// The launch of the int8 instance: LANES lanes (warps) a block; G threads a
// candidate for rows of 16-byte pieces (at most 32 of them, 16-byte
// aligned), the generic instance otherwise.
kshape::Shape int8_shape(int d, int b, bool aligned) {
  const int pieces = d % SLICE == 0 && aligned ? d / SLICE : 0;
  const int g = pieces == 0 || pieces > 32 ? 0
                : pieces == 1              ? 1
                : pieces == 2              ? 2
                : pieces <= 4              ? 3
                : pieces <= 8              ? 4
                : pieces <= 16             ? 5
                                           : 6;
  kshape::Shape s;
  s.grid[0] = ((long long)b + LANES - 1) / LANES;
  s.threads = LANES * 32;
  s.instance = INT8_BASE + g;
  return s;
}

// kshape::attrs of instance i (f32 and bf16 rows, then int8).
int attrs_of(int i, int* out) {
  const int t = LANE_WARPS * 32, ti = LANES * 32;
  switch (i) {
    case 0: return (int)kshape::attrs(beam_score_kernel<float, 0, 1>, t, 0, out);
    case 1: return (int)kshape::attrs(beam_score_kernel<float, 8, 1>, t, 0, out);
    case 2: return (int)kshape::attrs(beam_score_kernel<float, 16, 1>, t, 0, out);
    case 3: return (int)kshape::attrs(beam_score_kernel<float, 32, 1>, t, 0, out);
    case 4: return (int)kshape::attrs(beam_score_kernel<float, 32, 2>, t, 0, out);
    case 5: return (int)kshape::attrs(beam_score_kernel<float, 32, 4>, t, 0, out);
    case 6: return (int)kshape::attrs(beam_score_kernel<float, 32, 8>, t, 0, out);
    case 7: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 0, 1>, t, 0, out);
    case 8: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 8, 1>, t, 0, out);
    case 9: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 16, 1>, t, 0, out);
    case 10: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 32, 1>, t, 0, out);
    case 11: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 32, 2>, t, 0, out);
    case 12: return (int)kshape::attrs(beam_score_kernel<__nv_bfloat16, 32, 4>, t, 0, out);
    case 13: return (int)kshape::attrs(beam_score_int8_kernel<0>, ti, 0, out);
    case 14: return (int)kshape::attrs(beam_score_int8_kernel<1>, ti, 0, out);
    case 15: return (int)kshape::attrs(beam_score_int8_kernel<2>, ti, 0, out);
    case 16: return (int)kshape::attrs(beam_score_int8_kernel<4>, ti, 0, out);
    case 17: return (int)kshape::attrs(beam_score_int8_kernel<8>, ti, 0, out);
    case 18: return (int)kshape::attrs(beam_score_int8_kernel<16>, ti, 0, out);
    case 19: return (int)kshape::attrs(beam_score_int8_kernel<32>, ti, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ids/dists/keys (b, k) for frontier ids u (b,) over adjacency nbrs (n, m)
// and corpus x (n, d), f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); queries (b, d)
// f32. metric: 0 l2, 1 ip, 2 cos. k <= m. The kernels take no attributes
// and no dynamic shared memory, so a launch sets nothing up. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int beam_score(const void* x, const int* nbrs, const int* u,
                          const float* queries, int n, int d, int m, int b, int k,
                          int metric, int x_bf16, int* ids, float* dists, int* keys,
                          cudaStream_t stream) {
  if (k < 1 || k > m || d < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const kshape::Shape s = rows_shape(d, b, x_bf16, reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return (int)ROWS[s.instance](x, nbrs, u, queries, n, d, m, b, k, metric, ids, dists, keys,
                               stream);
}

// The same over an int8 corpus: codes (n, d) int8 decoded with scale/zero
// (d,) f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int beam_score_int8(const int8_t* codes, const float* scale, const float* zero,
                               const int* nbrs, const int* u, const float* queries, int n,
                               int d, int m, int b, int k, int metric, int* ids,
                               float* dists, int* keys, cudaStream_t stream) {
  if (k < 1 || k > m || d < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  // 16-byte pieces need 16-byte rows, and a group of at most 32 threads
  const kshape::Shape s = int8_shape(d, b, reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  cudaError_t (*const fn[])(const kshape::Shape&, const int8_t*, const float*, const float*,
                            const int*, const int*, const float*, int, int, int, int, int,
                            int, int*, float*, int*, cudaStream_t) = {
      launch_int8<0>, launch_int8<1>, launch_int8<2>, launch_int8<4>,
      launch_int8<8>, launch_int8<16>, launch_int8<32>};
  return (int)fn[s.instance - INT8_BASE](s, codes, scale, zero, nbrs, u, queries, n, d, m, b,
                                         k, metric, ids, dists, keys, stream);
}

// The launch beam_score makes for b lanes over rows of width d, x 16-byte
// aligned or not (launch_shape.cuh's out[8]).
extern "C" int beam_score_launch_shape(int d, int b, int x_bf16, int x_aligned, int* out) {
  if (d < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return kshape::write(rows_shape(d, b, x_bf16, x_aligned != 0), out);
}

// The launch beam_score_int8 makes (launch_shape.cuh's out[8]).
extern "C" int beam_score_int8_launch_shape(int d, int b, int codes_aligned, int* out) {
  if (d < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return kshape::write(int8_shape(d, b, codes_aligned != 0), out);
}

// Instances 0-12 beam_score's (ROWS), 13-19 beam_score_int8's (G = 0, 1, 2,
// 4, 8, 16, 32).
extern "C" int beam_score_func_attrs(int instance, int dyn_smem, int* out) {
  return dyn_smem != 0 ? (int)cudaErrorInvalidValue : attrs_of(instance, out);
}
