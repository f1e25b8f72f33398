// Fused beam-search expansion step: adjacency-prefix gather + vector gather +
// score against the query, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/beam_score/kernel.py : beam_score_tiles
//           (_beam_score_body) with beam_score_kernel, and
//           beam_score_int8_tiles (_beam_score_int8_body: the same over int8
//           code rows) with beam_score_int8_kernel.
//
// What bounds it on an H100: irregular row gathers. Per lane it reads one
// adjacency prefix (k ids) and the rows of its valid candidates scattered
// over the corpus, and does 2 flops per element read (bytes, not flops,
// bound it: (v*d*bytes + B*k*4 + B*d*4) / 3.35 TB/s for v valid candidates).
// At B = 1024 that is about 1 us of bytes, so what the card actually waits
// for is the chain of dependent latencies: frontier id -> prefix -> rows.
//
// f32/bf16 (beam_score_kernel): one block per lane, 8 warps; warp w scores
// candidates w, w+8, ... The query sits in shared memory. Each candidate
// row is read by one warp with 16-byte loads on consecutive addresses (a
// 128-d f32 row is one load per lane), and the d-reduction is a warp shuffle
// tree. The score mirrors score_block: l2 = max(|q|^2 + |v|^2 - 2 q.v, 0),
// ip = -q.v, cos = 1 - q.v / (max(|q|, 1e-12) max(|v|, 1e-12)); bf16 rows
// are upcast on load and every sum is f32. Padded slots give id -1 and +inf;
// the int32 key is the port's order-preserving key of the f32 distance, so
// the distance decodes from it exactly.
//
// int8 (beam_score_int8_kernel): a warp per lane, LANES lanes per block, and
// the work follows the lane's valid candidates v (about 17 of k = 64 on
// random frontier ids of the 1M graph, about 47 on the search's own
// frontier), not k:
//  * The warp reads its prefix in one coalesced pass (lane l: slots l,
//    l + 32, ...), finds the ids in [0, n) with one __ballot_sync per 32
//    slots and compacts them, in slot order, into a per-warp list in shared
//    memory at __popc(mask & lanemask_lt) (beam_prefix.cuh, shared with the
//    PQ kernel). Padding slots are written right there and never loaded; a
//    frontier id outside [0, n) reads no prefix and writes a lane of
//    padding.
//  * A group of G = pow2ceil(d / 16) threads scores one candidate (8 at
//    d = 128, so a warp covers 32 / G = 4 candidates per instruction): thread
//    t of a group reads the row's 16-byte piece t with one ld.global.nc.v4,
//    and owns dimensions 16t .. 16t + 15, whose query, scale and zero it
//    holds in registers from the start (no shared memory for them, no
//    __syncthreads). A group reduces in log2(G) shfl_xor steps (3 at
//    d = 128); |q|^2 is reduced once per lane the same way.
//  * All row loads of up to ROUNDS rounds (32 candidates at d = 128) are
//    issued before any arithmetic, so a lane waits for about one memory
//    latency for its rows, not v / 8.
//  * Each code decodes as __fadd_rn(__fmul_rn(c, scale), zero) (multiply,
//    then add, two roundings: the plain version's codes.float() * scale +
//    zero, so no FMA contraction), then scores as an f32 row.
//  * Any other d (not a multiple of 16, above 512, or an unaligned codes
//    pointer) takes the generic instance (G = 0) of the same kernel: the same
//    prefix pass and compaction, then the whole warp on one candidate at a
//    time with byte loads.
// Where the time goes (B = 1024, k = 64, the 1M int8 graph; H100 80GB HBM3,
// 700 W, scripts/beam_ab.py): 7.65 us a call on random frontier ids (v about
// 17), 7.2 us on the search's own frontier (v about 47), 8.8 us with L2
// flushed before each call; a copy that reads no prefix takes 2.5 us (the
// launch, the frontier ids, the query slices and the padding writes), one
// that loads no rows 5.7 us. So the time follows the chain frontier id ->
// prefix -> rows, one memory latency each, not v. Launch shape: LANES = 4
// under __launch_bounds__(128, 4) (at most 128 registers; 111-119 used, no
// spills); LANES = 2 took the same time, LANES = 8 spilled, and 64 rows in
// flight (ROUNDS = 16) made the search's beam time worse (9.5 against 7.4
// ms).
// TMA and wgmma do not fit: the rows are 128-byte pieces at data-dependent
// addresses (a TMA copy per row would cost more to issue than the row), and
// a lane's work is a handful of dot products, not a tile product.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "beam_prefix.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16-byte packs: 4 f32 or 8 bf16 elements starting at element 4p / 8p
__device__ __forceinline__ void acc_pack(const float* row, const float* q, int p,
                                         float& vv, float& qv) {
  const float4 v = reinterpret_cast<const float4*>(row)[p];
  const float4 w = reinterpret_cast<const float4*>(q)[p];
  vv = fmaf(v.x, v.x, vv); qv = fmaf(v.x, w.x, qv);
  vv = fmaf(v.y, v.y, vv); qv = fmaf(v.y, w.y, qv);
  vv = fmaf(v.z, v.z, vv); qv = fmaf(v.z, w.z, qv);
  vv = fmaf(v.w, v.w, vv); qv = fmaf(v.w, w.w, qv);
}

__device__ __forceinline__ void acc_pack(const __nv_bfloat16* row, const float* q, int p,
                                         float& vv, float& qv) {
  const uint4 raw = reinterpret_cast<const uint4*>(row)[p];
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
    const float lo = __uint_as_float(words[h] << 16);
    const float hi = __uint_as_float(words[h] & 0xffff0000u);
    const float q0 = q[8 * p + 2 * h], q1 = q[8 * p + 2 * h + 1];
    vv = fmaf(lo, lo, vv); qv = fmaf(lo, q0, qv);
    vv = fmaf(hi, hi, vv); qv = fmaf(hi, q1, qv);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
beam_score_kernel(const T* __restrict__ x, const int* __restrict__ nbrs,
                  const int* __restrict__ u, const float* __restrict__ queries,
                  int n, int d, int m, int k, int metric, int vec,
                  int* __restrict__ ids_out, float* __restrict__ dist_out,
                  int* __restrict__ key_out) {
  extern __shared__ __align__(16) float s_q[];
  const int b = blockIdx.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int i = t; i < d; i += THREADS) s_q[i] = queries[(long long)b * d + i];
  __syncthreads();

  float qq = 0.f;
  for (int i = lane; i < d; i += 32) qq = fmaf(s_q[i], s_q[i], qq);
  qq = warp_sum(qq);

  const int uid = u[b];
  const bool urow = uid >= 0 && uid < n;   // an id outside [0, n) reads as padding
  constexpr int PACK = 16 / sizeof(T);
  const int npack = d / PACK;
#pragma unroll 2
  for (int j = warp; j < k; j += WARPS) {
    int id = urow ? nbrs[(long long)uid * m + j] : -1;
    if (id >= n) id = -1;
    float vv = 0.f, qv = 0.f;
    if (id >= 0) {
      const T* row = x + (long long)id * d;
      if (vec) {
        for (int p = lane; p < npack; p += 32) acc_pack(row, s_q, p, vv, qv);
      } else {
        for (int i = lane; i < d; i += 32) {
          const float v = to_f32(row[i]);
          vv = fmaf(v, v, vv);
          qv = fmaf(v, s_q[i], qv);
        }
      }
    }
    vv = warp_sum(vv);
    qv = warp_sum(qv);
    if (lane == 0) {
      float dist;
      if (id < 0) {
        dist = INFINITY;
      } else if (metric == 0) {
        dist = fmaxf(qq + vv - 2.f * qv, 0.f);
      } else if (metric == 1) {
        dist = -qv;
      } else {
        dist = 1.f - qv / (fmaxf(sqrtf(vv), 1e-12f) * fmaxf(sqrtf(qq), 1e-12f));
      }
      const int bits = __float_as_int(dist);
      const long long o = (long long)b * k + j;
      ids_out[o] = id;
      dist_out[o] = dist;
      key_out[o] = bits >= 0 ? bits : bits ^ 0x7fffffff;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int* nbrs, const int* u, const float* q, int n,
                   int d, int m, int b, int k, int metric, int* ids, float* dists, int* keys,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  cudaError_t err = cudaFuncSetAttribute(beam_score_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  beam_score_kernel<T><<<b, THREADS, smem, stream>>>(
      static_cast<const T*>(x), nbrs, u, q, n, d, m, k, metric, vec, ids, dists, keys);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- int8
using beam::FULL;
using beam::LANES;
using beam::put;
using beam::WIN;
constexpr int ROUNDS = 8;         // rounds of candidates whose rows are in flight together
constexpr int SLICE = 16;         // code bytes (dimensions) a thread owns

__device__ __forceinline__ float decode(int c, float scale, float zero) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), scale), zero);
}

__device__ __forceinline__ float score(int metric, float qq, float vv, float qv) {
  if (metric == 0) return fmaxf(qq + vv - 2.f * qv, 0.f);
  if (metric == 1) return -qv;
  return 1.f - qv / (fmaxf(sqrtf(vv), 1e-12f) * fmaxf(sqrtf(qq), 1e-12f));
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
cudaError_t launch_int8(const int8_t* codes, const float* scale, const float* zero,
                        const int* nbrs, const int* u, const float* q, int n, int d, int m,
                        int b, int k, int metric, int* ids, float* dists, int* keys,
                        cudaStream_t stream) {
  beam_score_int8_kernel<G><<<(b + LANES - 1) / LANES, LANES * 32, 0, stream>>>(
      codes, scale, zero, nbrs, u, q, n, d, m, b, k, metric, ids, dists, keys);
  return cudaGetLastError();
}

}  // namespace

// ids/dists/keys (b, k) for frontier ids u (b,) over adjacency nbrs (n, m)
// and corpus x (n, d), f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); queries (b, d)
// f32. metric: 0 l2, 1 ip, 2 cos. k <= m. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int beam_score(const void* x, const int* nbrs, const int* u,
                          const float* queries, int n, int d, int m, int b, int k,
                          int metric, int x_bf16, int* ids, float* dists, int* keys,
                          cudaStream_t stream) {
  if (k < 1 || k > m || d < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = x_bf16
      ? launch<__nv_bfloat16>(x, nbrs, u, queries, n, d, m, b, k, metric, ids, dists, keys,
                              stream)
      : launch<float>(x, nbrs, u, queries, n, d, m, b, k, metric, ids, dists, keys, stream);
  return (int)err;
}

// The same over an int8 corpus: codes (n, d) int8 decoded with scale/zero
// (d,) f32. The kernel takes no attributes and no dynamic shared memory, so
// a launch sets nothing up. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int beam_score_int8(const int8_t* codes, const float* scale, const float* zero,
                               const int* nbrs, const int* u, const float* queries, int n,
                               int d, int m, int b, int k, int metric, int* ids,
                               float* dists, int* keys, cudaStream_t stream) {
  if (k < 1 || k > m || d < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  // 16-byte pieces need 16-byte rows, and a group of at most 32 threads
  const int pieces = d % SLICE == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0
                         ? d / SLICE : 0;
  cudaError_t (*fn)(const int8_t*, const float*, const float*, const int*, const int*,
                    const float*, int, int, int, int, int, int, int*, float*, int*,
                    cudaStream_t) =
      pieces == 0 || pieces > 32 ? launch_int8<0>
      : pieces == 1              ? launch_int8<1>
      : pieces == 2              ? launch_int8<2>
      : pieces <= 4              ? launch_int8<4>
      : pieces <= 8              ? launch_int8<8>
      : pieces <= 16             ? launch_int8<16>
                                 : launch_int8<32>;
  return (int)fn(codes, scale, zero, nbrs, u, queries, n, d, m, b, k, metric, ids, dists,
                 keys, stream);
}
