// Fused beam-search expansion step: adjacency-prefix gather + vector gather +
// score against the query, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/beam_score/kernel.py : beam_score_tiles
//           (_beam_score_body).
//
// What bounds it on an H100: irregular row gathers. Per lane it reads one
// adjacency prefix (k ids) and k corpus rows of d elements scattered over x,
// and does 2 flops per element read (bytes, not flops, bound it:
// (B*k*d*bytes + B*k*4 + B*d*4) / 3.35 TB/s).
//
// Design: one block per lane, 8 warps; warp w scores candidates w, w+8, ...
// The query sits in shared memory. Each candidate row is read by one warp
// with 16-byte loads on consecutive addresses (a 128-d f32 row is one load
// per lane), and the d-reduction is a warp shuffle tree. The score mirrors
// score_block: l2 = max(|q|^2 + |v|^2 - 2 q.v, 0), ip = -q.v,
// cos = 1 - q.v / (max(|q|, 1e-12) max(|v|, 1e-12)); bf16 rows are upcast on
// load and every sum is f32. Padded slots give id -1 and +inf; the int32
// key is the port's order-preserving key of the f32 distance, so the
// distance decodes from it exactly.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
cudaError_t launch(const void* x, const int* nbrs, const int* u, const float* q,
                   int n, int d, int m, int b, int k, int metric, int* ids,
                   float* dists, int* keys, cudaStream_t stream) {
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
      ? launch<__nv_bfloat16>(x, nbrs, u, queries, n, d, m, b, k, metric, ids, dists, keys, stream)
      : launch<float>(x, nbrs, u, queries, n, d, m, b, k, metric, ids, dists, keys, stream);
  return (int)err;
}
