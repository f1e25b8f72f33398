// Pairwise squared-L2 distance tile max(|a|^2 + |b|^2 - 2 a b^T, 0),
// CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/pairwise_l2/kernel.py : pairwise_l2_tiles
//           (_pairwise_l2_body).
//
// What bounds it on an H100: 2*na*nb*d flops in f32 outside the tensor cores
// (67 TFLOP/s) against (na*d + nb*d + na*nb)*4 bytes (3.35 TB/s); at d = 128
// the flops bound it by ~4x. No TF32: tensor cores come in a later change.
//
// Design: the classic shared-memory-tiled SIMT product. A 256-thread block
// owns a 128 x 128 output tile and walks d in steps of 16: both operand
// tiles are staged transposed in shared memory (k-major, rows padded to 132
// words so 16-byte reads stay aligned), and each thread accumulates an
// 8 x 8 register micro-tile in f32 (rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns likewise from tx, so every 16-byte shared read is
// conflict-free and every output row segment is stored with consecutive
// 16-byte writes). Squared norms of the block's a and b rows accumulate from
// the same staged tiles; the epilogue adds them and clamps at 0. bf16
// inputs are upcast on load.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, LDS = 132, THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
pairwise_l2_kernel(const T* __restrict__ a, const T* __restrict__ b, int na, int nb,
                   int d, int vec_store, float* __restrict__ out) {
  __shared__ __align__(16) float As[BK][LDS];
  __shared__ __align__(16) float Bs[BK][LDS];
  __shared__ float an[BM], bn[BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // t < 128: |a_{row0 + t}|^2, else |b_{col0 + t - 128}|^2

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int p = 0; p < BM * BK / THREADS; ++p) {
      const int idx = t + p * THREADS;
      const int r = idx / BK, c = idx % BK, gc = k0 + c;
      const int ra = row0 + r, rb = col0 + r;
      As[c][r] = (ra < na && gc < d) ? to_f32(a[(long long)ra * d + gc]) : 0.f;
      Bs[c][r] = (rb < nb && gc < d) ? to_f32(b[(long long)rb * d + gc]) : 0.f;
    }
    __syncthreads();
    {
      const float* src = t < BM ? &As[0][t] : &Bs[0][t - BM];
#pragma unroll
      for (int c = 0; c < BK; ++c) nrm = fmaf(src[c * LDS], src[c * LDS], nrm);
    }
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[c][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[c][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[c][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < BM) an[t] = nrm; else bn[t - BM] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int r = row0 + lr;
    if (r >= na) continue;
    const float ai = an[lr];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = h * 64 + tx * 4;
      const int c = col0 + lc;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = fmaxf(ai + bn[lc + j] - 2.f * acc[i][4 * h + j], 0.f);
      float* o = out + (long long)r * nb + c;
      if (vec_store && c + 4 <= nb) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < nb) o[j] = v[j];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, int na, int nb, int d, float* out,
                   cudaStream_t stream) {
  const dim3 grid((nb + BN - 1) / BN, (na + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int vec_store = nb % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  pairwise_l2_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), na, nb, d, vec_store, out);
  return cudaGetLastError();
}

}  // namespace

// out (na, nb) f32 = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0) for a (na, d),
// b (nb, d), both f32 (in_bf16 = 0) or both bf16 (in_bf16 = 1). na <= 65535 *
// 128. Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pairwise_l2(const void* a, const void* b, int na, int nb, int d,
                           int in_bf16, float* out, cudaStream_t stream) {
  if (na < 1 || nb < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = in_bf16 ? launch<__nv_bfloat16>(a, b, na, nb, d, out, stream)
                            : launch<float>(a, b, na, nb, d, out, stream);
  return (int)err;
}
