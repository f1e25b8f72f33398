// Fused neighbour gather + candidate Gram + RNG keep/redirect scan
// (RNN-Descent Alg. 4 core), CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/rng_prune/kernel.py : rng_prune_tiles
//           (_rng_prune_body -> _prune_scan), and rng_prune_int8_tiles
//           (_rng_prune_int8_body: the same over int8 code rows).
//
// What bounds it on an H100: the Gram, 2*R*M*M*d flops in f32 outside the
// tensor cores (67 TFLOP/s), against R*M*d*bytes of gathered rows
// (3.35 TB/s): at M = d = 128 that is ~64 flops per gathered byte (256 for
// int8 code rows), so the f32 SIMT rate bounds it, not memory.
//
// Design: one block per vertex row, 256 threads.
//  * The block reads x by candidate id itself (the reference gathers the
//    (R, M, d) block outside the kernel; at n = 1M that block is 64 GiB), in
//    d-chunks of 32 staged transposed in shared memory (conflict-free: the
//    row stride is MT + 1 words).
//  * int8 variant (T = int8_t): the block reads code rows by id and decodes
//    each element in registers as __fadd_rn(__fmul_rn(c, scale[j]), zero[j]):
//    multiply, then add, two roundings, exactly the plain version's
//    codes.float() * scale + zero, so the decode never contracts to an FMA.
//    scale/zero (d floats each) sit in shared memory. Every metric is
//    supported, as for f32 (the Pallas int8 body is L2-only).
//  * Each thread keeps an (MT/16) x (MT/16) register micro-tile of the
//    MT x MT Gram (rows ty + 16 r, columns tx + 16 s: every shared read is a
//    broadcast or a unit-stride row), accumulated in f32 whatever x's type
//    (bf16 is upcast on load). Squared norms accumulate beside it.
//  * The epilogue forms the metric's pair distance exactly as batched_gram
//    does (l2: max(|a|^2 + |b|^2 - 2ab, 0); ip: -ab; cos: 1 - ab / (|a||b|)
//    with the 1e-12 clamp) into shared memory; invalid ids give +inf.
//  * The serial scan over i runs in one warp: lane l owns candidates
//    j = l + 32 q and keeps their keep bits in a register; "first failing j"
//    is a __ballot_sync + __ffs per q. No block barrier inside the scan.
//  * Shared memory ~83 KiB at MT = 128 (+ 2 d floats for int8): two blocks
//    per SM, so one block's scan overlaps the other's Gram.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int DC = 32;  // d-chunk staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int MT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (MT * MT + DC * (MT + 1) + MT /*sq*/ + MT /*dist*/ +
                          MT /*red_d*/) +
         sizeof(int) * (MT /*ids*/ + MT /*red_w*/) + 2 * MT /*old, keep*/;
}

template <typename T>
constexpr bool kCoded = std::is_same<T, int8_t>::value;

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 2)
rng_prune_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ zero, const int* __restrict__ ids,
                 const float* __restrict__ dists, const uint8_t* __restrict__ flags,
                 int n, int d, int m, int metric, uint8_t* __restrict__ keep_out,
                 int* __restrict__ redw_out, float* __restrict__ redd_out) {
  constexpr int R = MT / 16;
  constexpr int LD = MT + 1;
  constexpr int Q = MT / 32;
  extern __shared__ float smem[];
  const int aux = kCoded<T> ? d : 0;     // int8: scale and zero, d floats each
  float* s_scale = smem;
  float* s_zero = smem + aux;
  float* pair = smem + 2 * aux;          // MT * MT
  float* chunk = pair + MT * MT;         // DC * LD, transposed: chunk[c * LD + j]
  float* sq = chunk + DC * LD;           // MT
  float* s_dist = sq + MT;               // MT
  float* s_redd = s_dist + MT;           // MT
  int* s_id = reinterpret_cast<int*>(s_redd + MT);  // MT
  int* s_redw = s_id + MT;               // MT
  uint8_t* s_old = reinterpret_cast<uint8_t*>(s_redw + MT);  // MT
  uint8_t* s_keep = s_old + MT;          // MT

  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * m;
  for (int j = t; j < MT; j += THREADS) {
    int id = -1;
    float dist = INFINITY;
    uint8_t old = 1;
    if (j < m) {
      id = ids[base + j];
      dist = dists[base + j];
      old = flags[base + j] == 0;
    }
    s_id[j] = (id >= 0 && id < n) ? id : -1;  // an id outside [0, n) reads as padding
    s_dist[j] = dist;
    s_old[j] = old;
    sq[j] = 0.f;
  }
  for (int i = t; i < aux; i += THREADS) {
    s_scale[i] = scale[i];
    s_zero[i] = zero[i];
  }
  __syncthreads();

  const int tx = t % 16, ty = t / 16;
  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < R; ++s) acc[r][s] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DC) {
    // gather: a warp reads 32 consecutive elements of one candidate row
    for (int idx = t; idx < MT * DC; idx += THREADS) {
      const int j = idx / DC, c = idx % DC;
      const int id = s_id[j];
      float v = 0.f;
      if (id >= 0 && d0 + c < d) {
        const T e = x[(long long)id * d + d0 + c];
        if constexpr (kCoded<T>)
          v = __fadd_rn(__fmul_rn(static_cast<float>(e), s_scale[d0 + c]), s_zero[d0 + c]);
        else
          v = to_f32(e);
      }
      chunk[c * LD + j] = v;
    }
    __syncthreads();
    if (t < MT) {
      float s2 = sq[t];
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float v = chunk[c * LD + t];
        s2 = fmaf(v, v, s2);
      }
      sq[t] = s2;
    }
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      float a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = chunk[c * LD + ty + 16 * r];
        b[r] = chunk[c * LD + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
    }
    __syncthreads();
  }

  // epilogue: metric pair distances into shared memory
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int j = tx + 16 * s;
      const float g = acc[r][s];
      float p;
      if (s_id[i] < 0 || s_id[j] < 0) {
        p = INFINITY;
      } else if (metric == 0) {
        p = fmaxf(sq[i] + sq[j] - 2.f * g, 0.f);
      } else if (metric == 1) {
        p = -g;
      } else {
        const float ni = fmaxf(sqrtf(sq[i]), 1e-12f);
        const float nj = fmaxf(sqrtf(sq[j]), 1e-12f);
        p = 1.f - g / (ni * nj);
      }
      pair[i * MT + j] = p;
    }
  }
  __syncthreads();

  // serial keep/redirect scan in warp 0 (keep[j >= i] is still 0, so the
  // j < i constraint is implicit; padded slots never redirect)
  if (t < 32) {
    const int lane = t;
    unsigned keepbits = 0;  // bit q: keep[lane + 32 q]
    bool oldj[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) oldj[q] = s_old[lane + 32 * q];
    for (int i = 0; i < m; ++i) {
      const int idi = s_id[i];
      const float di = s_dist[i];
      const bool oldi = s_old[i];
      int first = MT;
      if (idi >= 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int j = lane + 32 * q;
          const bool fail = ((keepbits >> q) & 1u) && !(oldi && oldj[q]) &&
                            pair[i * MT + j] <= di;
          const unsigned bal = __ballot_sync(0xffffffffu, fail);
          if (bal != 0u && first == MT) first = 32 * q + __ffs(bal) - 1;
        }
      }
      const bool kept = idi >= 0 && first == MT;
      if (kept && lane == (i & 31)) keepbits |= 1u << (i >> 5);
      if (lane == 0) {
        s_keep[i] = kept;
        s_redw[i] = first < MT ? s_id[first] : -1;
        s_redd[i] = first < MT ? pair[i * MT + first] : INFINITY;
      }
    }
  }
  __syncthreads();
  for (int j = t; j < m; j += THREADS) {
    keep_out[base + j] = s_keep[j];
    redw_out[base + j] = s_redw[j];
    redd_out[base + j] = s_redd[j];
  }
}

template <typename T, int MT>
cudaError_t launch(const void* x, const float* scale, const float* zero, const int* ids,
                   const float* dists, const uint8_t* flags, int n, int d, int rows,
                   int m, int metric, uint8_t* keep, int* red_w, float* red_d,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>() + (kCoded<T> ? 2 * sizeof(float) * (size_t)d : 0);
  cudaError_t err = cudaFuncSetAttribute(rng_prune_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  rng_prune_kernel<T, MT><<<rows, THREADS, smem, stream>>>(
      static_cast<const T*>(x), scale, zero, ids, dists, flags, n, d, m, metric, keep,
      red_w, red_d);
  return cudaGetLastError();
}

// The paper's capacity M = 128 is the only tile: a smaller m pads with
// invalid slots, at the same results.
constexpr int TILE_M = 128;

}  // namespace

// keep/red_w/red_d (rows, m) for candidate lists ids/dists/flags (rows, m)
// over corpus x (n, d), f32 (x_bf16 = 0) or bf16 (x_bf16 = 1).
// metric: 0 l2, 1 ip, 2 cos. m <= 128. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int rng_prune(const void* x, const int* ids, const float* dists,
                         const uint8_t* flags, int n, int d, int rows, int m,
                         int metric, int x_bf16, uint8_t* keep, int* red_w,
                         float* red_d, cudaStream_t stream) {
  if (m < 1 || m > TILE_M || d < 1 || rows < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      x_bf16 ? launch<__nv_bfloat16, TILE_M>(x, nullptr, nullptr, ids, dists, flags, n, d,
                                             rows, m, metric, keep, red_w, red_d, stream)
             : launch<float, TILE_M>(x, nullptr, nullptr, ids, dists, flags, n, d, rows, m,
                                     metric, keep, red_w, red_d, stream);
  return (int)err;
}

// The same over an int8 corpus: codes (n, d) int8 decoded with scale/zero
// (d,) f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int rng_prune_int8(const int8_t* codes, const float* scale, const float* zero,
                              const int* ids, const float* dists, const uint8_t* flags,
                              int n, int d, int rows, int m, int metric, uint8_t* keep,
                              int* red_w, float* red_d, cudaStream_t stream) {
  if (m < 1 || m > TILE_M || d < 1 || rows < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch<int8_t, TILE_M>(codes, scale, zero, ids, dists, flags, n, d, rows, m,
                                     metric, keep, red_w, red_d, stream);
}
