// FM second-order interaction 0.5 * sum_d[(sum_f e_fd)^2 - sum_f e_fd^2] per
// row of emb (B, F, D), CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/fm_interact/kernel.py : fm_interact_tiles
//           (_fm_body).
//
// What bounds it on an H100: bytes. Each element is read once and costs 3
// flops (add, multiply-add), so at DeepFM's serve_bulk shape (262,144 x 39 x
// 10 bf16, 204 MB) the 3.35 TB/s of HBM bound it at ~0.061 ms while the
// flops would take ~0.005 ms at 67 TFLOP/s.
//
// Design (simple first): a 256-thread block owns R = max(1, 256 / D)
// consecutive rows and gives each row TPR = 256 / R >= min(D, 256)
// threads. Thread j of a row walks its columns d = j, j + TPR, ... and, for
// each, loops over the F fields accumulating s = sum_f e and ss = sum_f e^2
// in f32 (bf16 is upcast on load), then adds s*s - ss to a register. The
// threads of a row read neighbouring columns of one field together, so a
// warp's loads fall on a few contiguous runs of the block's rows (which are
// contiguous in memory); L1 serves the reuse across fields. The row's
// partial sums meet in shared memory and one thread per row adds them in a
// fixed order, so the result does not depend on scheduling. No vector loads
// (any F, D and alignment); making it fast, e.g. 16-byte loads staged in
// shared memory or the embedding gather fused in, is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>

#include "launch_shape.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fm_interact_kernel(const T* __restrict__ emb, int b, int f, int d, int rows, int tpr,
                   float* __restrict__ out) {
  __shared__ float part[THREADS];
  const int t = threadIdx.x;
  const int slot = t / tpr, j0 = t - slot * tpr;
  const long long row = (long long)blockIdx.x * rows + slot;
  float acc = 0.f;
  if (slot < rows && row < b) {
    const T* e = emb + row * f * d;
    for (int j = j0; j < d; j += tpr) {
      float s = 0.f, ss = 0.f;
      for (int i = 0; i < f; ++i) {
        const float v = to_f32(e[(long long)i * d + j]);
        s += v;
        ss = fmaf(v, v, ss);
      }
      acc += s * s - ss;
    }
  }
  part[t] = acc;
  __syncthreads();
  if (t < rows) {
    const long long r = (long long)blockIdx.x * rows + t;
    if (r < b) {
      float sum = 0.f;
      for (int j = 0; j < tpr; ++j) sum += part[t * tpr + j];
      out[r] = 0.5f * sum;
    }
  }
}

// The launch for b rows of f x d: rows = THREADS / d rows a block (1 when
// d >= THREADS), THREADS / rows threads a row. Instances 0 f32, 1 bf16.
kshape::Shape rows_shape(int b, int d, int in_bf16, int& rows) {
  rows = d >= THREADS ? 1 : THREADS / d;
  kshape::Shape s;
  s.grid[0] = ((long long)b + rows - 1) / rows;
  s.threads = THREADS;
  s.instance = in_bf16 ? 1 : 0;
  return s;
}

template <typename T>
cudaError_t launch(const void* emb, int b, int f, int d, float* out, cudaStream_t stream) {
  int rows = 0;
  const kshape::Shape s = rows_shape(b, d, sizeof(T) == 2, rows);
  if (!s.fits()) return cudaErrorInvalidValue;
  const int tpr = THREADS / rows;
  fm_interact_kernel<T><<<s.dims(), s.threads, s.smem, stream>>>(
      static_cast<const T*>(emb), b, f, d, rows, tpr, out);
  return cudaGetLastError();
}

}  // namespace

// out (b,) f32 = the FM interaction of each row of emb (b, f, d), contiguous,
// f32 (in_bf16 = 0) or bf16 (in_bf16 = 1). Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int fm_interact(const void* emb, int b, int f, int d, int in_bf16, float* out,
                           cudaStream_t stream) {
  if (b < 1 || f < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = in_bf16 ? launch<__nv_bfloat16>(emb, b, f, d, out, stream)
                            : launch<float>(emb, b, f, d, out, stream);
  return (int)err;
}

// The launch fm_interact makes (launch_shape.cuh's out[8]).
extern "C" int fm_interact_launch_shape(int b, int f, int d, int in_bf16, int* out) {
  if (b < 1 || f < 1 || d < 1) return (int)cudaErrorInvalidValue;
  int rows = 0;
  return kshape::write(rows_shape(b, d, in_bf16, rows), out);
}

// Instances 0 f32, 1 bf16.
extern "C" int fm_interact_func_attrs(int instance, int dyn_smem, int* out) {
  if (dyn_smem != 0) return (int)cudaErrorInvalidValue;
  switch (instance) {
    case 0: return (int)kshape::attrs(fm_interact_kernel<float>, THREADS, 0, out);
    case 1: return (int)kshape::attrs(fm_interact_kernel<__nv_bfloat16>, THREADS, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
