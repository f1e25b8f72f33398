// The fused RNG prune of rng_prune.cu for candidate rows of up to 256
// (NSG-style prunes C = 132 candidates a row), f32 or bf16 corpora: the
// kernel of rng_prune.cuh at NB = 8 blocks of 32 candidates. A source of
// its own, so that nvcc builds it beside rng_prune.cu.
//
// Replaces: src/repro/kernels/rng_prune/kernel.py : rng_prune_tiles
//           (_rng_prune_body -> _prune_scan) at rows wider than 128.
#include "rng_prune.cuh"

// rng_prune (rng_prune.cu) for m <= 256; the same arguments.
extern "C" int rng_prune_wide(const void* x, const int* ids, const float* dists,
                              const uint8_t* flags, int n, int d, int rows, int m,
                              int metric, int x_bf16, int* counter, uint8_t* keep, int* red_w,
                              float* red_d, cudaStream_t stream) {
  if (m < 1 || m > 32 * NB_WIDE || d < 1 || rows < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      x_bf16 ? launch<__nv_bfloat16, NB_WIDE>(1, x, nullptr, nullptr, ids, dists, flags, n,
                                              d, rows, m, metric, counter, keep, red_w, red_d,
                                              stream)
             : launch<float, NB_WIDE>(0, x, nullptr, nullptr, ids, dists, flags, n, d, rows,
                                      m, metric, counter, keep, red_w, red_d, stream);
  return (int)err;
}

// The launch rng_prune_wide makes (launch_shape.cuh's out[8]).
extern "C" int rng_prune_wide_launch_shape(int d, int rows, int m, int x_bf16, int* out) {
  if (m < 1 || m > 32 * NB_WIDE || d < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  kshape::Shape s;
  const cudaError_t err = x_bf16 ? shape_of<__nv_bfloat16, NB_WIDE>(d, rows, 1, s)
                                 : shape_of<float, NB_WIDE>(d, rows, 0, s);
  return err != cudaSuccess ? (int)err : kshape::write(s, out);
}

// Instances 0 f32, 1 bf16 (launch_shape.cuh's out[7]).
extern "C" int rng_prune_wide_func_attrs(int instance, int dyn_smem, int* out) {
  const size_t smem = (size_t)dyn_smem;
  switch (instance) {
    case 0: return (int)attrs_of<float, NB_WIDE>(smem, out);
    case 1: return (int)attrs_of<__nv_bfloat16, NB_WIDE>(smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
