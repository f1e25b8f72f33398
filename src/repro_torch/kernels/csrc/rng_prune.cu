// Fused neighbour gather + candidate Gram + RNG keep/redirect scan
// (RNN-Descent Alg. 4 core), CUDA C++ for sm_90a: rows of up to 128
// candidates (the build's), f32, bf16 or int8 corpora. The kernel and its
// design are in rng_prune.cuh.
//
// Replaces: src/repro/kernels/rng_prune/kernel.py : rng_prune_tiles
//           (_rng_prune_body -> _prune_scan), and rng_prune_int8_tiles
//           (_rng_prune_int8_body: the same over int8 code rows).
#include "rng_prune.cuh"

// keep/red_w/red_d (rows, m) for candidate lists ids/dists/flags (rows, m)
// over corpus x (n, d), f32 (x_bf16 = 0) or bf16 (x_bf16 = 1).
// metric: 0 l2, 1 ip, 2 cos. m <= 128 (wider rows: rng_prune_wide.cu).
// counter: two ints of device memory (the rows each pass has handed out),
// zeroed on `stream` before the kernel. Launches on `stream`, allocates
// nothing, returns the first error.
extern "C" int rng_prune(const void* x, const int* ids, const float* dists,
                         const uint8_t* flags, int n, int d, int rows, int m,
                         int metric, int x_bf16, int* counter, uint8_t* keep, int* red_w,
                         float* red_d, cudaStream_t stream) {
  if (m < 1 || m > 32 * NB_BUILD || d < 1 || rows < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      x_bf16 ? launch<__nv_bfloat16, NB_BUILD>(1, x, nullptr, nullptr, ids, dists, flags, n,
                                               d, rows, m, metric, counter, keep, red_w,
                                               red_d, stream)
             : launch<float, NB_BUILD>(0, x, nullptr, nullptr, ids, dists, flags, n, d, rows,
                                       m, metric, counter, keep, red_w, red_d, stream);
  return (int)err;
}

// The same over an int8 corpus: codes (n, d) int8 decoded with scale/zero
// (d,) f32, m <= 128; counter as above. Launches on `stream`, allocates
// nothing, returns the first error.
extern "C" int rng_prune_int8(const int8_t* codes, const float* scale, const float* zero,
                              const int* ids, const float* dists, const uint8_t* flags,
                              int n, int d, int rows, int m, int metric, int* counter,
                              uint8_t* keep, int* red_w, float* red_d, cudaStream_t stream) {
  if (m < 1 || m > 32 * NB_BUILD || d < 1 || rows < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch<int8_t, NB_BUILD>(2, codes, scale, zero, ids, dists, flags, n, d, rows,
                                       m, metric, counter, keep, red_w, red_d, stream);
}

// The launch rng_prune makes for `rows` rows of m candidates over a corpus
// of width d (launch_shape.cuh's out[8]).
extern "C" int rng_prune_launch_shape(int d, int rows, int m, int x_bf16, int* out) {
  if (m < 1 || m > 32 * NB_BUILD || d < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  kshape::Shape s;
  const cudaError_t err = x_bf16 ? shape_of<__nv_bfloat16, NB_BUILD>(d, rows, 1, s)
                                 : shape_of<float, NB_BUILD>(d, rows, 0, s);
  return err != cudaSuccess ? (int)err : kshape::write(s, out);
}

// The launch rng_prune_int8 makes (launch_shape.cuh's out[8]).
extern "C" int rng_prune_int8_launch_shape(int d, int rows, int m, int* out) {
  if (m < 1 || m > 32 * NB_BUILD || d < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  kshape::Shape s;
  const cudaError_t err = shape_of<int8_t, NB_BUILD>(d, rows, 2, s);
  return err != cudaSuccess ? (int)err : kshape::write(s, out);
}

// Instances 0 f32, 1 bf16, 2 int8 (launch_shape.cuh's out[7]).
extern "C" int rng_prune_func_attrs(int instance, int dyn_smem, int* out) {
  const size_t smem = (size_t)dyn_smem;
  switch (instance) {
    case 0: return (int)attrs_of<float, NB_BUILD>(smem, out);
    case 1: return (int)attrs_of<__nv_bfloat16, NB_BUILD>(smem, out);
    case 2: return (int)attrs_of<int8_t, NB_BUILD>(smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
