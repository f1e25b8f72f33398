// The launch-shape and attribute queries every source exports, so that one
// computation sets a kernel's launch and the static analysis checks it.
//
// <entry>_launch_shape(problem..., int* out) writes the launch its entry
// point makes for that problem, from the same function the launcher calls:
//   out[0..2] grid x, y, z   out[3] threads a block   out[4] dynamic shared
//   bytes   out[5] 1 if the launcher raises the kernel's dynamic shared
//   limit above 48 KiB   out[6] the template instance (an index into the
//   source's <source>_func_attrs)   out[7] the blocks an SM a persistent
//   grid was sized by (0 for a grid that covers the problem).
// <source>_func_attrs(instance, dyn_smem, int* out) reads the instance's
// cudaFuncAttributes and occupancy at that dynamic shared size:
//   out[0] registers a thread   out[1] static shared bytes   out[2] local
//   (spill) bytes a thread   out[3] max threads a block   out[4] max dynamic
//   shared bytes   out[5] resident blocks an SM at its launch's threads and
//   dyn_smem   out[6] binary (SASS) version.
// Both return a cudaError_t as int.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace kshape {

constexpr int SHAPE_INTS = 8;
constexpr int ATTR_INTS = 7;

struct Shape {
  long long grid[3] = {1, 1, 1};
  int threads = 0;
  size_t smem = 0;
  int opt_in = 0;
  int instance = 0;
  int per_sm = 0;

  bool fits() const {
    return grid[0] >= 1 && grid[0] <= INT_MAX && grid[1] >= 1 && grid[1] <= 65535 &&
           grid[2] >= 1 && grid[2] <= 65535;
  }
  dim3 dims() const { return dim3((unsigned)grid[0], (unsigned)grid[1], (unsigned)grid[2]); }
};

inline int write(const Shape& s, int* out) {
  if (!s.fits()) return (int)cudaErrorInvalidValue;
  out[0] = (int)s.grid[0];
  out[1] = (int)s.grid[1];
  out[2] = (int)s.grid[2];
  out[3] = s.threads;
  out[4] = (int)s.smem;
  out[5] = s.opt_in;
  out[6] = s.instance;
  out[7] = s.per_sm;
  return (int)cudaSuccess;
}

template <typename F>
cudaError_t attrs(F* fn, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  out[5] = per_sm;
  out[6] = a.binaryVersion;
  return cudaSuccess;
}

}  // namespace kshape
