// The per-warp prefix pass shared by the beam kernels (beam_score_kernel
// and beam_score_int8_kernel in beam_score.cu, beam_score_pq_kernel in
// beam_score_pq.cu): a warp reads its lane's adjacency prefix in one
// coalesced pass, keeps the ids in [0, n) and compacts them in slot order
// into a per-warp list in shared memory (one __ballot_sync per 32 slots,
// position __popc(mask & lanemask_lt)), writing every other slot below k as
// padding right there. The scoring that follows reads only the list, so its
// work follows the lane's valid candidates, not k.
#pragma once

#include <cuda_runtime.h>

namespace beam {

constexpr int LANES = 4;          // lanes (warps) per block
constexpr int WIN = 128;          // prefix slots a warp compacts at a time
constexpr unsigned FULL = 0xffffffffu;

// One output slot: id, distance and the distance's order-preserving key.
__device__ __forceinline__ void put(int* ids_out, float* dist_out, int* key_out, long long o,
                                    int id, float dist) {
  const int bits = __float_as_int(dist);
  ids_out[o] = id;
  dist_out[o] = dist;
  key_out[o] = bits >= 0 ? bits : bits ^ 0x7fffffff;
}

// Slots base + lane + 32 i (i < WIN / 32) of the lane's prefix, -1 past k or
// for a frontier id outside [0, n) (urow false). Loads only; all in flight
// together.
__device__ __forceinline__ void load_window(const int* nbrs, long long row, bool urow,
                                            int k, int base, int lane, int (&id)[WIN / 32]) {
#pragma unroll
  for (int i = 0; i < WIN / 32; ++i) {
    const int j = base + 32 * i + lane;
    id[i] = urow && j < k ? __ldg(nbrs + row + j) : -1;
  }
}

// Compacts the window's ids in [0, n), in slot order, into s_id / s_slot and
// (pad) writes every other slot below k as padding. Returns the count; the
// list is visible to the whole warp on return.
__device__ __forceinline__ int compact_window(const int (&id)[WIN / 32], int n, int k,
                                              int base, int lane, int* s_id, int* s_slot,
                                              int* ids_out, float* dist_out, int* key_out,
                                              long long obase, bool pad = true) {
  const unsigned below = (1u << lane) - 1u;   // lanemask_lt
  int v = 0;
#pragma unroll
  for (int i = 0; i < WIN / 32; ++i) {
    const int j = base + 32 * i + lane;
    const bool ok = id[i] >= 0 && id[i] < n;
    const unsigned mask = __ballot_sync(FULL, ok);
    if (ok) {
      const int pos = v + __popc(mask & below);
      s_id[pos] = id[i];
      s_slot[pos] = j;
    } else if (pad && j < k) {
      put(ids_out, dist_out, key_out, obase + j, -1, INFINITY);
    }
    v += __popc(mask);
  }
  __syncwarp();
  return v;
}

}  // namespace beam
