// Fused beam-search expansion over a PQ-coded corpus: adjacency-prefix
// gather + code-row gather + lookup-and-accumulate in the query's table,
// CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/beam_score/kernel.py : beam_score_pq_tiles
//           (_beam_score_pq_body -> repro.quant.pq_score_codes).
//
// What bounds it on an H100: irregular gathers. Per lane it reads one
// adjacency prefix (k ids), k code rows of m bytes scattered over the codes,
// and k*m table entries (4 bytes each) at data-dependent addresses, and does
// one add per entry (two for cos): bytes, not flops, bound it.
//
// Design: one block per lane b, 8 warps; warp w scores candidates
// w, w + 8, ... Lane s of a warp takes subspaces s, s + 32, ...: it reads
// code byte s of the candidate's row (a 32-byte code row at m = 32 is one
// coalesced read) and then lut_a[b, s, code] (for cos also lut_b[s, code]);
// a shuffle tree adds the m terms. Any m works (m divides d upstream; m = 8
// leaves 24 lanes idle). cos normalises as pq_score_codes does:
// 1 - acc / (max(sqrt(qsq), 1e-12) * max(sqrt(vsq), 1e-12)).
//
// Why the tables are read from global memory (through L1/L2) and not staged
// in shared memory: a lane's lut_a is m * 256 * 4 = 32 KiB at m = 32, while
// one call reads only k * m = 2048 of its 8192 entries (k = 64). Staging
// would copy four times the entries the block uses and cap occupancy at a
// few blocks per SM; the whole table of a 1024-lane tile (32 MiB) stays
// resident in the 50 MB L2 across the beam loop, which reads it every
// iteration.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CENTROIDS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
beam_score_pq_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ nbrs,
                     const int* __restrict__ u, const float* __restrict__ lut_a,
                     const float* __restrict__ lut_b, const float* __restrict__ qsq,
                     int n, int mq, int m, int k, int metric, int* __restrict__ ids_out,
                     float* __restrict__ dist_out, int* __restrict__ key_out) {
  const int b = blockIdx.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int uid = u[b];
  const bool urow = uid >= 0 && uid < n;   // an id outside [0, n) reads as padding
  const float* la = lut_a + (long long)b * mq * CENTROIDS;
  for (int j = warp; j < k; j += WARPS) {
    int id = urow ? nbrs[(long long)uid * m + j] : -1;
    if (id >= n) id = -1;
    float acc = 0.f, vsq = 0.f;
    if (id >= 0) {
      const uint8_t* row = codes + (long long)id * mq;
      for (int s = lane; s < mq; s += 32) {
        const int c = row[s];
        acc += la[s * CENTROIDS + c];
        if (metric == 2) vsq += lut_b[s * CENTROIDS + c];
      }
    }
    acc = warp_sum(acc);
    vsq = warp_sum(vsq);
    if (lane == 0) {
      float dist;
      if (id < 0) {
        dist = INFINITY;
      } else if (metric == 2) {
        const float qn = fmaxf(sqrtf(qsq[b]), 1e-12f);
        const float vn = fmaxf(sqrtf(vsq), 1e-12f);
        dist = 1.f - acc / (qn * vn);
      } else {
        dist = acc;   // l2: summed clamped partial squares; ip: summed -dots
      }
      const int bits = __float_as_int(dist);
      const long long o = (long long)b * k + j;
      ids_out[o] = id;
      dist_out[o] = dist;
      key_out[o] = bits >= 0 ? bits : bits ^ 0x7fffffff;
    }
  }
}

}  // namespace

// ids/dists/keys (b, k) for frontier ids u (b,) over adjacency nbrs (n, m)
// and PQ codes (n, mq) uint8, scored with lut_a (b, mq, 256), lut_b
// (mq, 256) and qsq (b,) f32. metric: 0 l2, 1 ip, 2 cos. k <= m. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int beam_score_pq(const uint8_t* codes, const int* nbrs, const int* u,
                             const float* lut_a, const float* lut_b, const float* qsq,
                             int n, int mq, int m, int b, int k, int metric, int* ids,
                             float* dists, int* keys, cudaStream_t stream) {
  if (k < 1 || k > m || mq < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  beam_score_pq_kernel<<<b, THREADS, 0, stream>>>(codes, nbrs, u, lut_a, lut_b, qsq, n, mq,
                                                  m, k, metric, ids, dists, keys);
  return (int)cudaGetLastError();
}
