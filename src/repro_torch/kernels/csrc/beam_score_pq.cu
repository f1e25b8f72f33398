// Fused beam-search expansion over a PQ-coded corpus: adjacency-prefix
// gather + code-row gather + lookup-and-accumulate in the query's table,
// CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/beam_score/kernel.py : beam_score_pq_tiles
//           (_beam_score_pq_body -> repro.quant.pq_score_codes).
//
// What bounds it on an H100: irregular gathers. Per lane it reads one
// adjacency prefix (k ids), the code rows of its v valid candidates (m bytes
// each) and v*m table entries (4 bytes each) at data-dependent addresses,
// and does one add per entry (two for cos): bytes, not flops, bound it, and
// at B = 1024 those bytes take about 1 us. What the card waits for is the
// chain of dependent latencies: frontier id -> prefix -> codes -> tables.
//
// Design: a warp per lane, LANES lanes per block; the work follows the
// lane's v valid candidates (about 18 of k = 64 on random frontier ids of
// the 1M graph, about 48 on the search's own frontier):
//  * The warp reads its prefix in one coalesced pass, finds the ids in
//    [0, n) with one __ballot_sync per 32 slots and compacts them in slot
//    order into a per-warp list in shared memory at
//    __popc(mask & lanemask_lt) (beam_prefix.cuh, shared with the int8
//    kernel). Padding slots are written right there and never loaded; a
//    frontier id outside [0, n) reads no prefix and writes a lane of
//    padding.
//  * A group of G = pow2ceil(m / 8) threads scores one candidate (4 at
//    m = 32, so a warp covers 32 / G = 8 candidates per instruction):
//    thread t reads the row's code bytes 8t .. 8t + 7 as one uint2 and then
//    issues their 8 table lookups lut_a[b, 8t + j, code_j] (for cos also
//    lut_b[8t + j, code_j]) at once, adds them in order and reduces over the
//    group in log2(G) shfl_xor steps.
//  * Over ROUNDS rounds (32 candidates at m = 32) every code load is issued
//    before any table load, and every table load before any add: the chain
//    is prefix -> codes -> tables, one latency each.
//  * A row length that is not a multiple of 8, or an unaligned codes
//    pointer, reads the codes byte by byte in the same structure; m > 256
//    (more than 8 codes a thread) takes the generic instance (G = 0): the
//    whole warp on one candidate, lane s on subspaces s, s + 32, ...
// cos normalises as pq_score_codes does:
// 1 - acc / (max(sqrt(qsq), 1e-12) * max(sqrt(vsq), 1e-12)).
//
// Why the tables are read from global memory and not staged in shared
// memory: a lane's lut_a is m * 256 * 4 = 32 KiB at m = 32, and a call reads
// v * m of its 8192 entries. On the search's own frontier (lanes expanding
// hubs, v about 47) those lookups touch about 78 % of the table's 32-byte
// sectors, so copying the whole table would move as many bytes as the
// lookups do, and on random ids (v about 17) twice as many. Inside the 1M
// search the tables do not stay in L2 either: the search's other kernels
// (its hashed visited table is 268 MB per tile) evict them between beam
// steps, and each 4-byte lookup then brings a 32-byte sector from HBM. At
// B = 1024 on the 1M PQ graph a call takes 8.6 us with the tables in L2,
// 17.6 us with L2 flushed before it (16.5 us a call inside the search), and
// 7.5 us flushed for a copy that looks nothing up; an L2::evict_last hint on
// the lookups did not keep the tables (H100 80GB HBM3, 700 W,
// scripts/beam_ab.py). The launch shape: LANES = 4 under
// __launch_bounds__(128, 4) (at most 128 registers; 116-121 used, no
// spills); LANES = 2 took the same time, LANES = 8 spilled.
// TMA and wgmma do not fit: 32-byte code rows and 4-byte table entries at
// data-dependent addresses, and adds, not a tile product.
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_prefix.cuh"
#include "launch_shape.cuh"

namespace {

using beam::FULL;
using beam::LANES;
using beam::put;
using beam::WIN;
constexpr int ROUNDS = 4;         // rounds of candidates whose loads are in flight together
constexpr int SUB = 8;            // subspaces (code bytes) a thread owns
constexpr int CENTROIDS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float finish(int metric, float qsq, float acc, float vsq) {
  if (metric != 2) return acc;      // l2: summed clamped partial squares; ip: summed -dots
  const float qn = fmaxf(sqrtf(qsq), 1e-12f);
  const float vn = fmaxf(sqrtf(vsq), 1e-12f);
  return 1.f - acc / (qn * vn);
}

// Bytes 0 .. ns - 1 of a thread's code piece (the rest 0): one 8-byte load
// when the piece is whole and aligned.
__device__ __forceinline__ uint2 load_codes(const uint8_t* p, int ns, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < SUB; ++j)
    if (j < ns) w[j / 4] |= static_cast<uint32_t>(__ldg(p + j)) << (8 * (j % 4));
  return make_uint2(w[0], w[1]);
}

template <int G>
__global__ void __launch_bounds__(LANES * 32, 4)
beam_score_pq_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ nbrs,
                     const int* __restrict__ u, const float* __restrict__ lut_a,
                     const float* __restrict__ lut_b, const float* __restrict__ qsq,
                     int n, int mq, int m, int b, int k, int metric, int vec,
                     int* __restrict__ ids_out, float* __restrict__ dist_out,
                     int* __restrict__ key_out) {
  __shared__ int s_id[LANES][WIN];
  __shared__ int s_slot[LANES][WIN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lb = blockIdx.x * LANES + warp;
  if (lb >= b) return;                 // a whole warp
  const int uid = __ldg(u + lb);
  const bool urow = uid >= 0 && uid < n;
  const long long row = (long long)(urow ? uid : 0) * m, obase = (long long)lb * k;
  const float* la = lut_a + (long long)lb * mq * CENTROIDS;
  const float q2 = metric == 2 ? __ldg(qsq + lb) : 0.f;
  int* sid = s_id[warp];
  int* sslot = s_slot[warp];

  for (int base = 0; base < k; base += WIN) {
    int id[WIN / 32];
    beam::load_window(nbrs, row, urow, k, base, lane, id);
    const int v = beam::compact_window(id, n, k, base, lane, sid, sslot, ids_out, dist_out,
                                       key_out, obase);

    if constexpr (G > 0) {
      constexpr int P = 32 / G;        // candidates per round
      const int g = lane / G, t = lane % G;
      const int s0 = SUB * t, ns = min(SUB, mq - s0);   // ns <= 0: an idle thread
      const float* ta = la + (long long)s0 * CENTROIDS;
      const float* tb = lut_b + (long long)s0 * CENTROIDS;
      for (int c0 = 0; c0 < v; c0 += ROUNDS * P) {
        uint2 raw[ROUNDS];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
          const int ci = c0 + r * P + g;
          raw[r] = make_uint2(0u, 0u);
          if (ci < v && ns > 0) raw[r] = load_codes(codes + (long long)sid[ci] * mq + s0, ns, vec);
        }
        float fa[ROUNDS][SUB], fb[ROUNDS][SUB];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
          const bool live = c0 + r * P + g < v;
          const uint32_t w[2] = {raw[r].x, raw[r].y};
#pragma unroll
          for (int j = 0; j < SUB; ++j) {
            const int c = (w[j / 4] >> (8 * (j % 4))) & 0xff;
            const bool use = live && j < ns;
            fa[r][j] = use ? __ldg(ta + j * CENTROIDS + c) : 0.f;
            fb[r][j] = use && metric == 2 ? __ldg(tb + j * CENTROIDS + c) : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
          if (c0 + r * P < v) {        // warp-uniform
            float acc = 0.f, vsq = 0.f;
#pragma unroll
            for (int j = 0; j < SUB; ++j) {
              acc += fa[r][j];
              vsq += fb[r][j];
            }
#pragma unroll
            for (int o = G / 2; o > 0; o >>= 1) {
              acc += __shfl_xor_sync(FULL, acc, o);
              vsq += __shfl_xor_sync(FULL, vsq, o);
            }
            const int ci = c0 + r * P + g;
            if (t == 0 && ci < v)
              put(ids_out, dist_out, key_out, obase + sslot[ci], sid[ci],
                  finish(metric, q2, acc, vsq));
          }
        }
      }
    } else {
      for (int ci = 0; ci < v; ++ci) {
        const uint8_t* crow = codes + (long long)sid[ci] * mq;
        float acc = 0.f, vsq = 0.f;
        for (int s = lane; s < mq; s += 32) {
          const int c = __ldg(crow + s);
          acc += __ldg(la + (long long)s * CENTROIDS + c);
          if (metric == 2) vsq += __ldg(lut_b + (long long)s * CENTROIDS + c);
        }
        acc = warp_sum(acc);
        vsq = warp_sum(vsq);
        if (lane == 0)
          put(ids_out, dist_out, key_out, obase + sslot[ci], sid[ci],
              finish(metric, q2, acc, vsq));
      }
    }
    __syncwarp();                      // the list is read before the next window
  }
}

template <int G>
cudaError_t launch(const kshape::Shape& s, const uint8_t* codes, const int* nbrs, const int* u,
                   const float* lut_a, const float* lut_b, const float* qsq, int n, int mq,
                   int m, int b, int k, int metric, int vec, int* ids, float* dists, int* keys,
                   cudaStream_t stream) {
  beam_score_pq_kernel<G><<<s.dims(), s.threads, s.smem, stream>>>(
      codes, nbrs, u, lut_a, lut_b, qsq, n, mq, m, b, k, metric, vec, ids, dists, keys);
  return cudaGetLastError();
}

// The launch for b lanes over mq code bytes a row: LANES lanes (warps) a
// block; instance i (launch_shape.cuh's out[6]) has G = 0, 1, 2, 4, 8, 16, 32
// threads a candidate (i = 0: the generic instance, for rows of more than
// 32 SUB-byte pieces).
kshape::Shape pq_shape(int mq, int b) {
  const int pieces = (mq + SUB - 1) / SUB;   // threads a candidate needs
  kshape::Shape s;
  s.grid[0] = ((long long)b + LANES - 1) / LANES;
  s.threads = LANES * 32;
  s.instance = pieces > 32   ? 0
               : pieces == 1 ? 1
               : pieces == 2 ? 2
               : pieces <= 4 ? 3
               : pieces <= 8 ? 4
               : pieces <= 16 ? 5
                              : 6;
  return s;
}

}  // namespace

// ids/dists/keys (b, k) for frontier ids u (b,) over adjacency nbrs (n, m)
// and PQ codes (n, mq) uint8, scored with lut_a (b, mq, 256), lut_b
// (mq, 256) and qsq (b,) f32. metric: 0 l2, 1 ip, 2 cos. k <= m. The kernel
// takes no attributes and no dynamic shared memory, so a launch sets
// nothing up. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int beam_score_pq(const uint8_t* codes, const int* nbrs, const int* u,
                             const float* lut_a, const float* lut_b, const float* qsq,
                             int n, int mq, int m, int b, int k, int metric, int* ids,
                             float* dists, int* keys, cudaStream_t stream) {
  if (k < 1 || k > m || mq < 1 || b < 1 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const int vec = mq % SUB == 0 && reinterpret_cast<uintptr_t>(codes) % SUB == 0;
  const kshape::Shape s = pq_shape(mq, b);
  cudaError_t (*const fn[])(const kshape::Shape&, const uint8_t*, const int*, const int*,
                            const float*, const float*, const float*, int, int, int, int, int,
                            int, int, int*, float*, int*, cudaStream_t) = {
      launch<0>, launch<1>, launch<2>, launch<4>, launch<8>, launch<16>, launch<32>};
  return (int)fn[s.instance](s, codes, nbrs, u, lut_a, lut_b, qsq, n, mq, m, b, k, metric,
                             vec, ids, dists, keys, stream);
}

// The launch beam_score_pq makes (launch_shape.cuh's out[8]).
extern "C" int beam_score_pq_launch_shape(int mq, int b, int* out) {
  if (mq < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return kshape::write(pq_shape(mq, b), out);
}

// Instances 0-6: G = 0, 1, 2, 4, 8, 16, 32.
extern "C" int beam_score_pq_func_attrs(int instance, int dyn_smem, int* out) {
  if (dyn_smem != 0) return (int)cudaErrorInvalidValue;
  const int t = LANES * 32;
  switch (instance) {
    case 0: return (int)kshape::attrs(beam_score_pq_kernel<0>, t, 0, out);
    case 1: return (int)kshape::attrs(beam_score_pq_kernel<1>, t, 0, out);
    case 2: return (int)kshape::attrs(beam_score_pq_kernel<2>, t, 0, out);
    case 3: return (int)kshape::attrs(beam_score_pq_kernel<4>, t, 0, out);
    case 4: return (int)kshape::attrs(beam_score_pq_kernel<8>, t, 0, out);
    case 5: return (int)kshape::attrs(beam_score_pq_kernel<16>, t, 0, out);
    case 6: return (int)kshape::attrs(beam_score_pq_kernel<32>, t, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
