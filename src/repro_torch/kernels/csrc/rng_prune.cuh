// The fused RNG prune kernel, shared by rng_prune.cu (rows of up to 128
// candidates: f32, bf16, int8) and rng_prune_wide.cu (up to 256: f32,
// bf16), which instantiate it and are compiled in parallel.
//
// Fused neighbour gather + candidate Gram + RNG keep/redirect scan
// (RNN-Descent Alg. 4 core), CUDA C++ for sm_90a.
//
// The work is sized to each row's valid extent e = 1 + (last slot whose id
// is in [0, n)), not to the capacity M: under the build's valid-first rows
// e is the valid count. At n = 1M the median row holds 10-24 candidates and
// 75-91 % hold at most 32, but every sweep has a tail up to M (PERF.md).
// Slots >= e are padding (keep 0, red_w -1, red_d +inf) and cost only their
// output writes.
//
// What bounds it on an H100: a row of v valid candidates gathers v*d*bytes
// (f32 4, bf16 2, int8 1) and its scan needs v(v-1)/2 pair distances of 2d
// flops plus v norms: v(v+1)d flops. At v = 17-40 and d = 128 that is 4-10
// flops per gathered f32 byte, below the f32 SIMT ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the gather bytes bound it; full 128-slot rows come
// near the ridge.
//
// Design: a warp owns a row at a time; a block holds WARPS of them.
//  * Rows come from two counters (the launch zeroes them on its stream):
//    rows of more than 32 candidates in a first pass, the rest in a second,
//    so that no long row starts late and holds up the end of the launch.
//    Each pass reads every row's ids, dists and flags to find its rows: on
//    the 1M rows of the random graph (no long row) that costs 10.0 ms
//    against 8.4 for one counter, but over a 1M build the two passes prune
//    in 0.936 s (f32) and 0.916 s (int8) against 0.942 and 1.038 s for one
//    counter (H100 80GB HBM3 at 700 W, scripts/prune_ab.py). A warp takes
//    rows two ahead and loads the next row's ids, dists and flags into
//    registers while it prunes the current one. e is one __ballot_sync per
//    32 slots over the ids.
//  * The Gram covers the lower triangle of 32 x 32 tiles (I, J <= I) of
//    the e x e candidate matrix: one tile for e <= 32, ten for e = 128.
//    In a tile lane (ty, tx) = (lane / 8, lane % 8) holds rows ty + 4r by
//    columns tx + 8s (r < 8, s < 4) in registers. The code is specialised
//    to the tile's number of row groups of 4 (a template parameter), so the
//    groups beyond e or above the diagonal cost no instruction at all. Each
//    float4 of a row or a column (one shared wavefront) feeds 4 FMAs per
//    group, summed over d in order, in f32 (no tensor cores: TF32 would
//    move keep decisions). A row's squared norm is its diagonal entry (the
//    same sums).
//  * Candidate rows reach shared memory in d-chunks of DC with cp.async
//    16-byte copies (lane r copies candidate r; zero-filled past d or for
//    padding ids) into a ring of NSLOT chunk slots: a step of a diagonal
//    tile takes one slot, of an off-diagonal tile two, so the next step's
//    copies (two to three for a row of at most 32) are in flight while a
//    step's FMAs run. The 16-byte pieces of a slot row are permuted by the
//    row (fidx), which keeps the float4 reads free of bank conflicts without
//    padding. bf16 rows and int8 code rows land raw and are widened into
//    f32 tiles before the FMAs; int8 decodes as
//    __fadd_rn(__fmul_rn(c, scale), zero): two roundings, never contracted,
//    exactly the plain version's codes.float() * scale + zero. A d that
//    breaks 16-byte alignment falls back to plain loads.
//  * The scan needs no pair matrix. Tiles go in order I, then J = 0..I, so
//    when tile (I, J < I) ends the keep bits of block J are final, and each
//    row's lowest failing kept column there (old-old pairs exempt) is a min
//    over the 8 lanes of its row group, for 4 rows at once. The diagonal
//    tile then scans block I's rows in order, one __ballot_sync per 8
//    columns below the row, with the keep bits in registers (lane (ty, tx),
//    bit 4J + s: candidate 32J + 8s + tx): each row sees exactly the kept
//    j < i, and ties decide as rng_scan does. red_d is read from the
//    register of the lane that holds the pair.
//  * Occupancy (sm_90a, -Xptxas -v, printed by chip_smoke.py): 168 (int8),
//    160 (f32) and 150 (bf16) registers a thread, no spills, under
//    __launch_bounds__(128, 3); shared memory per block WARPS x 19,072 B
//    (f32 and bf16) or WARPS x 14,976 B + 8d (int8): 3 blocks, 12 warps, per
//    SM, as the registers and the shared memory both allow.
//  * Rows wider than 128 (NSG-style prunes C = 132 candidates a row): the
//    row capacity is a template parameter, NB blocks of 32. NB = 4 is the
//    build's instance above (rng_prune.cu); NB = 8 (rng_prune_wide.cu)
//    takes m <= 256, f32 and bf16, with 8 prefetch registers of each kind
//    (167-168 registers a thread, no spills), WARPS x 21,760 B of shared
//    memory and __launch_bounds__(128, 2): 2 blocks, 8 warps, an SM. The
//    keep bits of 8 blocks still fill one 32-bit word. On NSG's rows (about
//    132 valid candidates each) it reaches 10 % of the f32 SIMT bound, as
//    the build's instance does on its rows (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "launch_shape.cuh"

namespace {

constexpr int WARPS = 4;               // warps per block, a row each at a time
constexpr int THREADS = 32 * WARPS;
// Row capacity: NB blocks of 32 candidates. NB = 4 (M <= 128, the paper's
// capacity, every RNN-Descent sweep) or NB = 8 (M <= 256: NSG's C = 132).
// keepbits holds 4 bits a block, so NB <= 8.
constexpr int NB_BUILD = 4;
constexpr int NB_WIDE = 8;
constexpr int DC = 32;                 // d-chunk staged per step
constexpr int NSLOT = 4;               // ring of 32-candidate chunk slots
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t COUNTER_BYTES = 2 * sizeof(int);  // the row counters, zeroed per launch

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool kCoded = std::is_same<T, int8_t>::value;

// f32 rows land straight in f32 slots; bf16 and int8 rows land in raw slots
// and are widened into two f32 tiles (rows, columns) per step.
constexpr int SLOT = 32 * DC;  // elements in a slot: a chunk of 32 candidates
template <typename T>
constexpr int FBUF_BYTES = (kF32<T> ? NSLOT : 2) * SLOT * 4;
template <typename T>
constexpr int RAW_BYTES = kF32<T> ? 0 : NSLOT * SLOT * (int)sizeof(T);
template <int NB>
constexpr int SMALL_BYTES = 5 * 32 * NB * 4 + 32 * NB;  // id, dist, sq, first, redd; old
template <typename T, int NB>
constexpr int WARP_BYTES = FBUF_BYTES<T> + RAW_BYTES<T> + SMALL_BYTES<NB>;

// Element (r, c) of an f32 slot (32 rows of DC floats). The 16-byte pieces
// of a row are permuted by r % 8, so the float4 reads of 8 rows at one c
// (a warp's column operands) and the copies into them hit distinct banks.
static_assert(DC == 32, "fidx permutes the 8 16-byte pieces of a 32-float row");
__device__ __forceinline__ int fidx(int r, int c) {
  return r * DC + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0..NSLOT-1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Stage d-chunk [c0, c0 + DC) of the candidates of block b that lie below
// e into slot `dst` (f32 rows at fidx, or raw rows of DC elements):
// lane r copies candidate 32b + r. Padding ids and elements past d read as 0.
template <typename T>
__device__ __forceinline__ void stage_block(const T* __restrict__ x, const int* s_id, int b,
                                            int e, int c0, int d, bool vec, void* dst,
                                            int lane) {
  if (lane >= e - 32 * b) return;
  const int id = s_id[32 * b + lane];
  const T* row = x + (long long)max(id, 0) * d;
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
#pragma unroll
    for (int seg = 0; seg < DC / E; ++seg) {
      const int col = c0 + seg * E;
      const bool live = id >= 0 && col < d;
      void* to = kF32<T> ? static_cast<void*>(static_cast<float*>(dst) + fidx(lane, seg * E))
                         : static_cast<void*>(static_cast<T*>(dst) + lane * DC + seg * E);
      cp_async16(to, live ? row + col : x, live ? 16 : 0);
    }
  } else {
    for (int c = 0; c < DC; ++c) {
      T v{};
      if (id >= 0 && c0 + c < d) v = row[c0 + c];
      if constexpr (kF32<T>)
        static_cast<float*>(dst)[fidx(lane, c)] = v;
      else
        static_cast<T*>(dst)[lane * DC + c] = v;
    }
  }
}

// Widen a raw slot into f32 tile rows, four elements a lane at a time
// (int8: decode with two roundings; bf16: exact). Elements past d become 0.
template <typename T>
__device__ __forceinline__ float widen1(T v, int col, const float* s_scale, const float* s_zero) {
  if constexpr (kCoded<T>)
    return __fadd_rn(__fmul_rn(static_cast<float>(v), s_scale[col]), s_zero[col]);
  else
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void widen_block(const T* raw, float* f, int rows_b, int c0, int d,
                                            const float* s_scale, const float* s_zero,
                                            int lane) {
  for (int g = lane; g < rows_b * (DC / 4); g += 32) {
    const int r = g / (DC / 4), c = (g % (DC / 4)) * 4, col = c0 + c;
    const T* src = raw + r * DC + c;
    float4 v;
    v.x = col < d ? widen1<T>(src[0], col, s_scale, s_zero) : 0.f;
    v.y = col + 1 < d ? widen1<T>(src[1], col + 1, s_scale, s_zero) : 0.f;
    v.z = col + 2 < d ? widen1<T>(src[2], col + 2, s_scale, s_zero) : 0.f;
    v.w = col + 3 < d ? widen1<T>(src[3], col + 3, s_scale, s_zero) : 0.f;
    *reinterpret_cast<float4*>(f + fidx(r, c)) = v;
  }
}

// The per-row arrays of a warp's shared region.
struct RowSmem {
  int* id;       // candidate ids, -1 for padding
  float* dist;   // d(u, candidate)
  float* sq;     // squared norms
  int* first;    // lowest failing kept column, -1 none
  float* redd;   // its pair distance
  uint8_t* old;  // flag 0 ("old")
};

__device__ __forceinline__ float pair_dist(float g, float sq_i, float sq_j, int metric) {
  if (metric == 0) return fmaxf(sq_i + sq_j - 2.f * g, 0.f);
  if (metric == 1) return -g;
  const float ni = fmaxf(sqrtf(sq_i), 1e-12f);
  const float nj = fmaxf(sqrtf(sq_j), 1e-12f);
  return 1.f - g / (ni * nj);
}

// One d-chunk of a tile's FMAs: acc[r][s] += A[ty + 4r][c] * B[tx + 8s][c]
// over c ascending, for the NR row groups of 4 and, on the diagonal (DIAG),
// only the column groups of 8 that reach below some row of the group. The
// groups are known at compile time, so the loop holds no branch but its own.
// `norms`: lane l also sums A[l][c]^2 into sqacc.
template <int NR, bool DIAG>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][4], const float* A, const float* B,
                                          int ty, int tx, int lane, bool norms,
                                          float& sqacc) {
  constexpr int NS = DIAG ? (NR + 1) / 2 : 4;
  const float* Ar = A + ty * DC;    // row ty + 4r at + 4r * DC
  const float* Bc = B + tx * DC;    // row tx + 8s at + 8s * DC
  const float* An = A + lane * DC;  // row lane
#pragma unroll 1
  for (int q = 0; q < DC / 4; ++q) {
    // piece q of row r sits at piece q ^ (r % 8) (fidx): ty + 4r % 8 is ty
    // for even r and ty ^ 4 for odd r, tx + 8s % 8 is tx
    const int pe = (q ^ ty) << 2, po = (q ^ ty ^ 4) << 2, pb = (q ^ tx) << 2;
    float4 bv[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) bv[s] = *reinterpret_cast<const float4*>(Bc + 8 * s * DC + pb);
    if (norms) {
      const float4 av = *reinterpret_cast<const float4*>(An + ((q ^ (lane & 7)) << 2));
      sqacc = fmaf(av.x, av.x, sqacc);
      sqacc = fmaf(av.y, av.y, sqacc);
      sqacc = fmaf(av.z, av.z, sqacc);
      sqacc = fmaf(av.w, av.w, sqacc);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(Ar + 4 * r * DC + (r % 2 ? po : pe));
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (!DIAG || 8 * s < 4 * r + 3) {
          acc[r][s] = fmaf(av.x, bv[s].x, acc[r][s]);
          acc[r][s] = fmaf(av.y, bv[s].y, acc[r][s]);
          acc[r][s] = fmaf(av.z, bv[s].z, acc[r][s]);
          acc[r][s] = fmaf(av.w, bv[s].w, acc[r][s]);
        }
      }
    }
  }
}

// The end of tile (cI, cJ) with NR row groups: norms, pair distances, the
// scan's ballots for the tile's columns, and red_d of the rows whose first
// failing column lies in it. Keep bits of block cJ < cI are final; on the
// diagonal (DIAG) block cI's rows decide in order.
template <int NR, bool DIAG>
__device__ __forceinline__ void tile_end(float (&acc)[8][4], unsigned& keepbits, float& sqacc,
                                         const RowSmem& S, int cI, int cJ, int rows_i,
                                         int metric, int ty, int tx, int lane) {
  constexpr int NS = DIAG ? (NR + 1) / 2 : 4;
  if (DIAG && cI == 0) {  // block 0's norms: its diagonal entries (the same sums)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (8 * s < 4 * r + 3 && ty + 4 * r == tx + 8 * s) S.sq[ty + 4 * r] = acc[r][s];
  } else if (!DIAG && cJ == 0) {  // later blocks' norms, summed in their first tile
    S.sq[32 * cI + lane] = sqacc;
    sqacc = 0.f;
  }
  __syncwarp();
  // pair distances (in place) and their keep-independent fail bits
  float sq_j[NS];
  bool old_j[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    sq_j[s] = S.sq[32 * cJ + tx + 8 * s];
    old_j[s] = S.old[32 * cJ + tx + 8 * s];
  }
  unsigned cand = 0;  // bit 4r + s: row ty + 4r fails on column tx + 8s if that is kept
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ii = 32 * cI + ty + 4 * r;
    const float sq_i = S.sq[ii], d_i = S.dist[ii];
    const bool old_i = S.old[ii];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!DIAG || 8 * s < 4 * r + 3) {
        const float p = pair_dist(acc[r][s], sq_i, sq_j[s], metric);
        acc[r][s] = p;
        if (p <= d_i && !(old_i && old_j[s])) cand |= 1u << (4 * r + s);
      }
    }
  }
  if (!DIAG) {
    // keep bits of block cJ are final: per row, the lowest failing column is
    // a min over the 8 lanes (tx) of its row group (ty), for 4 rows at once
    const unsigned kb = (keepbits >> (4 * cJ)) & 0xfu;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const unsigned fr = (cand >> (4 * r)) & kb;
      int key = fr ? 8 * (__ffs(fr) - 1) + tx : 32;  // column within block cJ
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
      const int ii = 32 * cI + ty + 4 * r;
      if (tx == 0 && key < 32 && ty + 4 * r < rows_i && S.id[ii] >= 0 && S.first[ii] < 0)
        S.first[ii] = 32 * cJ + key;
    }
  } else {  // block cI's rows in order, each against the kept j < i
    const unsigned open = __ballot_sync(
        FULL, lane < rows_i && S.id[32 * cI + lane] >= 0 && S.first[32 * cI + lane] < 0);
    for (int i = 0; i < rows_i; ++i) {
      if (!((open >> i) & 1u)) continue;
      const int t = i & 3;
      const unsigned fr =
          ty == t ? (cand >> (4 * (i >> 2))) & (keepbits >> (4 * cI)) & 0xfu : 0u;
      int first = -1;
      for (int s = 0; 8 * s < i; ++s) {
        const unsigned byte = (__ballot_sync(FULL, (fr >> s) & 1u) >> (8 * t)) & 0xffu;
        if (byte) {
          first = 8 * s + __ffs(byte) - 1;
          break;
        }
      }
      if (first >= 0) {
        if (lane == 0) S.first[32 * cI + i] = 32 * cI + first;
      } else if (tx == (i & 7)) {
        keepbits |= 1u << (4 * cI + (i >> 3));
      }
    }
  }
  __syncwarp();
  // red_d of the rows whose first failing column lies in this tile
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ii = 32 * cI + ty + 4 * r;
    const int f = ty + 4 * r < rows_i ? S.first[ii] - 32 * cJ - tx : -1;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if ((!DIAG || 8 * s < 4 * r + 3) && f == 8 * s) S.redd[ii] = acc[r][s];
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[r][s] = 0.f;
}

// One step of tile (cI, cJ): a d-chunk's FMAs and, after the last chunk,
// the tile's end.
template <int NR, bool DIAG>
__device__ __forceinline__ void tile_step(float (&acc)[8][4], const float* A, const float* B,
                                          bool last, unsigned& keepbits, float& sqacc,
                                          const RowSmem& S, int cI, int cJ, int rows_i,
                                          int metric, int ty, int tx, int lane) {
  fma_chunk<NR, DIAG>(acc, A, B, ty, tx, lane, !DIAG && cJ == 0, sqacc);
  if (last) tile_end<NR, DIAG>(acc, keepbits, sqacc, S, cI, cJ, rows_i, metric, ty, tx, lane);
}

template <bool DIAG>
__device__ __forceinline__ void tile_step_nr(int nr, float (&acc)[8][4], const float* A,
                                             const float* B, bool last, unsigned& keepbits,
                                             float& sqacc, const RowSmem& S, int cI, int cJ,
                                             int rows_i, int metric, int ty, int tx,
                                             int lane) {
#define RNG_PRUNE_STEP(K)                                                                   \
  tile_step<K, DIAG>(acc, A, B, last, keepbits, sqacc, S, cI, cJ, rows_i, metric, ty, tx, \
                     lane)
  switch (nr) {
    case 1: RNG_PRUNE_STEP(1); break;
    case 2: RNG_PRUNE_STEP(2); break;
    case 3: RNG_PRUNE_STEP(3); break;
    case 4: RNG_PRUNE_STEP(4); break;
    case 5: RNG_PRUNE_STEP(5); break;
    case 6: RNG_PRUNE_STEP(6); break;
    case 7: RNG_PRUNE_STEP(7); break;
    default: RNG_PRUNE_STEP(8); break;
  }
#undef RNG_PRUNE_STEP
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS, NB <= NB_BUILD ? 3 : 2)
rng_prune_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ zero, const int* __restrict__ ids,
                 const float* __restrict__ dists, const uint8_t* __restrict__ flags, int n,
                 int d, int rows, int m, int metric, int vec, int* __restrict__ counter,
                 uint8_t* __restrict__ keep_out, int* __restrict__ redw_out,
                 float* __restrict__ redd_out) {
  static_assert(NB >= 1 && NB <= 8, "keepbits holds 4 bits for each of NB blocks");
  constexpr int MAX_M = 32 * NB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ty = lane / 8, tx = lane % 8;
  float* s_scale = reinterpret_cast<float*>(smem + WARPS * WARP_BYTES<T, NB>);
  float* s_zero = s_scale + d;
  if constexpr (kCoded<T>) {
    for (int i = threadIdx.x; i < d; i += THREADS) {
      s_scale[i] = scale[i];
      s_zero[i] = zero[i];
    }
    __syncthreads();  // the last block barrier: warps run on their own after it
  }
  unsigned char* region = smem + warp * WARP_BYTES<T, NB>;
  float* fbuf = reinterpret_cast<float*>(region);
  T* raw = reinterpret_cast<T*>(region + FBUF_BYTES<T>);
  RowSmem S;
  S.id = reinterpret_cast<int*>(region + FBUF_BYTES<T> + RAW_BYTES<T>);
  S.dist = reinterpret_cast<float*>(S.id + MAX_M);
  S.sq = S.dist + MAX_M;
  S.first = reinterpret_cast<int*>(S.sq + MAX_M);
  S.redd = reinterpret_cast<float*>(S.first + MAX_M);
  S.old = reinterpret_cast<uint8_t*>(S.redd + MAX_M);
  const int nch = (d + DC - 1) / DC;

  // Two passes over the rows, each handing them out from its own counter:
  // rows of more than 32 candidates first, so that none of them starts late
  // and holds up the end of the launch, then the rest. A warp takes rows two
  // ahead: a row's ids, dists and flags load into registers while the row
  // before it is pruned.
  int pass = 0;
  auto take = [&]() {
    int r = 0;
    if (lane == 0) r = atomicAdd(counter + pass, 1);
    return __shfl_sync(FULL, r, 0);
  };
  int pid[NB];
  float pdist[NB];
  unsigned pflag[NB];
  auto prefetch = [&](int r) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int j = lane + 32 * q;
      const bool in = r < rows && j < m;
      const long long at = (long long)r * m + j;
      pid[q] = in ? ids[at] : -1;
      pdist[q] = in ? dists[at] : INFINITY;
      pflag[q] = in ? flags[at] : 1u;
    }
  };
  int row = take();
  int next = take();
  prefetch(row);
  for (;;) {
    if (row >= rows) {
      if (++pass == 2) break;
      row = take();
      next = take();
      prefetch(row);
      continue;
    }
    // -- the row's extent e; its pass
    int e = 0;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (pid[q] >= n) pid[q] = -1;  // an id outside [0, n) reads as padding
      const unsigned bal = __ballot_sync(FULL, pid[q] >= 0);
      if (bal) e = 32 * q + 32 - __clz(bal);
    }
    if ((e > 32) != (pass == 0)) {
      prefetch(next);
      row = next;
      next = take();
      continue;
    }
    __syncwarp();  // the previous row's outputs are read out
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int j = lane + 32 * q;
      S.id[j] = pid[q] < 0 ? -1 : pid[q];
      S.dist[j] = pdist[q];
      S.old[j] = pflag[q] == 0u;
      S.first[j] = -1;
    }
    __syncwarp();
    const long long base = (long long)row * m;
    prefetch(next);           // lands while this row is pruned
    const int after = take();  // used only by the next row's prefetch

    unsigned keepbits = 0;  // bit 4J + s: keep[32J + 8s + tx]
    const int nb = (e + 31) / 32;
    const int steps = nb * (nb + 1) / 2 * nch;

    // issue side of the ring: steps in order block I, J = 0..I, chunk k
    int iI = 0, iJ = 0, ik = 0, islot = 0, held = 0, issued = 0;
    auto issue_ready = [&]() {
      while (issued < steps && held + (iJ != iI ? 2 : 1) <= NSLOT) {
        const int need = iJ != iI ? 2 : 1;
        const int sa = islot, sb = (islot + 1) % NSLOT;
        void* da = kF32<T> ? static_cast<void*>(fbuf + sa * SLOT)
                           : static_cast<void*>(raw + sa * SLOT);
        void* db = kF32<T> ? static_cast<void*>(fbuf + sb * SLOT)
                           : static_cast<void*>(raw + sb * SLOT);
        stage_block<T>(x, S.id, iI, e, ik * DC, d, vec != 0, da, lane);
        if (need == 2) stage_block<T>(x, S.id, iJ, e, ik * DC, d, vec != 0, db, lane);
        cp_async_commit();
        islot = (islot + need) % NSLOT;
        held += need;
        ++issued;
        if (++ik == nch) {
          ik = 0;
          if (++iJ > iI) {
            iJ = 0;
            ++iI;
          }
        }
      }
    };
    issue_ready();

    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
    float sqacc = 0.f;
    int cI = 0, cJ = 0, ck = 0, cslot = 0;
    for (int step = 0; step < steps; ++step) {
      const bool diag = cJ == cI;
      const int rows_i = min(32, e - 32 * cI);
      cp_async_wait(issued - step - 1);  // this step's copies have landed
      __syncwarp();                      // ... every lane's
      const float* A;
      const float* B;
      if constexpr (kF32<T>) {
        A = fbuf + cslot * SLOT;
        B = diag ? A : fbuf + ((cslot + 1) % NSLOT) * SLOT;
      } else {
        widen_block<T>(raw + cslot * SLOT, fbuf, rows_i, ck * DC, d, s_scale, s_zero,
                       lane);
        if (!diag)
          widen_block<T>(raw + ((cslot + 1) % NSLOT) * SLOT, fbuf + SLOT, 32,
                         ck * DC, d, s_scale, s_zero, lane);
        __syncwarp();
        A = fbuf;
        B = diag ? A : fbuf + SLOT;
      }

      // -- FMAs over the tile's needed groups (nr row groups of 4); after the
      // last chunk, the tile's end
      const int nr = (rows_i + 3) / 4;
      if (diag)
        tile_step_nr<true>(nr, acc, A, B, ck == nch - 1, keepbits, sqacc, S, cI, cJ, rows_i,
                           metric, ty, tx, lane);
      else
        tile_step_nr<false>(nr, acc, A, B, ck == nch - 1, keepbits, sqacc, S, cI, cJ, rows_i,
                            metric, ty, tx, lane);
      __syncwarp();  // every lane is done with this step's slots
      const int used = diag ? 1 : 2;
      cslot = (cslot + used) % NSLOT;
      held -= used;
      if (++ck == nch) {
        ck = 0;
        if (++cJ > cI) {
          cJ = 0;
          ++cI;
        }
      }
      issue_ready();
    }

    // -- outputs: the row's m slots, padding past e
    for (int j = lane; j < m; j += 32) {
      uint8_t k = 0;
      int w = -1;
      float rd = INFINITY;
      if (j < e) {
        k = (keepbits >> (4 * (j / 32) + ty)) & 1u;  // j % 8 == tx, (j % 32) / 8 == ty
        const int f = S.first[j];
        if (f >= 0) {
          w = S.id[f];
          rd = S.redd[j];
        }
      }
      keep_out[base + j] = k;
      redw_out[base + j] = w;
      redd_out[base + j] = rd;
    }
    row = next;
    next = after;
  }
}

// The kernel's attributes and the card's block count, worked out once per
// device and dynamic shared size (int8's grows with d) and reused.
struct CardBlocks {
  size_t smem = 0;
  int blocks_per_card = 0;
  int blocks_per_sm = 0;
};
constexpr int MAX_DEVICES = 64;

template <typename T, int NB>
cudaError_t card_blocks(size_t smem, int& blocks_per_card, int& blocks_per_sm) {
  static std::mutex mu;
  static CardBlocks cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  CardBlocks& c = cache[dev];
  if (c.smem != smem) {
    err = cudaFuncSetAttribute(rng_prune_kernel<T, NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rng_prune_kernel<T, NB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rng_prune_kernel<T, NB>,
                                                             THREADS, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    c.smem = smem;
    c.blocks_per_card = sms * per_sm;
    c.blocks_per_sm = per_sm;
  }
  blocks_per_card = c.blocks_per_card;
  blocks_per_sm = c.blocks_per_sm;
  return cudaSuccess;
}

// The launch for `rows` rows over a corpus of width d: persistent blocks, as
// many as fit the card at once or one per WARPS rows, each opting in to the
// dynamic shared memory of WARPS warps (and int8's decode table).
template <typename T, int NB>
cudaError_t shape_of(int d, int rows, int instance, kshape::Shape& s) {
  s.smem = (size_t)WARPS * WARP_BYTES<T, NB> + (kCoded<T> ? 2 * sizeof(float) * d : 0);
  int per_card = 0, per_sm = 0;
  cudaError_t err = card_blocks<T, NB>(s.smem, per_card, per_sm);
  if (err != cudaSuccess) return err;
  s.grid[0] = std::min(((long long)rows + WARPS - 1) / WARPS, (long long)per_card);
  s.threads = THREADS;
  s.opt_in = 1;
  s.instance = instance;
  s.per_sm = per_sm;
  return cudaSuccess;
}

// kshape::attrs of the instance, after the launcher's own opt-in at smem.
template <typename T, int NB>
cudaError_t attrs_of(size_t smem, int* out) {
  int per_card = 0, per_sm = 0;
  cudaError_t err = card_blocks<T, NB>(smem, per_card, per_sm);
  if (err != cudaSuccess) return err;
  return kshape::attrs(rng_prune_kernel<T, NB>, THREADS, smem, out);
}

template <typename T, int NB>
cudaError_t launch(int instance, const void* x, const float* scale, const float* zero,
                   const int* ids, const float* dists, const uint8_t* flags, int n, int d,
                   int rows, int m, int metric, int* counter, uint8_t* keep, int* red_w,
                   float* red_d, cudaStream_t stream) {
  kshape::Shape s;
  cudaError_t err = shape_of<T, NB>(d, rows, instance, s);
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte rows
  const int vec = ((size_t)d * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  if ((err = cudaMemsetAsync(counter, 0, COUNTER_BYTES, stream)) != cudaSuccess) return err;
  rng_prune_kernel<T, NB><<<s.dims(), s.threads, s.smem, stream>>>(
      static_cast<const T*>(x), scale, zero, ids, dists, flags, n, d, rows, m, metric, vec,
      counter, keep, red_w, red_d);
  return cudaGetLastError();
}

}  // namespace
