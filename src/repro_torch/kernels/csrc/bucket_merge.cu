// The bucketed candidate merge of one RNN-Descent sweep (paper Alg. 4: each
// dropped edge u -> v whose RNG prune found a replacement w becomes the
// candidate edge w -> v, flagged "new"), CUDA C++ for sm_90a, in two kernels:
//
//   bucket_scatter_kernel: one thread per (row u, slot j) of the pruned
//     graph. Only a real candidate (red_w >= 0, v = ids[u, j] >= 0, w != v,
//     red_d not NaN, w < n) issues an atomic: one 64-bit atomicMin of the
//     word (dist_key(red_d) biased to unsigned) << 32 | v on the slot
//     (v * 2654435761) & (B - 1) of w's row of B buckets. The minimum of the
//     packed words is the lexicographic-least (key, id) that the staged
//     key-then-id scatters of repro_torch.core.graph.bucket_scatter_tables
//     keep, and a minimum does not depend on the order of the atomics.
//   bucket_row_merge_kernel: one warp per row. It reads the row's kept
//     entries (ids under the prune's keep mask; their flags become OLD) and
//     its B bucket words (flag NEW), drops a bucket id that the kept row
//     holds (the row's copy wins: an id can only sit in its own slot, so
//     one read a kept entry finds it), sorts the live entries (distance
//     below +inf, not NaN) by (distance, id) in a bitonic network over
//     shared memory and writes the first cap into the row's m slots, with
//     -1 / +inf / OLD after them. That is merge_rows_with_buckets' result:
//     its stable sort by distance runs over the id-sorted order, so ties
//     break by id, and -0.0 ties +0.0 (the sort key canonicalises the zero,
//     a flag bit keeps the sign for the output).
//
// Replaces no TPU kernel: the JAX package leaves this merge to XLA's
// scatters and sorts (repro.core.graph._merge_candidate_edges_bucketed), as
// the port's plain path leaves it to scatter_reduce_ and torch.sort
// (kernels/bucket_merge/ref.py). Those offer every one of the n m slots to
// three scatter passes, the invalid ones all aimed at one sink row.
//
// What bounds it on an H100: bytes. The merge's least traffic is its inputs
// read once (ids and dists of the rows, the prune's keep, red_w and red_d:
// 17 B a slot) and its rows written once (9 B a slot): at n = 1M, m = 128
// that is 3.33 GB, 0.99 ms at 3.35 TB/s. This design adds its own traffic:
// the (n, B) table's sentinel written and its words read back (2 x 2.05 GB
// at B = 256), ids read by both kernels (4 B a slot more) and a few 32-byte
// sectors per real candidate's atomic, about 7.9 GB a sweep in all.
//
// Preconditions (the graph's invariant): ids lie in [-1, n), a row holds an
// id at most once, n < 2^30 (a sort word keeps the id in 30 bits).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_shape.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long EMPTY = ~0ull;   // the table's sentinel (memset 0xFF)
constexpr unsigned SLOT_MULT = 2654435761u;   // Knuth; repro_torch.core.graph._SLOT_MULT
constexpr unsigned KEY_BIAS = 0x80000000u;     // int32 key -> order-preserving uint32
constexpr unsigned BIASED_INF = 0xFF800000u;   // dist_key(+inf) ^ KEY_BIAS
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ITEMS = 16;              // slots a thread
constexpr int MERGE_WARPS = 4;                 // rows a block
constexpr int MAX_M = 256;
constexpr int MAX_B = 2048;
constexpr size_t NO_OPT_IN = 48 * 1024;

// repro_torch.core.graph.dist_key: monotone f32 -> int32.
__device__ __forceinline__ int dist_key(int bits) { return bits >= 0 ? bits : bits ^ 0x7FFFFFFF; }

__device__ __forceinline__ unsigned slot_of(int v, int nb) {
  return ((unsigned)v * SLOT_MULT) & (unsigned)(nb - 1);
}

template <int ITEMS>
__global__ void __launch_bounds__(SCATTER_THREADS)
bucket_scatter_kernel(const int* __restrict__ ids, const int* __restrict__ red_w,
                      const float* __restrict__ red_d, long long total, int n, int nb,
                      unsigned long long* __restrict__ table,
                      unsigned long long* __restrict__ counter) {
  __shared__ unsigned block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * SCATTER_THREADS * ITEMS + threadIdx.x;
  unsigned mine = 0;
#pragma unroll 4
  for (int it = 0; it < ITEMS; ++it) {
    const long long e = first + (long long)it * SCATTER_THREADS;
    if (e >= total) break;
    const int w = red_w[e];
    if (w < 0 || w >= n) continue;
    const int v = ids[e];
    const float d = red_d[e];
    if (v < 0 || v == w || isnan(d)) continue;
    const unsigned hi = (unsigned)dist_key(__float_as_int(d)) ^ KEY_BIAS;
    atomicMin(table + (long long)w * nb + slot_of(v, nb),
              ((unsigned long long)hi << 32) | (unsigned)v);
    ++mine;
  }
  const unsigned warp_sum = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && warp_sum) atomicAdd(&block_count, warp_sum);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(counter, (unsigned long long)block_count);
}

// A sort word: the canonical key (-0.0 as +0.0) biased to unsigned, then the
// id, then the sign of a zero distance, then the flag (1 NEW, a bucket
// entry). Live ids are unique in a row, so the words order by (key, id).
__device__ __forceinline__ unsigned long long sort_word(int bits, int id, unsigned flag) {
  const unsigned negzero = (unsigned)bits == 0x80000000u;
  const unsigned hi = (unsigned)dist_key(negzero ? 0 : bits) ^ KEY_BIAS;
  return ((unsigned long long)hi << 32) | ((unsigned)id << 2) | (negzero << 1) | flag;
}

// Append each lane's live word to cand[count...] in lane order.
__device__ __forceinline__ void append(unsigned long long* cand, int& count, bool live,
                                       unsigned long long word, int lane) {
  const unsigned mask = __ballot_sync(FULL, live);
  if (live) cand[count + __popc(mask & ((1u << lane) - 1))] = word;
  count += __popc(mask);
}

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
bucket_row_merge_kernel(const int* __restrict__ ids, const float* __restrict__ dists,
                        const uint8_t* __restrict__ keep,
                        const unsigned long long* __restrict__ table, int n, int m, int nb,
                        int cap, int words, int* __restrict__ out_ids,
                        float* __restrict__ out_dists, uint8_t* __restrict__ out_flags) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n) return;                        // the whole warp: no block barrier follows
  unsigned long long* bucket = smem + (size_t)warp * (nb + words);
  unsigned long long* cand = bucket + nb;
  const long long base = (long long)row * m;
  const unsigned long long* trow = table + (long long)row * nb;
  for (int s = lane; s < nb; s += 32) bucket[s] = trow[s];

  int rid[MAX_M / 32], rbits[MAX_M / 32];
  bool rkept[MAX_M / 32];
#pragma unroll
  for (int r = 0; r < MAX_M / 32; ++r) {
    const int j = r * 32 + lane;
    rid[r] = -1;
    rbits[r] = 0;
    rkept[r] = false;
    if (j < m) {
      rid[r] = ids[base + j];
      rbits[r] = __float_as_int(dists[base + j]);
      rkept[r] = keep[base + j] && rid[r] >= 0;
    }
  }
  __syncwarp();
  // the kept row's copy of an id wins, whatever its distance
#pragma unroll
  for (int r = 0; r < MAX_M / 32; ++r) {
    if (rkept[r]) {
      const unsigned s = slot_of(rid[r], nb);
      const unsigned long long b = bucket[s];
      if (b != EMPTY && (unsigned)b == (unsigned)rid[r]) bucket[s] = EMPTY;
    }
  }
  __syncwarp();
  int count = 0;
#pragma unroll
  for (int r = 0; r < MAX_M / 32; ++r) {
    if (r * 32 >= m) break;
    // below +inf and not NaN (-inf is live)
    const bool live = rkept[r] && __int_as_float(rbits[r]) < __int_as_float(0x7F800000);
    append(cand, count, live, live ? sort_word(rbits[r], rid[r], 0) : 0, lane);
  }
  for (int s0 = 0; s0 < nb; s0 += 32) {
    const int s = s0 + lane;
    const unsigned long long b = s < nb ? bucket[s] : EMPTY;
    const unsigned hi = (unsigned)(b >> 32);
    const bool live = b != EMPTY && hi < BIASED_INF;   // never NaN: the scatter skips it
    const int key = (int)(hi ^ KEY_BIAS);
    append(cand, count, live,
           live ? sort_word(key >= 0 ? key : key ^ 0x7FFFFFFF, (int)(unsigned)b, 1) : 0, lane);
  }
  int p = 32;
  while (p < count) p <<= 1;
  for (int i = count + lane; i < p; i += 32) cand[i] = EMPTY;
  __syncwarp();
  // ascending bitonic sort of cand[0, p)
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = cand[i], b = cand[l];
          if ((a > b) == ((i & k) == 0)) {
            cand[i] = b;
            cand[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
  const int out = count < cap ? count : cap;
  for (int j = lane; j < m; j += 32) {
    int id = -1, bits = 0x7F800000;
    uint8_t flag = 0;
    if (j < out) {
      const unsigned long long w = cand[j];
      const int key = (int)((unsigned)(w >> 32) ^ KEY_BIAS);
      bits = (w & 2) ? (int)0x80000000 : (key >= 0 ? key : key ^ 0x7FFFFFFF);
      id = (int)(((unsigned)w) >> 2);
      flag = (uint8_t)(w & 1);
    }
    out_ids[base + j] = id;
    out_dists[base + j] = __int_as_float(bits);
    out_flags[base + j] = flag;
  }
}

bool valid(int n, int m, int nb) {
  return n >= 1 && n < (1 << 30) && m >= 1 && m <= MAX_M && nb >= 1 && nb <= MAX_B &&
         (nb & (nb - 1)) == 0;
}

// Words of a warp's sort buffer: the next power of two >= m + nb, at least 32.
int sort_words(int m, int nb) {
  int p = 32;
  while (p < m + nb) p <<= 1;
  return p;
}

kshape::Shape scatter_shape(int n, int m) {
  kshape::Shape s;
  const long long per_block = (long long)SCATTER_THREADS * SCATTER_ITEMS;
  s.grid[0] = ((long long)n * m + per_block - 1) / per_block;
  s.threads = SCATTER_THREADS;
  s.instance = 0;
  return s;
}

kshape::Shape merge_shape(int n, int m, int nb) {
  kshape::Shape s;
  s.grid[0] = ((long long)n + MERGE_WARPS - 1) / MERGE_WARPS;
  s.threads = 32 * MERGE_WARPS;
  s.smem = (size_t)MERGE_WARPS * (nb + sort_words(m, nb)) * sizeof(unsigned long long);
  s.opt_in = s.smem > NO_OPT_IN;
  s.instance = 1;
  return s;
}

}  // namespace

// Fills table (n, nb) uint64 with the sentinel and counter (one uint64) with
// 0 on `stream`, then scatters every real candidate of ids / red_w / red_d
// (n, m) into table and adds their number to counter. m <= 256, nb a power
// of two <= 2048, n < 2^30. Allocates nothing, returns the first error.
extern "C" int bucket_scatter(const int* ids, const int* red_w, const float* red_d, int n,
                              int m, int nb, unsigned long long* table,
                              unsigned long long* counter, cudaStream_t stream) {
  if (!valid(n, m, nb)) return (int)cudaErrorInvalidValue;
  const kshape::Shape s = scatter_shape(n, m);
  if (!s.fits()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(table, 0xFF, (size_t)n * nb * sizeof(*table), stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(counter, 0, sizeof(*counter), stream)) != cudaSuccess)
    return (int)err;
  bucket_scatter_kernel<SCATTER_ITEMS><<<s.dims(), s.threads, 0, stream>>>(
      ids, red_w, red_d, (long long)n * m, n, nb, table, counter);
  return (int)cudaGetLastError();
}

// Merges each row of ids / dists (n, m) under keep (n, m; 0 or 1) with its
// row of table (bucket_scatter's) into out_* (n, m): the cap <= m nearest
// live entries, by (distance, id). Allocates nothing, returns the first error.
extern "C" int bucket_row_merge(const int* ids, const float* dists, const uint8_t* keep,
                                const unsigned long long* table, int n, int m, int nb,
                                int cap, int* out_ids, float* out_dists, uint8_t* out_flags,
                                cudaStream_t stream) {
  if (!valid(n, m, nb) || cap < 1 || cap > m) return (int)cudaErrorInvalidValue;
  const kshape::Shape s = merge_shape(n, m, nb);
  if (!s.fits()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (s.opt_in &&
      (err = cudaFuncSetAttribute(bucket_row_merge_kernel<MERGE_WARPS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s.smem)) != cudaSuccess)
    return (int)err;
  bucket_row_merge_kernel<MERGE_WARPS><<<s.dims(), s.threads, s.smem, stream>>>(
      ids, dists, keep, table, n, m, nb, cap, sort_words(m, nb), out_ids, out_dists,
      out_flags);
  return (int)cudaGetLastError();
}

// The launches the two entries make (launch_shape.cuh's out[8]).
extern "C" int bucket_scatter_launch_shape(int n, int m, int* out) {
  if (!valid(n, m, 1)) return (int)cudaErrorInvalidValue;
  return kshape::write(scatter_shape(n, m), out);
}

extern "C" int bucket_row_merge_launch_shape(int n, int m, int nb, int* out) {
  if (!valid(n, m, nb)) return (int)cudaErrorInvalidValue;
  return kshape::write(merge_shape(n, m, nb), out);
}

// Instances 0 bucket_scatter_kernel, 1 bucket_row_merge_kernel.
extern "C" int bucket_merge_func_attrs(int instance, int dyn_smem, int* out) {
  const size_t smem = (size_t)dyn_smem;
  switch (instance) {
    case 0:
      if (dyn_smem != 0) return (int)cudaErrorInvalidValue;
      return (int)kshape::attrs(bucket_scatter_kernel<SCATTER_ITEMS>, SCATTER_THREADS, 0, out);
    case 1: {
      if (smem > NO_OPT_IN) {
        const cudaError_t err = cudaFuncSetAttribute(
            bucket_row_merge_kernel<MERGE_WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            dyn_smem);
        if (err != cudaSuccess) return (int)err;
      }
      return (int)kshape::attrs(bucket_row_merge_kernel<MERGE_WARPS>, 32 * MERGE_WARPS, smem,
                                out);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
