// G: the GROUP BY's fixed-order grouped reduce, and Gt: its column sum.
//
// Replaces the segment reductions of the JAX package's fused GROUP BY
// program (greptimedb_tpu/query/reduce.py _fused_program:216), which XLA
// computes outside any Pallas kernel:
//
//   sum form  (pseg2:250, jax.ops.segment_sum into gb * blocks segments)
//     out[b, g] = 0 + v[i0] + v[i1] + ...   over the live rows i of block b
//                                            with gid[i] == g, ascending i
//     in float32, and in float64 for the PromQL generic engine's vectors
//     (greptimedb_tpu/ops/promql.py aggregate_across_series:283, whose
//     scatter branch is jax.ops.segment_sum over the series axis, one
//     block; the JAX package's tests run it with x64 on)
//   max / min form  (:278, jax.ops.segment_max / segment_min; also the
//   int32 extremes of the first/last winner stages, :296)
//     out[g] = fold of XLA's max / min from -inf / +inf (int32: its least
//              or greatest value) over the live rows of group g,
//              ascending i
//     in float32 and int32, and in float64 for the flow state's min/max
//     in x64 mode (greptimedb_tpu/flow/device_state.py _apply_program:
//     136-147, jax.ops.segment_min / segment_max into the state's
//     capacity, one block)
//   column tree sum  (:274, jnp.sum(sp, axis=0) over (blocks, gb))
//     XLA:CPU rewrites a reduction over more than 32 rows into chunks of
//     32 rows, each summed in order from 0, then reduces the chunk sums
//     the same way until one chunk is left.
//
// XLA:CPU's scatter adds each segment's rows one after the other in row
// order, and the bit contract rests on that order. CUDA's atomics
// (index_add_, scatter_add_, scatter_reduce) add in no fixed order, so
// these sums need their own kernel even on one card. Adds are __fadd_rn
// (float64: __dadd_rn), never contracted.
//
// The extreme is XLA's maximum/minimum as XLA:CPU lowers it (NaN
// propagates, -0.0 orders below +0.0, which NaN survives follows the sign
// of the accumulator; see ring_fold.cu ext_f32). That fold is
// associative: its value over a sequence is the first NaN whose sign makes
// it sticky (negative for max, positive for min), else the last NaN, else
// the extreme with -0.0 below +0.0, and the same rule combines the values
// of two consecutive pieces. So any bracketing that keeps the rows in
// order gives the bits of the one sequential fold: the max/min form folds
// runs of rows, then segments, then a group's block chunks, each in order.
//
// Members come as CSR over segments s = g * blocks + b (group-major):
// perm[ptr[s] .. ptr[s + 1]) are the rows of group g in row block b,
// ascending (a stable sort of the row's group id; rows are cut into blocks
// of ceil(n / blocks) consecutive rows, so a group's rows in ascending
// order are its segments in block order). Masked rows are not listed.
//
// Bound on this card: bytes. The sum and max/min forms read each live
// row's member index and value once (8 bytes a row), the pointers once
// (4 * gb * blocks) and write 4 * gb * blocks (sum) or 4 * gb (max/min):
// at the GROUP BY hostname shape (17.1 M rows, 4096 x 256 segments) about
// 145 MB, 0.043 ms at 3.35 TB/s. The float64 forms read 12 bytes a row and
// write 8 a segment (sum) or a group (max/min).
//
// Design of the segment walk. Rows come in series order (Region.scan
// returns them by (sid, ts)), so a group's rows are long contiguous runs:
// at GROUP BY hostname ~4,130 of the 1,048,576 segments hold rows, ~4,142
// each. A thread walking such a segment alone has one member load, then
// one dependent value load, per row in flight: a memory round trip a row.
// Here a warp owns 32 consecutive segments of one group (one chunk of 32
// row blocks; part of a chunk past the group's last block is empty), and
//  - if any of them holds at least kWarpRows rows (a __ballot_sync), the
//    warp walks all 32 as one stream: their rows are one contiguous range
//    of perm. Lane j loads perm[k + j] (coalesced) and then its value, for
//    kBatches batches of 32 rows, stores them to a per-warp stage in
//    shared memory, and issues the next chunk's value loads and the one
//    after's member loads before it folds this chunk; the fold closes a
//    segment where the stream reaches its end. The sum form's fold is the
//    one dependent chain the contract allows: every lane adds the staged
//    values in order (broadcast reads, four values a shared memory load),
//    so only the add sits on the critical path. The extremes fold a
//    segment's piece of the chunk as contiguous per-lane runs and then an
//    in-order shuffle tree across the lanes.
//  - otherwise (every segment of the chunk shorter than one batch) every
//    lane walks its own segment, its kLaneRows member loads and then
//    their value loads in flight before its adds.
// On the card the stream also won at uniform random ids (~32 rows a
// segment: 0.33 ms against 0.46 with a threshold of 128 rows, 2^25 rows),
// so the threshold is one batch; 12 batches beat 8 and 16 over the
// series-ordered and the random layouts together.
// A warp takes one chunk, chunk-major (the warps in flight gather from a
// few chunks' rows, which stay in L2), and the block scheduler hands the
// blocks out as earlier ones finish, so a warp with a long stream holds
// up only its own block; a persistent grid-stride walk over the chunks
// was slower on the card in both layouts. The max/min form folds a warp's
// 32 segment results in block order (an in-order shuffle tree) into one
// partial per (group, chunk), and a second kernel folds a group's chunk
// partials in order: it reads 1/32 of what a partial per segment would be.
//
// Column tree sum. One launch does every level: a block reduces a slab of
// kSlab = 1024 rows of a tile of columns through two levels (32-row chunk
// sums, then the slab's sum of its chunk sums, in shared memory); with one
// slab that is the result, else it stores the slab sum, and the last block
// of the column tile to arrive (an arrival count kept at 0 between
// launches) runs the remaining levels over the slab sums, ping-ponging
// between two halves of the scratch. Bound on this card: bytes (4 a
// value read, 4 a column written).
//
// The kernels launch on the caller's stream and allocate nothing; the
// wrapper (greptimedb_tpu_torch/parallel/kernels/grouped_reduce.py) owns
// the outputs and the scratch and checks the launch status these
// functions return.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// a segment of at least this many rows makes its warp stream all 32 of its
// chunk's segments together (grouped_reduce.py _WARP_ROWS)
constexpr int kWarpRows = 32;
constexpr int kBatches = 12;            // 32-row batches a warp stages
constexpr int kChunk = 32 * kBatches;   // rows of one staged chunk
constexpr int kLaneRows = 16;           // rows a lane walking alone loads
constexpr int kTree = 32;               // rows of a chunk of the column tree
constexpr int kSlab = kTree * kTree;    // rows of a slab: two tree levels
constexpr int kTileCols = 8;            // columns of a column tree block

// the forms of the segment walk
constexpr int kSum = 0;
constexpr int kMaxForm = 1;
constexpr int kMinForm = 2;

// XLA's maximum / minimum on float32 as XLA:CPU computes them (copy of
// ring_fold.cu ext_f32); on int32 the plain extreme.
template <bool kMax>
__device__ __forceinline__ float ext(float a, float x) {
  int32_t ab = __float_as_int(a);
  int32_t xb = __float_as_int(x);
  bool neg = ab < 0;  // sign bit of a
  int32_t pb, qb;
  if (kMax) {
    pb = neg ? ab : xb;
    qb = neg ? xb : ab;
  } else {
    pb = neg ? xb : ab;
    qb = neg ? ab : xb;
  }
  float p = __int_as_float(pb);
  float q = __int_as_float(qb);
  bool take_p = kMax ? (p > q) : (p < q);
  return __int_as_float((isnan(p) || take_p) ? pb : qb);
}

// the same on float64: XLA:CPU lowers maximum/minimum on doubles as on
// floats (the pair ordered by the sign bit of acc, a NaN first operand
// wins), so the bits follow the same rule at 64 bits
template <bool kMax>
__device__ __forceinline__ double ext(double a, double x) {
  long long ab = __double_as_longlong(a);
  long long xb = __double_as_longlong(x);
  bool neg = ab < 0;  // sign bit of a
  long long pb, qb;
  if (kMax) {
    pb = neg ? ab : xb;
    qb = neg ? xb : ab;
  } else {
    pb = neg ? xb : ab;
    qb = neg ? ab : xb;
  }
  double p = __longlong_as_double(pb);
  double q = __longlong_as_double(qb);
  bool take_p = kMax ? (p > q) : (p < q);
  return __longlong_as_double((isnan(p) || take_p) ? pb : qb);
}

template <bool kMax>
__device__ __forceinline__ int32_t ext(int32_t a, int32_t x) {
  return kMax ? (a > x ? a : x) : (a < x ? a : x);
}

template <typename T, bool kMax>
__device__ __forceinline__ T ext_identity() {
  if constexpr (std::is_floating_point_v<T>) {
    return kMax ? -INFINITY : INFINITY;
  } else {
    return kMax ? INT32_MIN : INT32_MAX;
  }
}

// what a segment starts from, and one row onto it
template <typename T, int kForm>
__device__ __forceinline__ T start() {
  if constexpr (kForm == kSum) {
    return T(0);
  } else {
    return ext_identity<T, kForm == kMaxForm>();
  }
}

template <typename T, int kForm>
__device__ __forceinline__ T step(T acc, T x) {
  if constexpr (kForm == kSum && std::is_same_v<T, double>) {
    return __dadd_rn(acc, x);
  } else if constexpr (kForm == kSum) {
    return __fadd_rn(acc, x);
  } else {
    return ext<kForm == kMaxForm>(acc, x);
  }
}

// One lane's segment perm[k0 .. k1), alone: kLaneRows member loads, then
// their value loads, then the adds in row order.
template <typename T, int kForm>
__device__ __forceinline__ T lane_walk(const T* __restrict__ v,
                                       const int32_t* __restrict__ perm,
                                       int k0, int k1) {
  T acc = start<T, kForm>();
  for (int k = k0; k < k1; k += kLaneRows) {
    int idx[kLaneRows];
    T x[kLaneRows];
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      idx[u] = k + u < k1 ? __ldg(perm + k + u) : 0;
    }
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      x[u] = k + u < k1 ? __ldg(v + idx[u]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kLaneRows; ++u) {
      if (k + u < k1) acc = step<T, kForm>(acc, x[u]);
    }
  }
  return acc;
}

// The member indices of stream rows [k, k + kChunk) below k_end: lane j
// holds rows k + 32u + j (-1 past the end).
__device__ __forceinline__ void load_members(int (&idx)[kBatches],
                                             const int32_t* __restrict__ perm,
                                             int k, int k_end, int lane) {
#pragma unroll
  for (int u = 0; u < kBatches; ++u) {
    const int r = k + 32 * u + lane;
    idx[u] = r < k_end ? __ldg(perm + r) : -1;
  }
}

template <typename T>
__device__ __forceinline__ void load_values(T (&x)[kBatches],
                                            const int (&idx)[kBatches],
                                            const T* __restrict__ v) {
#pragma unroll
  for (int u = 0; u < kBatches; ++u) {
    x[u] = idx[u] >= 0 ? __ldg(v + idx[u]) : T(0);
  }
}

// acc + stage[i] + ... + stage[e - 1], in order, on every lane (the sum
// form: the chain of adds is the one dependency; reads are broadcasts)
__device__ __forceinline__ float fold_piece_sum(float acc,
                                                const float* __restrict__ st,
                                                int i, int e) {
  for (; i < e && (i & 3); ++i) acc = __fadd_rn(acc, st[i]);
#pragma unroll 4
  for (; i + 4 <= e; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(st + i);
    acc = __fadd_rn(acc, f.x);
    acc = __fadd_rn(acc, f.y);
    acc = __fadd_rn(acc, f.z);
    acc = __fadd_rn(acc, f.w);
  }
  for (; i < e; ++i) acc = __fadd_rn(acc, st[i]);
  return acc;
}

// the same in float64: a stage row of doubles, read one at a time
__device__ __forceinline__ double fold_piece_sum(double acc,
                                                 const double* __restrict__ st,
                                                 int i, int e) {
  for (; i < e; ++i) acc = __dadd_rn(acc, st[i]);
  return acc;
}

// the extreme of acc and stage[i .. e) (e > i), on every lane: lane t folds
// a contiguous run of the piece, then the runs fold in lane order
template <typename T, bool kMax>
__device__ __forceinline__ T fold_piece_ext(T acc, const T* __restrict__ st,
                                            int i, int e, int lane) {
  const int len = e - i;
  const int per = (len + 31) >> 5;
  const int a = i + lane * per;
  const int b = a + per < e ? a + per : e;
  T r = ext_identity<T, kMax>();
  if (a < b) {
    r = st[a];
    for (int t = a + 1; t < b; ++t) r = ext<kMax>(r, st[t]);
  }
  const int runs = (len + per - 1) / per;   // lanes holding a run: a prefix
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_down_sync(kFull, r, d);
    if ((lane & (2 * d - 1)) == 0 && lane + d < runs) r = ext<kMax>(r, y);
  }
  return ext<kMax>(acc, __shfl_sync(kFull, r, 0));
}

// The warp's segments 0 .. nseg - 1 as one stream of rows perm[k_beg ..
// k_end): segment j ends at lane j's seg_end. Returns the lane's segment
// value (lanes from nseg on: the start value).
template <typename T, int kForm>
__device__ __forceinline__ T warp_stream(const T* __restrict__ v,
                                         const int32_t* __restrict__ perm,
                                         int my_end, int k_beg, int k_end,
                                         int nseg, T* __restrict__ stage,
                                         int lane) {
  T mine = start<T, kForm>();
  T acc = mine;
  int j = 0;
  int seg_end = __shfl_sync(kFull, my_end, 0);
  int idx[kBatches];
  T x[kBatches];
  load_members(idx, perm, k_beg, k_end, lane);
  load_values(x, idx, v);
  load_members(idx, perm, k_beg + kChunk, k_end, lane);
  for (int k = k_beg; k < k_end; k += kChunk) {
    const int n = k_end - k < kChunk ? k_end - k : kChunk;
    __syncwarp();   // every lane is done with the previous chunk
#pragma unroll
    for (int u = 0; u < kBatches; ++u) stage[32 * u + lane] = x[u];
    __syncwarp();
    // the next chunk's values and the one after's members fly while this
    // chunk folds
    load_values(x, idx, v);
    load_members(idx, perm, k + 2 * kChunk, k_end, lane);
    int i = 0;
    for (;;) {
      // close every segment that ends here (empty ones keep the start)
      while (j < nseg && seg_end == k + i) {
        if (lane == j) mine = acc;
        acc = start<T, kForm>();
        ++j;
        seg_end = __shfl_sync(kFull, my_end, j < nseg ? j : 0);
        if (j >= nseg) seg_end = k_end;
      }
      if (i == n) break;
      const int e = seg_end - k < n ? seg_end - k : n;
      if constexpr (kForm == kSum) {
        acc = fold_piece_sum(acc, stage, i, e);
      } else {
        acc = fold_piece_ext<T, kForm == kMaxForm>(acc, stage, i, e, lane);
      }
      i = e;
    }
  }
  return mine;
}

// kForm kSum: out[b * gb + g] = the sum of segment (g, b); kMaxForm,
// kMinForm: out[g * chunks + c] = the extreme of the segments of group g
// in blocks 32c .. 32c + 31. Warp w owns group g = w % gb of chunk
// c = w / gb (chunk-major: the warps in flight gather from a few chunks'
// rows at a time, which stay in L2).
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const T* __restrict__ v,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ ptr,
                    T* __restrict__ out, int gb, int blocks, int chunks) {
  __shared__ __align__(16) T stage_s[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  T* stage = stage_s[wib];
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + wib;
  if (w >= static_cast<long long>(gb) * chunks) return;
  const int c = static_cast<int>(w / gb);
  const int g = static_cast<int>(w - static_cast<long long>(c) * gb);
  const int nseg = blocks - 32 * c < 32 ? blocks - 32 * c : 32;
  const long long s0 = static_cast<long long>(g) * blocks + 32 * c;
  // lanes past the group's last block hold an empty segment at the end
  const int k0 = __ldg(ptr + s0 + (lane < nseg ? lane : nseg));
  const int k1 = __ldg(ptr + s0 + (lane < nseg ? lane + 1 : nseg));
  T r;
  if (__ballot_sync(kFull, k1 - k0 >= kWarpRows)) {
    r = warp_stream<T, kForm>(v, perm, k1, __shfl_sync(kFull, k0, 0),
                              __shfl_sync(kFull, k1, 31), nseg, stage,
                              lane);
  } else {
    r = lane_walk<T, kForm>(v, perm, k0, k1);
  }
  if constexpr (kForm == kSum) {
    if (lane < nseg) out[static_cast<long long>(32 * c + lane) * gb + g] = r;
  } else {
    // the chunk's segments in block order: an in-order shuffle tree
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_down_sync(kFull, r, d);
      if ((lane & (2 * d - 1)) == 0 && lane + d < nseg) {
        r = ext<kForm == kMaxForm>(r, y);
      }
    }
    if (lane == 0) out[static_cast<long long>(g) * chunks + c] = r;
  }
}

// One block per group: out[g] = the in-order fold of part[g * chunks ..
// (g + 1) * chunks). Thread t folds a contiguous run of chunks, then the
// runs combine pairwise in order (left operand first).
template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
group_fold_kernel(const T* __restrict__ part, T* __restrict__ out,
                  int chunks) {
  __shared__ T acc_s[kThreads];
  const T* row = part + static_cast<long long>(blockIdx.x) * chunks;
  int per = (chunks + kThreads - 1) / kThreads;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, chunks);
  T acc = ext_identity<T, kMax>();
  for (int b = lo; b < hi; ++b) acc = ext<kMax>(acc, row[b]);
  acc_s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = 1; stride < kThreads; stride *= 2) {
    if (threadIdx.x % (2 * stride) == 0) {
      acc_s[threadIdx.x] =
          ext<kMax>(acc_s[threadIdx.x], acc_s[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc_s[0];
}

// 0 + src[a * cols + j] + ... over the rows a .. min(a + 32, n) - 1 of
// column j, in order (cg: read through L2, for values other blocks wrote)
template <bool kCg>
__device__ __forceinline__ float chunk_sum(const float* __restrict__ src,
                                           long long a, long long n, int cols,
                                           int j) {
  float x[kTree];
#pragma unroll
  for (int r = 0; r < kTree; ++r) {
    const float* p = src + (a + r) * cols + j;
    x[r] = a + r < n ? (kCg ? __ldcg(p) : __ldg(p)) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kTree; ++r) {
    if (a + r < n) acc = __fadd_rn(acc, x[r]);
  }
  return acc;
}

// Every level of the column tree sum in one launch. Grid (column tiles of
// `tile` columns, slabs of kSlab rows); thread t serves column t % tile of
// the tile and chunk lane t / tile.
__global__ void __launch_bounds__(kThreads)
column_tree_kernel(const float* __restrict__ x, float* __restrict__ out,
                   float* __restrict__ part, unsigned int* __restrict__ count,
                   long long rows, int cols, int tile) {
  __shared__ float sums[kTree][kTree + 1];   // the slab's chunk sums
  __shared__ bool last;
  const int tx = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const int lanes = kThreads / tile;
  const int col = blockIdx.x * tile + tx;
  const bool on = col < cols;
  const int slabs = gridDim.y;
  const long long r0 = static_cast<long long>(blockIdx.y) * kSlab;
  const long long r1 = r0 + kSlab < rows ? r0 + kSlab : rows;
  const int nchunks = static_cast<int>((r1 - r0 + kTree - 1) / kTree);
  // level 0: the slab's 32-row chunks
  for (int c = ty; c < nchunks; c += lanes) {
    if (on) {
      sums[c][tx] = chunk_sum<false>(x, r0 + static_cast<long long>(c) * kTree,
                                     r1, cols, col);
    }
  }
  __syncthreads();
  if (rows <= kTree) {   // one level: the one chunk sum is the result
    if (ty == 0 && on) out[col] = sums[0][tx];
    return;
  }
  // level 1: the slab's sum of its chunk sums, from 0
  if (ty == 0 && on) {
    float acc = 0.0f;
    for (int c = 0; c < nchunks; ++c) acc = __fadd_rn(acc, sums[c][tx]);
    if (slabs == 1) {
      out[col] = acc;
    } else {
      __stcg(part + static_cast<long long>(blockIdx.y) * cols + col, acc);
    }
  }
  if (slabs == 1) return;
  // one arrival per slab; the last block of the column tile runs the rest
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&count[blockIdx.x], 1u) ==
           static_cast<unsigned int>(slabs - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) count[blockIdx.x] = 0u;
  // the slab sums, then each level's chunk sums: levels of more than
  // kSlab values alternate between the scratch's two halves, the level
  // that leaves at most 32 chunk sums goes to shared memory, and the last
  // level sums those
  const float* src = part;
  float* dst = part + static_cast<long long>(slabs) * cols;
  long long n = slabs;
  while (n > kSlab) {
    const long long m = (n + kTree - 1) / kTree;
    for (long long c = ty; c < m; c += lanes) {
      if (on) __stcg(dst + c * cols + col,
                     chunk_sum<true>(src, c * kTree, n, cols, col));
    }
    __syncthreads();
    float* t = const_cast<float*>(src);
    src = dst;
    dst = t;
    n = m;
  }
  const int m = static_cast<int>((n + kTree - 1) / kTree);
  for (int c = ty; c < m; c += lanes) {
    if (on) sums[c][tx] = chunk_sum<true>(src, c * kTree, n, cols, col);
  }
  __syncthreads();
  if (ty == 0 && on) {
    if (m == 1) {
      out[col] = sums[0][tx];
    } else {
      float acc = 0.0f;
      for (int c = 0; c < m; ++c) acc = __fadd_rn(acc, sums[c][tx]);
      out[col] = acc;
    }
  }
}

template <typename T, int kForm>
int launch_walk(const void* v, const void* perm, const void* ptr, void* out,
                int gb, int blocks, cudaStream_t st) {
  const int chunks = (blocks + 31) / 32;
  const long long grid = (static_cast<long long>(gb) * chunks + kWarps - 1) /
                         kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_walk_kernel<T, kForm><<<static_cast<unsigned int>(grid), kThreads,
                                  0, st>>>(
      static_cast<const T*>(v), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(ptr), static_cast<T*>(out), gb, blocks,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_extreme(const void* v, const void* perm, const void* ptr,
                   void* part, void* out, int gb, int blocks, int take_max,
                   void* stream) {
  if (gb <= 0 || blocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (blocks + 31) / 32;
  int rc = take_max
               ? launch_walk<T, kMaxForm>(v, perm, ptr, part, gb, blocks, st)
               : launch_walk<T, kMinForm>(v, perm, ptr, part, gb, blocks, st);
  if (rc) return rc;
  const T* pa = static_cast<const T*>(part);
  T* o = static_cast<T*>(out);
  if (take_max) {
    group_fold_kernel<T, true><<<gb, kThreads, 0, st>>>(pa, o, chunks);
  } else {
    group_fold_kernel<T, false><<<gb, kThreads, 0, st>>>(pa, o, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtt_grouped_block_sum(const void* v, const void* perm,
                                     const void* ptr, void* out, int gb,
                                     int blocks, void* stream) {
  if (gb <= 0 || blocks <= 0) return 0;
  return launch_walk<float, kSum>(v, perm, ptr, out, gb, blocks,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int gtt_grouped_block_sum_f64(const void* v, const void* perm,
                                         const void* ptr, void* out, int gb,
                                         int blocks, void* stream) {
  if (gb <= 0 || blocks <= 0) return 0;
  return launch_walk<double, kSum>(v, perm, ptr, out, gb, blocks,
                                   static_cast<cudaStream_t>(stream));
}

// part: gb * ceil(blocks / 32) values of the input's type
extern "C" int gtt_grouped_extreme_f32(const void* v, const void* perm,
                                       const void* ptr, void* part, void* out,
                                       int gb, int blocks, int take_max,
                                       void* stream) {
  return launch_extreme<float>(v, perm, ptr, part, out, gb, blocks, take_max,
                               stream);
}

extern "C" int gtt_grouped_extreme_f64(const void* v, const void* perm,
                                       const void* ptr, void* part, void* out,
                                       int gb, int blocks, int take_max,
                                       void* stream) {
  return launch_extreme<double>(v, perm, ptr, part, out, gb, blocks, take_max,
                                stream);
}

extern "C" int gtt_grouped_extreme_i32(const void* v, const void* perm,
                                       const void* ptr, void* part, void* out,
                                       int gb, int blocks, int take_max,
                                       void* stream) {
  return launch_extreme<int32_t>(v, perm, ptr, part, out, gb, blocks,
                                 take_max, stream);
}

// part: (slabs + ceil(slabs / 32)) * cols floats, slabs = ceil(rows /
// 1024) (none with one slab); count: one zeroed unsigned int a column
// tile (one a column will do), left at 0
extern "C" int gtt_column_tree_sum(const void* x, void* out, void* part,
                                   void* count, long long rows, int cols,
                                   void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long slabs = (rows + kSlab - 1) / kSlab;
  if (slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // narrow tiles: more blocks over the rows (a warp still reads whole
  // 32-byte sectors of a row)
  int tile = 1;
  while (tile < cols && tile < kTileCols) tile *= 2;
  dim3 grid(static_cast<unsigned int>((cols + tile - 1) / tile),
            static_cast<unsigned int>(slabs));
  column_tree_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<unsigned int*>(count), rows,
      cols, tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
