// G: the GROUP BY's fixed-order grouped reduce, and Gt: its column sum.
//
// Replaces the segment reductions of the JAX package's fused GROUP BY
// program (greptimedb_tpu/query/reduce.py _fused_program:216), which XLA
// computes outside any Pallas kernel:
//
//   sum form  (pseg2:250, jax.ops.segment_sum into gb * blocks segments)
//     out[b, g] = 0 + v[i0] + v[i1] + ...   over the live rows i of block b
//                                            with gid[i] == g, ascending i
//   max / min form  (:278, jax.ops.segment_max / segment_min; also the
//   int32 extremes of the first/last winner stages, :296)
//     out[g] = fold of XLA's max / min from -inf / +inf (int32: its least
//              or greatest value) over the live rows of group g,
//              ascending i
//   column tree sum  (:274, jnp.sum(sp, axis=0) over (blocks, gb))
//     XLA:CPU rewrites a reduction over more than 32 rows into chunks of
//     32 rows, each summed in order from 0, then reduces the chunk sums
//     the same way until one chunk is left; one launch here is one level
//     of that tree (blocks is a power of two, so every level above the
//     last has a multiple of 32 rows).
//
// XLA:CPU's scatter adds each segment's rows one after the other in row
// order, and the bit contract rests on that order. CUDA's atomics
// (index_add_, scatter_add_, scatter_reduce) add in no fixed order, so
// these sums need their own kernel even on one card: here one thread owns
// one segment and walks its member rows in ascending order, which fixes
// the order by construction. Adds are __fadd_rn, never contracted.
//
// The extreme is XLA's maximum/minimum as XLA:CPU lowers it (NaN
// propagates, -0.0 orders below +0.0, which NaN survives follows the sign
// of the accumulator; see ring_fold.cu ext_f32). That fold is
// associative: its value over a sequence is the first NaN whose sign makes
// it sticky (negative for max, positive for min), else the last NaN, else
// the extreme with -0.0 below +0.0, and the same rule combines the values
// of two consecutive pieces. So the max/min form folds each (block,
// group) segment in row order into scratch (the same member walk as the
// sum form) and then folds a group's segments in block order as an
// in-order tree: the bits equal the one sequential fold.
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
// 145 MB, 0.043 ms at 3.35 TB/s. Design of this first version: one
// thread a segment (segments hold ~16-60 rows at the TSBS shapes), threads
// of a warp on consecutive segments, so their member reads share cache
// lines and the value gathers stay inside one row block.
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

// kForm 0: sum (float) into out[b * gb + g]; 1: max, 2: min into part[s].
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const T* __restrict__ v,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ ptr,
                    T* __restrict__ out, int gb, int blocks) {
  long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long nseg = static_cast<long long>(gb) * blocks;
  if (s >= nseg) return;
  int k0 = ptr[s];
  int k1 = ptr[s + 1];
  T acc = kForm == 0 ? T(0) : ext_identity<T, kForm == 1>();
  for (int k = k0; k < k1; ++k) {
    T x = __ldg(v + perm[k]);
    if constexpr (kForm == 0) {
      acc = __fadd_rn(acc, x);
    } else {
      acc = ext<kForm == 1>(acc, x);
    }
  }
  if constexpr (kForm == 0) {
    long long g = s / blocks;
    long long b = s - g * blocks;
    out[b * gb + g] = acc;
  } else {
    out[s] = acc;
  }
}

// One block per group: out[g] = the in-order fold of part[g * blocks ..
// (g + 1) * blocks). Thread t folds a contiguous run of segments, then the
// runs combine pairwise in order (left operand first).
template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
group_fold_kernel(const T* __restrict__ part, T* __restrict__ out,
                  int blocks) {
  __shared__ T acc_s[kThreads];
  const T* row = part + static_cast<long long>(blockIdx.x) * blocks;
  int per = (blocks + kThreads - 1) / kThreads;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, blocks);
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

// One level of the column tree sum: y[c, j] = 0 + x[32c, j] + ... +
// x[32c + 31, j] (the rows that exist).
__global__ void __launch_bounds__(kThreads)
tree_level_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long rows, int cols) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long chunks = (rows + 31) / 32;
  if (t >= chunks * cols) return;
  long long c = t / cols;
  long long j = t - c * cols;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    long long i = c * 32 + r;
    if (i < rows) acc = __fadd_rn(acc, x[i * cols + j]);
  }
  y[t] = acc;
}

unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_extreme(const void* v, const void* perm, const void* ptr,
                   void* part, void* out, int gb, int blocks, int take_max,
                   void* stream) {
  long long nseg = static_cast<long long>(gb) * blocks;
  if (nseg <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* vv = static_cast<const T*>(v);
  const int32_t* pp = static_cast<const int32_t*>(perm);
  const int32_t* pt = static_cast<const int32_t*>(ptr);
  T* pa = static_cast<T*>(part);
  T* o = static_cast<T*>(out);
  if (take_max) {
    segment_walk_kernel<T, 1><<<grid_for(nseg), kThreads, 0, st>>>(
        vv, pp, pt, pa, gb, blocks);
  } else {
    segment_walk_kernel<T, 2><<<grid_for(nseg), kThreads, 0, st>>>(
        vv, pp, pt, pa, gb, blocks);
  }
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  if (take_max) {
    group_fold_kernel<T, true><<<gb, kThreads, 0, st>>>(pa, o, blocks);
  } else {
    group_fold_kernel<T, false><<<gb, kThreads, 0, st>>>(pa, o, blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtt_grouped_block_sum(const void* v, const void* perm,
                                     const void* ptr, void* out, int gb,
                                     int blocks, void* stream) {
  long long nseg = static_cast<long long>(gb) * blocks;
  if (nseg <= 0) return 0;
  segment_walk_kernel<float, 0><<<grid_for(nseg), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(ptr), static_cast<float*>(out), gb, blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gtt_grouped_extreme_f32(const void* v, const void* perm,
                                       const void* ptr, void* part, void* out,
                                       int gb, int blocks, int take_max,
                                       void* stream) {
  return launch_extreme<float>(v, perm, ptr, part, out, gb, blocks, take_max,
                               stream);
}

extern "C" int gtt_grouped_extreme_i32(const void* v, const void* perm,
                                       const void* ptr, void* part, void* out,
                                       int gb, int blocks, int take_max,
                                       void* stream) {
  return launch_extreme<int32_t>(v, perm, ptr, part, out, gb, blocks,
                                 take_max, stream);
}

extern "C" int gtt_column_tree_level(const void* x, void* y, long long rows,
                                     int cols, void* stream) {
  long long n = (rows + 31) / 32 * cols;
  if (n <= 0) return 0;
  tree_level_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
