// The blocked group fold's seed and the elementwise ring combines.
//
// K2 (blocked_fold_sum), the seed of the fold:
//
//   part[b][grp, c] = sum over member sids s of (b, grp), ascending: arr[s, c]
//   out = part[0] + part[1] + ... + part[fb-1]
//
// Replaces device_range._fold_groups.blocked_sum of the JAX package
// (jax.ops.segment_sum into fb series blocks) together with the body of
// the Pallas kernel greptimedb_tpu/parallel/kernels/ring_fold.py
// _fold_seed_kernel (shard 0 of the ring, and the single-card fold). Its
// continuation (fold_cont) and unfolded (block_partials) forms are forms of
// the pipelined member walk in csrc/ring_fold_fused.cu. The fixed order of
// float additions is the contract: every block partial starts at 0 and
// adds its members in ascending sid order (segment_sum's order as XLA's
// scatter runs it), and the partials fold left to right from block 0's
// partial (never 0 + partial). CUDA's atomics (index_add_, scatter_add_)
// add in no fixed order, so this sum needs its own kernel; here each
// thread owns one (group, cell) and walks its members sequentially, which
// fixes the order by construction.
//
// Bound on this card: bytes. Every input element is read once and every
// output element written once: 4 * m * nb for the member rows, 4 * g * nb
// for the output. Design: one thread per (group, cell), cells fastest, so
// the threads of a warp share a member list (broadcast loads of member[])
// and read 32 consecutive cells of one series row (coalesced). At the
// one-device Q2 shape it reaches more than half its bound on this card
// (PERF.md), so it keeps its one dependent load per row.
//
// Members come as CSR over (block, group): member[ptr[b * g + grp] ..
// ptr[b * g + grp + 1]) are the sids of group grp inside series block b,
// ascending. Sids routed past g (inactive) are simply not listed.
//
// extreme and onehot_add are the hop combines of the ring's extreme and
// one-hot sum (ring_fold.py _ext_max_kernel, _ext_min_kernel, _add_kernel
// of the JAX package): out = max(acc, x), min(acc, x) or acc + x over
// (g, nb) elements. Both are pure elementwise passes bound by bytes
// (3 * 4 * g * nb) and, at the range path's (9, 2160), by launch latency.
// The float extreme reproduces jnp.maximum/minimum as XLA:CPU computes them
// (LLVM's x86 lowering of llvm.maximum/minimum), bit for bit: NaN
// propagates, -0.0 orders below +0.0, and which NaN comes out follows the
// sign of acc. CUDA's fmaxf/fminf return the non-NaN operand instead, so
// the choice is written out as selections on bit patterns.
//
// pext_ring and psum_onehot_ring are the same combines over a whole ring
// in one launch, for shards whose planes lie on one card: they replace the
// chain of _ext_max_kernel:53, _ext_min_kernel:59 or _add_kernel:65
// through _call2:80 that ring_pext:109 and ring_psum_onehot:122 of
// greptimedb_tpu/parallel/kernels/ring_fold.py run hop by hop. Per element,
//
//   acc = x[0]; acc = comb(acc, x[s]) for s = 1 .. ns - 1; out = acc
//
// the hop ring's left chain in shard order. The float extreme's sign-bit
// rule returns the first NaN in shard order, so the shards are never
// reordered; the one-hot sum rounds in the chain's order and starts from
// shard 0's value (not from 0), so a -0.0 winner comes out +0.0 exactly
// as in the hop ring and in psum. The shard
// pointers travel by value in the kernel's parameters (RingPlanes), filled
// by the C launcher from a host array. Bound on this card: bytes,
// 4 * (ns + 1) * g * nb (ns planes in, one out): 389 KB, 0.116 us at
// 3.35 TB/s at the range path's (9, 2160) x 4 shards, below any launch's
// floor. So the design aims at one launch per ring, not at the bound:
// ns - 1 hop launches (and their host-side ctypes calls) become one. A
// thread takes 4 consecutive elements with 16-byte loads when every
// pointer is 16-byte aligned (n % 4 elements then go one per thread),
// one element otherwise; 256 threads a block.
//
// noop is an empty kernel: the floor of a launch through the same bound
// ctypes path.
//
// The kernels launch on the caller's stream and allocate nothing; the
// wrappers (greptimedb_tpu_torch/parallel/kernels/ring_fold.py) own the
// outputs and check the launch status these functions return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void fold_kernel(const T* __restrict__ arr,
                            const int32_t* __restrict__ member,
                            const int32_t* __restrict__ ptr,
                            T* __restrict__ out, int g, int fb, int nb) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long plane = static_cast<long long>(g) * nb;
  if (t >= plane) return;
  int grp = static_cast<int>(t / nb);
  int cell = static_cast<int>(t - static_cast<long long>(grp) * nb);
  T total = T(0);
  for (int b = 0; b < fb; ++b) {
    int k0 = ptr[b * g + grp];
    int k1 = ptr[b * g + grp + 1];
    T part = T(0);
    for (int k = k0; k < k1; ++k) {
      part = part + arr[static_cast<long long>(member[k]) * nb + cell];
    }
    total = b == 0 ? part : total + part;
  }
  out[t] = total;
}

template <typename T>
int launch_fold(const void* arr, const void* member, const void* ptr,
                void* out, int g, int fb, int nb, void* stream) {
  long long plane = static_cast<long long>(g) * nb;
  if (plane <= 0) return 0;
  const int threads = 256;
  long long blocks = (plane + threads - 1) / threads;
  fold_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(arr), static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(ptr), static_cast<T*>(out), g, fb, nb);
  return static_cast<int>(cudaGetLastError());
}

// jnp.maximum(a, x) / jnp.minimum(a, x) as XLA:CPU computes them: order
// the pair by the sign bit of a, compare, and let a NaN first operand win.
template <bool kMax>
__device__ __forceinline__ float ext_f32(float a, float x) {
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
__global__ void extreme_f32_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ x,
                                   float* __restrict__ out, long long n) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = ext_f32<kMax>(acc[i], x[i]);
}

template <bool kMax>
__global__ void extreme_i32_kernel(const int32_t* __restrict__ acc,
                                   const int32_t* __restrict__ x,
                                   int32_t* __restrict__ out, long long n) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    int32_t a = acc[i];
    int32_t b = x[i];
    out[i] = kMax ? (a > b ? a : b) : (a < b ? a : b);
  }
}

__global__ void onehot_add_kernel(const float* __restrict__ acc,
                                  const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(acc[i], x[i]);
}

unsigned int grid_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// ---- one launch per ring ------------------------------------------------

constexpr int kMaxShards = 8;     // ring_fold.py _MAX_SHARDS
constexpr int kRingThreads = 256;

enum RingOp { kMaxF32 = 0, kMinF32 = 1, kMaxI32 = 2, kMinI32 = 3,
              kAddF32 = 4 };

template <typename T>
struct RingPlanes {
  const T* x[kMaxShards];         // (g, nb) per shard, in shard order
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

template <int kOp, typename T>
__device__ __forceinline__ T comb(T acc, T x) {
  if constexpr (kOp == kMaxF32) {
    return ext_f32<true>(acc, x);
  } else if constexpr (kOp == kMinF32) {
    return ext_f32<false>(acc, x);
  } else if constexpr (kOp == kMaxI32) {
    return acc > x ? acc : x;
  } else if constexpr (kOp == kMinI32) {
    return acc < x ? acc : x;
  } else {
    return __fadd_rn(acc, x);
  }
}

template <int kOp, typename V>
__device__ __forceinline__ V comb4(V acc, V x) {
  acc.x = comb<kOp>(acc.x, x.x);
  acc.y = comb<kOp>(acc.y, x.y);
  acc.z = comb<kOp>(acc.z, x.z);
  acc.w = comb<kOp>(acc.w, x.w);
  return acc;
}

// kVec: threads [0, n / 4) take 4 elements each with 16-byte loads, the
// next n % 4 threads one element each; otherwise one element a thread.
template <typename T, int kOp, bool kVec>
__global__ void __launch_bounds__(kRingThreads)
ring_combine_kernel(RingPlanes<T> in, T* __restrict__ out, int ns,
                    long long n) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    using V = typename Vec4<T>::type;
    long long n4 = n >> 2;
    if (i < n4) {
      V acc = __ldg(reinterpret_cast<const V*>(in.x[0]) + i);
#pragma unroll
      for (int s = 1; s < kMaxShards; ++s) {
        if (s < ns) {
          acc = comb4<kOp>(acc, __ldg(reinterpret_cast<const V*>(in.x[s]) + i));
        }
      }
      reinterpret_cast<V*>(out)[i] = acc;
      return;
    }
    i = (n4 << 2) + (i - n4);
  }
  if (i >= n) return;
  T acc = __ldg(in.x[0] + i);
#pragma unroll
  for (int s = 1; s < kMaxShards; ++s) {
    if (s < ns) acc = comb<kOp>(acc, __ldg(in.x[s] + i));
  }
  out[i] = acc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int kOp>
int launch_ring_combine(const void* const* xs, void* out, int ns,
                        long long n, void* stream) {
  if (ns < 1 || ns > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  RingPlanes<T> in{};
  bool vec = aligned16(out);
  for (int s = 0; s < ns; ++s) {
    in.x[s] = static_cast<const T*>(xs[s]);
    vec = vec && aligned16(xs[s]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* o = static_cast<T*>(out);
  if (vec) {
    long long work = (n >> 2) + (n & 3);
    ring_combine_kernel<T, kOp, true>
        <<<grid_for(work, kRingThreads), kRingThreads, 0, st>>>(in, o, ns, n);
  } else {
    ring_combine_kernel<T, kOp, false>
        <<<grid_for(n, kRingThreads), kRingThreads, 0, st>>>(in, o, ns, n);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" int gtt_blocked_fold_sum_f32(const void* arr, const void* member,
                                        const void* ptr, void* out, int g,
                                        int fb, int nb, void* stream) {
  return launch_fold<float>(arr, member, ptr, out, g, fb, nb, stream);
}

extern "C" int gtt_blocked_fold_sum_i32(const void* arr, const void* member,
                                        const void* ptr, void* out, int g,
                                        int fb, int nb, void* stream) {
  return launch_fold<int32_t>(arr, member, ptr, out, g, fb, nb, stream);
}

extern "C" int gtt_extreme_f32(const void* acc, const void* x, void* out,
                               long long n, int take_max, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* b = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (take_max) {
    extreme_f32_kernel<true><<<grid_for(n, threads), threads, 0, s>>>(a, b, o,
                                                                      n);
  } else {
    extreme_f32_kernel<false><<<grid_for(n, threads), threads, 0, s>>>(a, b,
                                                                       o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gtt_extreme_i32(const void* acc, const void* x, void* out,
                               long long n, int take_max, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(acc);
  const int32_t* b = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  if (take_max) {
    extreme_i32_kernel<true><<<grid_for(n, threads), threads, 0, s>>>(a, b, o,
                                                                      n);
  } else {
    extreme_i32_kernel<false><<<grid_for(n, threads), threads, 0, s>>>(a, b,
                                                                       o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gtt_onehot_add_f32(const void* acc, const void* x, void* out,
                                  long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  onehot_add_kernel<<<grid_for(n, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(x),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gtt_pext_ring_f32(const void* const* xs, void* out, int ns,
                                 long long n, int take_max, void* stream) {
  return take_max
             ? launch_ring_combine<float, kMaxF32>(xs, out, ns, n, stream)
             : launch_ring_combine<float, kMinF32>(xs, out, ns, n, stream);
}

extern "C" int gtt_pext_ring_i32(const void* const* xs, void* out, int ns,
                                 long long n, int take_max, void* stream) {
  return take_max
             ? launch_ring_combine<int32_t, kMaxI32>(xs, out, ns, n, stream)
             : launch_ring_combine<int32_t, kMinI32>(xs, out, ns, n, stream);
}

extern "C" int gtt_psum_onehot_ring_f32(const void* const* xs, void* out,
                                        int ns, long long n, void* stream) {
  return launch_ring_combine<float, kAddF32>(xs, out, ns, n, stream);
}

extern "C" int gtt_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
