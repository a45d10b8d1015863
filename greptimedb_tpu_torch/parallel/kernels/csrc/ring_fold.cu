// The blocked group fold and the elementwise ring combines.
//
// K2 (blocked_fold_sum), with its continuation (fold_cont) and unfolded
// (block_partials) forms:
//
//   part[b][grp, c] = sum over member sids s of (b, grp), ascending: arr[s, c]
//   seed:     out = part[0] + part[1] + ... + part[fb-1]
//   cont:     out = acc + part[0] + ... + part[fb-1]
//   partials: out[b] = part[b]
//
// Replaces device_range._fold_groups.blocked_sum of the JAX package
// (jax.ops.segment_sum into fb series blocks) together with the bodies of
// the Pallas kernels greptimedb_tpu/parallel/kernels/ring_fold.py
// _fold_seed_kernel (seed: shard 0 of the ring, and the single-card fold)
// and _fold_cont_kernel (cont: every later shard of the ring folds its own
// blocks onto the accumulator that arrived). The partials form feeds the
// gather twin (parallel/dist.ShardFoldCtx), which concatenates every
// shard's block partials and left-folds them. The fixed order of float
// additions is the contract: every block partial starts at 0 and adds its
// members in ascending sid order (segment_sum's order as XLA's scatter
// runs it), and the partials fold left to right — from block 0's partial
// (seed, never 0 + partial) or from the accumulator (cont). CUDA's atomics
// (index_add_, scatter_add_) add in no fixed order, so this sum needs its
// own kernel; here each thread owns one (group, cell) and walks its
// members sequentially, which fixes the order by construction.
//
// Bound on this card: bytes. Every input element is read once and every
// output element written once: 4 * m * nb for the member rows, 4 * g * nb
// for the output (twice for cont, which also reads acc; fb times for
// partials). Design: one thread per (group, cell), cells fastest, so the
// threads of a warp share a member list (broadcast loads of member[]) and
// read 32 consecutive cells of one series row (coalesced). Groups with
// many members serialise into a long dependent add chain per thread; that
// is the price of the fixed order and is left for a later, faster kernel.
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
// The kernels launch on the caller's stream and allocate nothing; the
// wrappers (greptimedb_tpu_torch/parallel/kernels/ring_fold.py) own the
// outputs and check the launch status these functions return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum FoldMode { kSeed = 0, kCont = 1, kPartials = 2 };

template <typename T, int kMode>
__global__ void fold_kernel(const T* __restrict__ arr,
                            const int32_t* __restrict__ member,
                            const int32_t* __restrict__ ptr,
                            const T* __restrict__ acc, T* __restrict__ out,
                            int g, int fb, int nb) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long plane = static_cast<long long>(g) * nb;
  if (t >= plane) return;
  int grp = static_cast<int>(t / nb);
  int cell = static_cast<int>(t - static_cast<long long>(grp) * nb);
  T total = kMode == kCont ? acc[t] : T(0);
  for (int b = 0; b < fb; ++b) {
    int k0 = ptr[b * g + grp];
    int k1 = ptr[b * g + grp + 1];
    T part = T(0);
    for (int k = k0; k < k1; ++k) {
      part = part + arr[static_cast<long long>(member[k]) * nb + cell];
    }
    if (kMode == kPartials) {
      out[b * plane + t] = part;
    } else {
      total = (kMode == kSeed && b == 0) ? part : total + part;
    }
  }
  if (kMode != kPartials) out[t] = total;
}

template <typename T, int kMode>
int launch_fold(const void* arr, const void* member, const void* ptr,
                const void* acc, void* out, int g, int fb, int nb,
                void* stream) {
  long long plane = static_cast<long long>(g) * nb;
  if (plane <= 0) return 0;
  const int threads = 256;
  long long blocks = (plane + threads - 1) / threads;
  fold_kernel<T, kMode><<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(arr), static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(ptr), static_cast<const T*>(acc),
      static_cast<T*>(out), g, fb, nb);
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

}  // namespace

extern "C" int gtt_blocked_fold_sum_f32(const void* arr, const void* member,
                                        const void* ptr, void* out, int g,
                                        int fb, int nb, void* stream) {
  return launch_fold<float, kSeed>(arr, member, ptr, nullptr, out, g, fb, nb,
                                   stream);
}

extern "C" int gtt_blocked_fold_sum_i32(const void* arr, const void* member,
                                        const void* ptr, void* out, int g,
                                        int fb, int nb, void* stream) {
  return launch_fold<int32_t, kSeed>(arr, member, ptr, nullptr, out, g, fb,
                                     nb, stream);
}

extern "C" int gtt_fold_cont_f32(const void* arr, const void* member,
                                 const void* ptr, const void* acc, void* out,
                                 int g, int fb, int nb, void* stream) {
  return launch_fold<float, kCont>(arr, member, ptr, acc, out, g, fb, nb,
                                   stream);
}

extern "C" int gtt_fold_cont_i32(const void* arr, const void* member,
                                 const void* ptr, const void* acc, void* out,
                                 int g, int fb, int nb, void* stream) {
  return launch_fold<int32_t, kCont>(arr, member, ptr, acc, out, g, fb, nb,
                                     stream);
}

extern "C" int gtt_block_partials_f32(const void* arr, const void* member,
                                      const void* ptr, void* out, int g,
                                      int fb, int nb, void* stream) {
  return launch_fold<float, kPartials>(arr, member, ptr, nullptr, out, g, fb,
                                       nb, stream);
}

extern "C" int gtt_block_partials_i32(const void* arr, const void* member,
                                      const void* ptr, void* out, int g,
                                      int fb, int nb, void* stream) {
  return launch_fold<int32_t, kPartials>(arr, member, ptr, nullptr, out, g,
                                         fb, nb, stream);
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

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
