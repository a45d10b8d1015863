// The topk candidate merge: one hop of the ring that combines every
// shard's per-step top-k candidates.
//
// Replaces the Pallas kernel greptimedb_tpu/parallel/kernels/topk_merge.py
// merge_candidates (body _merge_topk_kernel). Per row j (one output step)
// it merges the accumulator planes a (kk candidates: key f32, value f32,
// series index i32, presence bool) with a shard's local planes b (kl
// candidates), both keyed descending, into kk output slots:
//
//   a[i] lands in slot i + #(b > a[i])
//   b[j] lands in slot j + #(a >= b[j])      (ties go to the accumulator)
//
// and slots >= kk are dropped. The `>=` makes the merge the stable order of
// the shard-order concatenation, which is jax.lax.top_k's lower-index-wins
// rule, so the ring selects the same winners as a top-k over every shard's
// candidates. Each output slot receives the int32 SUM of the bit patterns
// of every source that lands on it (0 where none does), exactly as the
// Pallas body's one-hot `place` sums: for sorted inputs every slot gets one
// source, and for any other input the kernel still computes what the Pallas
// body computes. Planes move as int32 bit patterns, never through float
// arithmetic, so NaN payloads, -0.0 and -inf pass through unchanged;
// presence comes out as (sum of int32 presence) > 0. Keys compare as
// floats: -0.0 equals +0.0 and a NaN key compares false both ways.
//
// Bound on this card: a row's work is (kk + kl) rank counts of up to
// max(kk, kl) comparisons, and its bytes are 13 B per candidate in and
// out. At the PromQL path's shape (J = 8 steps, kk = kl = 100) one merge
// moves 31.2 KB, about 9 ns at 3.35 TB/s, so the kernel is bound by its
// launch. Design: one block per row with kk + kl threads (kk, kl <= the
// planner's pallas_max_k = 128 on the query path; at most 1024 threads).
// The row's keys are staged in shared memory, every source thread counts
// its rank over the other list there, and adds its four planes into the
// slot's shared int32 accumulators with shared-memory atomics (integer
// addition is exact in any order). Then the first kk threads write the
// slots out.
//
// The kernel launches on the caller's stream and allocates nothing; the
// wrapper (greptimedb_tpu_torch/parallel/kernels/topk_merge.py) owns the
// outputs and checks the launch status the C entry returns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__global__ void merge_topk_kernel(
    const float* __restrict__ a_key, const int32_t* __restrict__ a_val,
    const int32_t* __restrict__ a_idx, const uint8_t* __restrict__ a_pres,
    const float* __restrict__ b_key, const int32_t* __restrict__ b_val,
    const int32_t* __restrict__ b_idx, const uint8_t* __restrict__ b_pres,
    int32_t* __restrict__ o_key, int32_t* __restrict__ o_val,
    int32_t* __restrict__ o_idx, uint8_t* __restrict__ o_pres, int kk,
    int kl) {
  extern __shared__ int32_t smem[];
  float* ka = reinterpret_cast<float*>(smem);      // kk keys of a
  float* kb = ka + kk;                              // kl keys of b
  int32_t* slot = smem + kk + kl;                   // 4 planes of kk slots
  const long long row = blockIdx.x;
  const long long ra = row * kk;
  const long long rb = row * kl;
  const int t = threadIdx.x;
  if (t < kk) {
    ka[t] = a_key[ra + t];
  } else if (t < kk + kl) {
    kb[t - kk] = b_key[rb + (t - kk)];
  }
  for (int i = t; i < 4 * kk; i += blockDim.x) slot[i] = 0;
  __syncthreads();

  int pos = kk;  // dropped unless a source below sets it
  int32_t key = 0, val = 0, idx = 0, pres = 0;
  if (t < kk) {
    const float k = ka[t];
    pos = t;
    for (int j = 0; j < kl; ++j) pos += kb[j] > k ? 1 : 0;
    key = __float_as_int(k);
    val = a_val[ra + t];
    idx = a_idx[ra + t];
    pres = a_pres[ra + t];
  } else if (t < kk + kl) {
    const int j = t - kk;
    const float k = kb[j];
    pos = j;
    for (int i = 0; i < kk; ++i) pos += ka[i] >= k ? 1 : 0;
    key = __float_as_int(k);
    val = b_val[rb + j];
    idx = b_idx[rb + j];
    pres = b_pres[rb + j];
  }
  if (pos < kk) {
    atomicAdd(&slot[pos], key);
    atomicAdd(&slot[kk + pos], val);
    atomicAdd(&slot[2 * kk + pos], idx);
    atomicAdd(&slot[3 * kk + pos], pres);
  }
  __syncthreads();
  if (t < kk) {
    o_key[ra + t] = slot[t];
    o_val[ra + t] = slot[kk + t];
    o_idx[ra + t] = slot[2 * kk + t];
    o_pres[ra + t] = slot[3 * kk + t] > 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int gtt_merge_topk(const void* a_key, const void* a_val,
                              const void* a_idx, const void* a_pres,
                              const void* b_key, const void* b_val,
                              const void* b_idx, const void* b_pres,
                              void* o_key, void* o_val, void* o_idx,
                              void* o_pres, int rows, int kk, int kl,
                              void* stream) {
  if (rows <= 0) return 0;
  if (kk < 1 || kl < 0 || kk + kl > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int32_t) * (static_cast<size_t>(kk) + kl +
                                         4 * static_cast<size_t>(kk));
  merge_topk_kernel<<<rows, kk + kl, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_key), static_cast<const int32_t*>(a_val),
      static_cast<const int32_t*>(a_idx), static_cast<const uint8_t*>(a_pres),
      static_cast<const float*>(b_key), static_cast<const int32_t*>(b_val),
      static_cast<const int32_t*>(b_idx), static_cast<const uint8_t*>(b_pres),
      static_cast<int32_t*>(o_key), static_cast<int32_t*>(o_val),
      static_cast<int32_t*>(o_idx), static_cast<uint8_t*>(o_pres), kk, kl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
