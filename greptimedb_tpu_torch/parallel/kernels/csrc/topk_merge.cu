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
// ring_topk_merge_kernel is the whole ring topk in one launch, for shards
// whose candidate planes lie on one card. It replaces the chain of
// merge_candidates hops that the JAX package's ring_topk_merge
// (greptimedb_tpu/parallel/kernels/topk_merge.py:103) runs through
// sequential_ring, and computes exactly that chain per row:
//
//   acc = pad(local[0], k); acc = merge(acc, local[s]) for s = 1 .. ns - 1
//
// in shard order, each step the one-hot int32 sums above, with presence
// (sum > 0) between steps. Replaying the chain, not ranking all ns lists
// at once, keeps the result bit-identical to the hop ring on any input
// (unsorted, NaN keys, colliding slots). The seed is padded in the kernel
// when kl < k: slots >= kl take key -inf, value 0.0, index 2^31 - 1 and
// presence false. Design: one block per row with k + kl threads; the
// accumulator's four planes live in shared memory as int32 slots, double
// buffered across steps; each step stages shard s's keys in shared memory,
// counts ranks and places with shared-memory atomics as the hop kernel
// does, and a __syncthreads() separates the steps. Shard pointers travel
// by value (ShardPlanes, up to 8 shards). Bound on this card: bytes,
// 13 * J * (k + (ns - 1) * kl) in and 13 * J * k out, about 52 KB at
// J = 8, k = kl = 100, ns = 4: 16 ns at 3.35 TB/s. So the design aims at
// one launch (and one host call) per ring topk, where the hop ring took
// ns - 1 launches and the seed's padding took eight host-side calls.
//
// The kernels launch on the caller's stream and allocate nothing; the
// wrappers (greptimedb_tpu_torch/parallel/kernels/topk_merge.py) own the
// outputs and check the launch status the C entries return.

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

constexpr int kMaxShards = 8;   // FOLD_BLOCKS: a ring shard holds >= 1 block

struct ShardPlanes {
  const float* key[kMaxShards];      // (J, kl) per shard
  const int32_t* val[kMaxShards];
  const int32_t* idx[kMaxShards];
  const uint8_t* pres[kMaxShards];
};

__global__ void ring_topk_merge_kernel(ShardPlanes in,
                                       int32_t* __restrict__ o_key,
                                       int32_t* __restrict__ o_val,
                                       int32_t* __restrict__ o_idx,
                                       uint8_t* __restrict__ o_pres, int ns,
                                       int k, int kl) {
  extern __shared__ int32_t smem[];
  float* kb = reinterpret_cast<float*>(smem);   // kl keys of shard s
  int32_t* buf = smem + kl;                      // 2 x (4 planes of k slots)
  const long long row = blockIdx.x;
  const long long rl = row * kl;
  const int t = threadIdx.x;
  if (t < k) {   // the seed: shard 0's candidates, padded to k slots
    const bool real = t < kl;
    buf[t] = real ? __float_as_int(in.key[0][rl + t])
                  : static_cast<int32_t>(0xff800000u);   // -inf
    buf[k + t] = real ? in.val[0][rl + t] : 0;           // 0.0
    buf[2 * k + t] = real ? in.idx[0][rl + t] : 0x7fffffff;
    buf[3 * k + t] = real ? in.pres[0][rl + t] : 0;
  }
  for (int s = 1; s < ns; ++s) {
    const int32_t* cur = buf + ((s - 1) & 1) * 4 * k;
    int32_t* nxt = buf + (s & 1) * 4 * k;
    int32_t key = 0, val = 0, idx = 0, pres = 0;
    if (t >= k && t < k + kl) {
      const long long j = rl + (t - k);
      kb[t - k] = in.key[s][j];
      val = in.val[s][j];
      idx = in.idx[s][j];
      pres = in.pres[s][j];
    }
    for (int i = t; i < 4 * k; i += blockDim.x) nxt[i] = 0;
    __syncthreads();   // the accumulator, shard s's keys, zeroed slots
    int pos = k;       // dropped unless a source below sets it
    if (t < k) {
      const float a = __int_as_float(cur[t]);
      pos = t;
      for (int j = 0; j < kl; ++j) pos += kb[j] > a ? 1 : 0;
      key = cur[t];
      val = cur[k + t];
      idx = cur[2 * k + t];
      pres = cur[3 * k + t] > 0 ? 1 : 0;
    } else if (t < k + kl) {
      const float b = kb[t - k];
      pos = t - k;
      for (int i = 0; i < k; ++i) pos += __int_as_float(cur[i]) >= b ? 1 : 0;
      key = __float_as_int(b);
    }
    if (pos < k) {
      atomicAdd(&nxt[pos], key);
      atomicAdd(&nxt[k + pos], val);
      atomicAdd(&nxt[2 * k + pos], idx);
      atomicAdd(&nxt[3 * k + pos], pres);
    }
    __syncthreads();   // the step's slots are complete
  }
  if (t < k) {
    const int32_t* fin = buf + ((ns - 1) & 1) * 4 * k;
    const long long o = row * k + t;
    o_key[o] = fin[t];
    o_val[o] = fin[k + t];
    o_idx[o] = fin[2 * k + t];
    o_pres[o] = fin[3 * k + t] > 0 ? 1 : 0;
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

extern "C" int gtt_ring_topk_merge(const void* const* keys,
                                   const void* const* vals,
                                   const void* const* idxs,
                                   const void* const* pres, void* o_key,
                                   void* o_val, void* o_idx, void* o_pres,
                                   int ns, int rows, int k, int kl,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (ns < 1 || ns > kMaxShards || k < 1 || kl < 0 || kl > k ||
      k + kl > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardPlanes in;
  for (int s = 0; s < kMaxShards; ++s) {
    const bool on = s < ns;
    in.key[s] = on ? static_cast<const float*>(keys[s]) : nullptr;
    in.val[s] = on ? static_cast<const int32_t*>(vals[s]) : nullptr;
    in.idx[s] = on ? static_cast<const int32_t*>(idxs[s]) : nullptr;
    in.pres[s] = on ? static_cast<const uint8_t*>(pres[s]) : nullptr;
  }
  const size_t smem = sizeof(int32_t) * (static_cast<size_t>(kl) +
                                         8 * static_cast<size_t>(k));
  ring_topk_merge_kernel<<<rows, k + kl, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<int32_t*>(o_key), static_cast<int32_t*>(o_val),
      static_cast<int32_t*>(o_idx), static_cast<uint8_t*>(o_pres), ns, k, kl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
