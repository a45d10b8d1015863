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
// partial (never 0 + partial). Every add is __fadd_rn (no contraction can
// move a bit; the library builds without --use_fast_math), so NaN payloads,
// -0.0 and +-inf come out as that chain makes them. CUDA's atomics
// (index_add_, scatter_add_) add in no fixed order, so this sum needs its
// own kernel. A float partial cannot be split into sub-chains (that rounds
// differently), so the parallelism float32 allows is fb * g * nb chains.
// int32 adds wrap and are exact in any order; both forms below still add
// int32 in the float order (no chain is split).
//
// Members come as CSR over (block, group): member[ptr[b * g + grp] ..
// ptr[b * g + grp + 1]) are the sids of group grp inside series block b,
// ascending. Sids routed past g (inactive) are simply not listed.
//
// Two forms, one launch each; the wrapper (ring_fold.py blocked_fold_form)
// picks one from the shape, with no flag:
//
// - Per-cell (kPerCell), where g * nb fills the card and the groups are
//   short (g * nb >= 16384 and m <= 1024 g): one thread per (group, cell),
//   cells fastest, so the threads of a warp share a member list (broadcast
//   loads of member[]) and read 32 consecutive cells of one series row
//   (coalesced); each thread walks its group's fb lists in order. The form
//   of the Q2 shapes (g = 9; 4000 series of 4320 cells, or a mesh shard's
//   2048 of 2160): as fast as the staged form on the first, faster on the
//   second (PERF.md).
//
// - Staged (kStaged), for few groups with long lists (PromQL's
//   `max by (dc)` count: g = 33, nb = 8, fb = 8, ~3,900 members a list over
//   1 M series). There the per-cell form has 264 threads on 132 SMs, each
//   walking ~31,000 members with one dependent round trip to memory each:
//   4.69 ms, all latency. The staged form decouples the loads, which are
//   parallel over members, from the adds, which are serial per chain:
//   * a block (256 threads) owns one (series block, group, 256-cell chunk)
//     tile, grid (g * ceil(nb / 256), fb): the fb * g * chunks chains are
//     spread over the card (264 blocks at the PromQL shape);
//   * the tile's list is walked in batches of up to 1024 rows (16 KB of
//     stage a batch, double-buffered; 480 rows of 8 cells): the copy
//     threads load member ids (coalesced, one batch ahead of the copies,
//     in registers), then copy the batch's row segments into
//     shared memory with 4-byte cp.async copies, a warp reading whole row
//     segments (32 bytes at 8 cells: one sector) and storing them down the
//     stage's columns (cell c's rows at c * pitch + r, the pitch 4 banks
//     apart from cell to cell), so a batch's rows are all in flight at
//     once;
//   * one adder thread per cell walks its column in member order while the
//     copies of the next batch fly, 4 rows a 16-byte shared memory load,
//     the next 32 rows' loads issued ahead of the current 32 adds. One
//     barrier a batch. On tiles of up to 32 cells warp 0 only adds and the
//     other 7 warps only fetch and copy, so the chain waits on nothing
//     but its adds and the barrier; wider tiles share the work. The chain
//     is then bound by the card's dependent-add latency, not memory's;
//   * each block stores its partial to scratch (__stcg), fences and adds
//     one arrival to its tile's count; the block that arrives last (the
//     fb-th) left-folds the fb partials from block 0's, writes the output
//     and resets the count to 0 for the next launch on the stream (the
//     arrival pattern of ring_fold_fused.cu; the scratch is the wrapper's
//     per-(device, stream) build.stream_scratch). With fb = 1 a block
//     writes its partial straight to the output.
//
// Bounds on this card (H100 SXM, 3.35 TB/s), the larger of:
// - bytes: every input read once and the output written once: 4 * m * nb
//   member rows, 4 * m member ids, 4 * (fb * g + 1) offsets, 4 * g * nb
//   out. 36.0 MB, 0.0107 ms at the PromQL shape above (m = 1,000,000);
// - the chain: the longest (block, group) list plus fb - 1 fold adds, one
//   dependent add each: 4,096 + 7 adds at the PromQL shape, ~0.0097 ms
//   at the measured ~2.4 ns an add (add_chain below; chip_smoke.py
//   measures it in every run). It is why the padded series of a grid
//   never enter the lists: their group's 48,576 members in one list would
//   make a ~0.12 ms chain (promql/fast._fold_members routes them past the
//   last group).
//
// add_chain is one thread's chain of n dependent adds: the latency the
// chain bound is counted in (a measurement hook, like noop).
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

// ---- K2 -----------------------------------------------------------------

// the forms (ring_fold.py _K2_FORMS)
constexpr int kPerCell = 0;
constexpr int kStaged = 1;

constexpr int kCellThreads = 256;    // per-cell form: threads a block
constexpr int kStagedThreads = 256;  // staged form: threads a block
constexpr int kChunk = 256;          // cells of a tile; ring_fold.py _FUSED_CELLS
constexpr int kBufs = 2;             // stage buffers: 1 batch in flight
constexpr int kStageWords = 4096;    // 16 KB a stage buffer
constexpr int kMaxRows = 1024;       // rows a batch at most (sids staged)
constexpr int kAdderWarp = 32;       // narrow tiles: warp 0 adds, the rest copy
constexpr int kIdsPerThread =
    (kMaxRows + kStagedThreads - kAdderWarp - 1) /
    (kStagedThreads - kAdderWarp);
constexpr int kAddUnroll = 32;       // rows loaded ahead of the adds
static_assert(kAddUnroll % 4 == 0, "the adders load 4 rows at a time");
constexpr int kMaxGridY = 65535;

// the adds of every chain: round to nearest, never contracted; int32
// wraps (unsigned add, no signed overflow)
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

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
      part = add(part, arr[static_cast<long long>(member[k]) * nb + cell]);
    }
    total = b == 0 ? part : add(total, part);
  }
  out[t] = total;
}

// The copy and the waits are ordered against shared memory accesses
// ("memory"); a copy's data is read by other threads only after
// cp.async.wait_group and a barrier.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of every group but the newest kPending landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 4 consecutive rows of one staged column
template <typename T> struct Col4;
template <> struct Col4<float> { using type = float4; };
template <> struct Col4<int32_t> { using type = int4; };

template <typename T>
struct StagedArgs {
  const T* arr;             // (S, nb)
  const int32_t* member;    // CSR members over (block, group)
  const int32_t* ptr;       // (fb * g + 1,)
  T* out;                   // (g, nb)
  T* part;                  // (fb, g, nb) block partials; fb > 1 only
  unsigned int* count;      // (g * chunks,) arrivals; 0 between launches
  int g, fb, nb, chunks;
  long long plane;
};

template <typename T>
__global__ void __launch_bounds__(kStagedThreads)
    fold_staged_kernel(StagedArgs<T> a) {
  using V = typename Col4<T>::type;
  // the stage holds a batch column by column: cell c's rows at
  // c * pitch + r, so an adder reads 4 rows in one 16-byte load
  __shared__ V stage4[kBufs * kStageWords / 4];
  __shared__ __align__(16) int32_t sids[kBufs][kMaxRows];
  __shared__ bool last;
  T* stage = reinterpret_cast<T*>(stage4);

  const int tile = blockIdx.x;          // group * chunks + chunk
  const int b = blockIdx.y;             // series block
  const int nb = a.nb;
  const int grp = tile / a.chunks;
  const int c0 = (tile - grp * a.chunks) * kChunk;
  const int cw = nb - c0 < kChunk ? nb - c0 : kChunk;   // cells of the tile
  // rows a batch: a multiple of 32 where the stage fits one (else of 4),
  // the pitch 4 more (a multiple of 4, and 4 banks apart from cell to
  // cell: the adders' 16-byte loads and the copies' 4-byte stores of a
  // warp meet no bank twice at 8 cells)
  const int fit = kStageWords / cw - 4;
  int batch = fit >= 32 ? fit & ~31 : fit & ~3;
  batch = batch < kMaxRows ? batch : kMaxRows;
  const int pitch = batch + 4;
  const int slot = b * a.g + grp;
  const int k0 = a.ptr[slot];
  const int rows = a.ptr[slot + 1] - k0;
  const int32_t* member = a.member + k0;
  const T* src = a.arr + c0;
  const int tid = threadIdx.x;
  const int batches = (rows + batch - 1) / batch;
  // Tiles of at most 32 cells: warp 0 adds and the other warps fetch ids
  // and copy, so nothing but the adds and one barrier a batch sits on the
  // chain; wider tiles: every thread does both. Copy thread ct takes cell
  // ct % cw of rows ct / cw, + rstep, ...
  const int cbase = cw <= kAdderWarp ? kAdderWarp : 0;
  const int ncopy = kStagedThreads - cbase;
  const int ct = tid - cbase;           // < 0: the adder warp
  const int rstep = ncopy / cw;
  const int cc = ct % cw;
  const int r0 = ct / cw;
  const bool copier = ct >= 0;
  auto rows_of = [&](int q) {
    const int n = rows - q * batch;
    return n < batch ? n : batch;
  };

  // the member ids of batch q, in registers (coalesced loads)
  int ids[kIdsPerThread];
  auto fetch = [&](int q) {
    const int base = q * batch;
    const int n = rows_of(q);
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      const int i = ct + j * ncopy;
      ids[j] = i < n ? __ldg(member + base + i) : 0;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      const int i = ct + j * ncopy;
      if (i < kMaxRows) sids[buf][i] = ids[j];
    }
  };
  // the copies of batch q's cells into stage buffer q % kBufs, one group
  // (empty past the last batch, so that every wait counts the same): a
  // warp reads whole row segments (coalesced) and stores them down the
  // columns
  auto issue = [&](int q) {
    if (q < batches && copier && r0 < rstep) {
      const int n = rows_of(q);
      T* dst = stage + (q % kBufs) * kStageWords + cc * pitch;
      const int32_t* sv = sids[q % kBufs];
      for (int r = r0; r < n; r += rstep) {
        cp_async4(dst + r, src + static_cast<long long>(sv[r]) * nb + cc);
      }
    }
    cp_async_commit();
  };

  // this thread's cell of batch q's rows onto acc, in row order. Full
  // groups of kAddUnroll rows run without predicates in 16-byte loads of
  // 4 rows, the next group's loads issued ahead of the current group's
  // adds; the last rows (fewer than a group) load first, clamped to the
  // column's last row, and add predicated. Every load indexes the shared
  // array itself: a generic pointer into it turned each load into a
  // branch and an address conversion (~60 cycles a row on the card).
  constexpr int kVecs = kAddUnroll / 4;
  T acc = T(0);
  auto add4 = [&](const V& v) {
    acc = add(acc, v.x);
    acc = add(acc, v.y);
    acc = add(acc, v.z);
    acc = add(acc, v.w);
  };
  auto add_batch = [&](int q) {
    const int n = rows_of(q);
    const int col = (q % kBufs) * kStageWords + tid * pitch;   // row r: col + r
    const int full = n - n % kAddUnroll;
    if (full > 0) {
      V cur[kVecs];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) cur[k] = stage4[col / 4 + k];
      for (int r = kAddUnroll; r < full; r += kAddUnroll) {
        V nxt[kVecs];
#pragma unroll
        for (int k = 0; k < kVecs; ++k) nxt[k] = stage4[(col + r) / 4 + k];
#pragma unroll
        for (int k = 0; k < kVecs; ++k) add4(cur[k]);
#pragma unroll
        for (int k = 0; k < kVecs; ++k) cur[k] = nxt[k];
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) add4(cur[k]);
    }
    if (full < n) {
      V rest[kVecs];
      const int lastv = (col + n - 1) / 4;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = (col + full) / 4 + k;
        rest[k] = stage4[v < lastv ? v : lastv];
      }
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int r = full + 4 * k;
        if (r < n) acc = add(acc, rest[k].x);
        if (r + 1 < n) acc = add(acc, rest[k].y);
        if (r + 2 < n) acc = add(acc, rest[k].z);
        if (r + 3 < n) acc = add(acc, rest[k].w);
      }
    }
  };

  // the first kBufs - 1 batches' ids, then their copies, one group each
  for (int q = 0; q < kBufs - 1; ++q) {
    if (q < batches && copier) {
      fetch(q);
      put(q);
    }
  }
  __syncthreads();
  for (int q = 0; q < kBufs - 1; ++q) issue(q);
  if (kBufs - 1 < batches && copier) fetch(kBufs - 1);
  for (int q = 0; q < batches; ++q) {
    const int ahead = q + kBufs - 1;    // the batch this iteration issues
    // sids[ahead % kBufs] was last read by issue(q - 1), kBufs - 1
    // iterations ago
    if (ahead < batches && copier) put(ahead % kBufs);
    cp_async_wait<kBufs - 2>();   // this thread's copies of batch q landed
    __syncthreads();   // batch q staged; batch ahead's ids visible
    // stage buffer ahead % kBufs was last read by the adds of batch
    // q - 1, before this barrier
    issue(ahead);
    if (ahead + 1 < batches && copier) fetch(ahead + 1);
    if (tid < cw) add_batch(q);
  }

  const long long e = static_cast<long long>(grp) * nb + c0 + tid;
  if (a.fb == 1) {
    if (tid < cw) a.out[e] = acc;
    return;
  }
  if (tid < cw) __stcg(a.part + b * a.plane + e, acc);
  // one arrival per (series block, tile); the last one folds them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&a.count[tile], 1u) == static_cast<unsigned>(a.fb - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (tid < cw) {
    // from block 0's partial, never from 0: part[0] + part[1] + ...
    const T* p = a.part + e;
    T total = __ldcg(p);
    for (int q = 1; q < a.fb; ++q) total = add(total, __ldcg(p + q * a.plane));
    a.out[e] = total;
  }
  if (tid == 0) a.count[tile] = 0u;
}

template <typename T>
int launch_fold(const void* arr, const void* member, const void* ptr,
                void* out, void* part, void* count, int g, int fb, int nb,
                int form, void* stream) {
  if (g < 0 || nb < 0 || fb < 1 || fb > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long plane = static_cast<long long>(g) * nb;
  if (plane == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kPerCell) {
    const long long blocks = (plane + kCellThreads - 1) / kCellThreads;
    fold_kernel<T><<<static_cast<unsigned int>(blocks), kCellThreads, 0,
                     st>>>(
        static_cast<const T*>(arr), static_cast<const int32_t*>(member),
        static_cast<const int32_t*>(ptr), static_cast<T*>(out), g, fb, nb);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != kStaged || (fb > 1 && (part == nullptr || count == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = (nb + kChunk - 1) / kChunk;
  const long long tiles = g * chunks;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  StagedArgs<T> a;
  a.arr = static_cast<const T*>(arr);
  a.member = static_cast<const int32_t*>(member);
  a.ptr = static_cast<const int32_t*>(ptr);
  a.out = static_cast<T*>(out);
  a.part = static_cast<T*>(part);
  a.count = static_cast<unsigned int*>(count);
  a.g = g;
  a.fb = fb;
  a.nb = nb;
  a.chunks = static_cast<int>(chunks);
  a.plane = plane;
  dim3 grid(static_cast<unsigned int>(tiles), static_cast<unsigned int>(fb));
  fold_staged_kernel<T><<<grid, kStagedThreads, 0, st>>>(a);
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

__global__ void add_chain_kernel(float* out, float x, int n) {
  float acc = 0.0f;
#pragma unroll 16
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, x);
  *out = acc;
}

}  // namespace

// K2 in the form the wrapper chose; part and count (the stream's
// scratch) only for the staged form with fb > 1
extern "C" int gtt_blocked_fold_sum_f32(const void* arr, const void* member,
                                        const void* ptr, void* out,
                                        void* part, void* count, int g,
                                        int fb, int nb, int form,
                                        void* stream) {
  return launch_fold<float>(arr, member, ptr, out, part, count, g, fb, nb,
                            form, stream);
}

extern "C" int gtt_blocked_fold_sum_i32(const void* arr, const void* member,
                                        const void* ptr, void* out,
                                        void* part, void* count, int g,
                                        int fb, int nb, int form,
                                        void* stream) {
  return launch_fold<int32_t>(arr, member, ptr, out, part, count, g, fb, nb,
                              form, stream);
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

extern "C" int gtt_add_chain(void* out, int n, void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), 1.0f, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
