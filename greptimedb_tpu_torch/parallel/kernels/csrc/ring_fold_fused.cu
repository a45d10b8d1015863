// The group fold's whole reduce-then-broadcast ring in one launch, and
// the same pipelined member walk for K2's continuation and partials forms.
//
// Replaces greptimedb_tpu/parallel/kernels/ring_fold.py
// _tpu_ring_fold_call (its pallas_call at :217): the Pallas kernel seeds
// each shard's accumulator with the left fold of its local block partials,
// then runs 2(ns - 1) steps of remote copy into the right neighbour's
// (2, g, nb) double buffer, each followed by a fold turn (step k < ns - 1:
// shard k + 1 adds its partials onto what arrived) or a latch (the total
// passes by and each shard keeps it). Every shard ends with
//
//   out = part[0][0] + ... + part[0][fb-1] + part[1][0] + ... + part[ns-1][fb-1]
//
// added left to right from shard 0's first block partial, where each block
// partial starts at 0 and adds its member rows in ascending sid order —
// the bits of K2's seed followed by fold_cont hop by hop
// (csrc/ring_fold.cu) and of the gather twin (parallel/dist.ShardFoldCtx).
// Adds only: no multiply, so no FMA contraction can move a bit; NaN
// payloads, -0.0 and +-inf pass as the add chain makes them.
//
// Bound on this card: bytes — the member rows read once (4 * m * nb over
// all shards) and ns outputs written (4 * ns * g * nb); 71.1 MB, 0.0212 ms
// at 3.35 TB/s at the mesh Q2 shape (4 shards x 2048 series, nb = 2160,
// g = 9, fb_local = 2).
//
// Design, for one card.
//
// 1. The member walk keeps loads in flight ahead of in-order adds. A block
//    owns one block partial's tile: (shard, series block, group, chunk of
//    kCells = 256 cells), grid (g * ceil(nb / 256), ns * fb_local), so
//    every thread of a block walks the same member list, and a walk is
//    one list of ~114 rows at the mesh Q2 shape (walking a shard's
//    fb_local lists as one stream, 228 rows, was slower on the card). The
//    list's sids are staged in shared memory, kMemberBatch at a time.
//    Each of the 64 threads owns 4 consecutive cells and streams its 16
//    bytes of each member row through a ring of kStages = 32 shared-memory
//    slots with cp.async, in groups of kGroupRows = 8 rows: the copies of
//    the next 3 groups (24 rows) are in flight while the thread adds the
//    current group's rows onto its partial, in member order, with one
//    wait per group (one wait per row was slower on the card). A thread
//    reads back only what it copied itself, so cp.async.wait_group orders
//    it and no barrier sits in the walk. In flight: 648 blocks x 24 KB =
//    15.6 MB at the mesh Q2 shape, above the ~2.3 MB (3.35 TB/s x ~0.7 us)
//    that HBM needs to run at its rate; the parent's one-load-per-thread
//    walk kept ~0.3 MB in flight. cp.async (16-byte copies, commit/wait
//    groups) was kept over TMA bulk copies: a copy is 16 bytes per thread
//    and per row, every row lives at its own sid, and a per-thread ring
//    needs no mbarrier. Where a row or its segment is not 16-byte aligned
//    (nb % 4 != 0, or a shard's rows not 16-byte aligned) the same pipeline
//    copies 4 bytes per cell (kAligned = false). The ragged last chunk of a
//    row (nb % 256 cells) leaves the threads past its end idle.
// 2. The cross-shard combine is one arrival per partial, in place of the
//    parent's 2(ns - 1) flag round trips through L2 per tile. Each block
//    stores its partial (partials, not a per-shard sum: the fold is left
//    to right, so every partial after shard 0's first is added on its own)
//    to a scratch plane with __stcg, fences, and thread 0 adds one to the
//    tile's arrival count. The block that arrives last (the ns * fb_local-th)
//    reads every partial of the tile (__ldcg, through L2), left-folds them
//    in shard and block order from shard 0's first partial, writes the
//    total to all ns outputs and resets the count to 0 for the next launch
//    on the stream. Nothing spins, so the launch is an ordinary one: no
//    cooperative launch, no co-residency check, no double buffers, no
//    epochs.
//
// 3. The walk has three forms (template argument kForm), one kernel:
//    - kRing (row 6): everything above, the walk as a loop.
//    - kCont (fold_cont, replacing the Pallas _fold_cont_kernel:44 of
//      greptimedb_tpu/parallel/kernels/ring_fold.py through _call2:84):
//      out = acc + part[0] + ... + part[fb-1] for one shard. Each block
//      stores its partial to scratch and adds one arrival; the last block
//      of a tile folds left to right starting FROM acc (so an acc of -0.0
//      plus an empty partial comes out +0.0, as in the Pallas kernel),
//      writes out and resets the count to 0. Row 6's fold starts from
//      shard 0's first partial instead; the two loops differ on purpose.
//    - kPartials (block_partials: the per-block segment sum of the JAX
//      package's device_range.py:1509 blocked_sum, which the gather twin
//      concatenates across shards): each block stores its partial
//      straight to out[b]; no scratch, no arrival, no fold.
//    Every form has row 6's 256-cell tiles and 32-slot ring; the
//    single-shard forms take any fb (grid y) and run full groups of 8 rows
//    as straight-line code (kUnroll). At one shard of the mesh
//    Q2 shape the grid is only 81 tiles x fb 2 = 162 blocks of 2 warps,
//    about one block an SM, so no other warp hides the latency of a row's
//    dependent instructions in the loop (the shared memory load of its
//    sid, the address, the copy; the stage load, the adds): that latency,
//    not HBM, set the loop's pace. Unrolled, a group's 8 sids come in two
//    16-byte loads and its 8 copies, then its 8 stage loads, issue back to
//    back; the adds keep row order. Narrower tiles (more blocks) and
//    deeper rings did not pay on the card. Row 6 keeps the loop it was
//    measured with. Bound on this card at the mesh
//    Q2 shape (one shard: 2048 member rows of 2160 cells, g = 9, fb = 2):
//    17.9 MB, 0.00533 ms at 3.35 TB/s, for both forms.
//
// The kernel takes raw per-shard pointers (inputs, members, outputs), so
// the cross-card form can pass peer pointers of other cards and keep the
// scratch and the count in one card's memory, with the fence and the count
// at system scope. The wrappers (greptimedb_tpu_torch/parallel/kernels/
// ring_fold.py ring_fold_fused and fold_cont) keep the scratch and the
// count per device and stream, launch on the caller's stream and check the
// status these launchers return; the kernel allocates nothing.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 8;   // FOLD_BLOCKS: every shard holds >= 1 block
constexpr int kMaxBlocks = 8;   // ring form: fb_local <= FOLD_BLOCKS
constexpr int kCells = 256;     // cells of one tile; ring_fold.py _FUSED_CELLS
constexpr int kVec = 4;         // cells a thread owns: one 16-byte copy
constexpr int kThreads = kCells / kVec;
constexpr int kGroupRows = 8;   // member rows per cp.async group
constexpr int kGroups = 4;      // groups in a thread's ring of slots
constexpr int kStages = kGroupRows * kGroups;   // rows in the ring
constexpr int kMemberBatch = 1024;   // sids staged in shared memory at once
constexpr int kMaxGridY = 65535;

// the walk's forms
constexpr int kRing = 0;       // row 6: every shard's partials, one fold
constexpr int kCont = 1;       // fold_cont: acc + one shard's partials
constexpr int kPartials = 2;   // block_partials: the partials themselves

// a full group of rows as straight-line code: its 8 sids in two 16-byte
// shared memory loads, its 8 copies, then its 8 stage loads ahead of the
// adds (row 6 keeps the loop it was measured with)
template <int kForm>
constexpr bool kUnroll = kForm != kRing;

template <typename T>
struct FoldArgs {
  const T* arr[kMaxShards];           // (s_local, nb) per shard
  const int32_t* member[kMaxShards];  // CSR members over (block, group)
  const int32_t* ptr[kMaxShards];     // (fb * g + 1,)
  T* out[kMaxShards];                 // (g, nb) per shard; partials (fb, g, nb)
  const T* acc;                       // cont: (g, nb)
  T* part;                            // (ns, fb, g, nb) block partials
  unsigned int* count;                // (tiles,) arrivals; 0 between launches
  int ns, g, fb, nb, chunks;
  long long plane;
};

// The copies and the wait are ordered against the thread's own shared
// memory reads ("memory"): a slot is refilled only after the read of the
// row it held, one group of rows later.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of every group but the newest kGroups - 2 landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGroups - 2) : "memory");
}

// a 32-bit word of shared memory as T
template <typename T>
__device__ __forceinline__ T bits(unsigned int u) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(u);
  } else {
    return static_cast<T>(u);
  }
}

template <typename T, bool kAligned, int kForm>
__global__ void __launch_bounds__(kThreads)
    ring_fold_fused_kernel(FoldArgs<T> a) {
  __shared__ __align__(16) T stage[kStages][kCells];
  __shared__ __align__(16) int32_t sids[kMemberBatch];
  __shared__ bool last;

  const int tile = blockIdx.x;
  const int sb = blockIdx.y;            // shard * fb + series block
  const int s = sb / a.fb;
  const int nb = a.nb;
  const long long plane = a.plane;
  const int grp = tile / a.chunks;
  const int c0 = (tile - grp * a.chunks) * kCells;
  const int lane = threadIdx.x;
  const int cell = c0 + lane * kVec;    // this thread's first cell
  int mine = nb - cell;                 // cells of the row this thread owns
  mine = mine < 0 ? 0 : (mine > kVec ? kVec : mine);
  const T* arr = a.arr[s] + cell;
  const int slot = (sb - s * a.fb) * a.g + grp;
  const int32_t* member = a.member[s] + a.ptr[s][slot];
  const int rows = a.ptr[s][slot + 1] - a.ptr[s][slot];

  T acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = T(0);
  // the copy of this thread's cells of row `sid` into ring slot `slot_i`
  auto copy_row = [&](int sid, int slot_i) {
    const T* src = arr + static_cast<long long>(sid) * nb;
    T* dst = &stage[slot_i][lane * kVec];
    if constexpr (kAligned) {
      if (mine == kVec) cp_async16(dst, src);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (v < mine) cp_async4(dst + v, src + v);
      }
    }
  };
  // the copies of batch rows [i0, min(i0 + kGroupRows, n)) (their sids
  // staged in sids[]) into ring slots i % kStages, as one group
  auto issue = [&](int i0, int n) {
    if (kUnroll<kForm> && i0 + kGroupRows <= n) {
      // i0 and kStages are multiples of kGroupRows: 16-byte aligned sids,
      // and the group's slots are consecutive
      const int4 s0 = *reinterpret_cast<const int4*>(&sids[i0]);
      const int4 s1 = *reinterpret_cast<const int4*>(&sids[i0 + 4]);
      const int sv[kGroupRows] = {s0.x, s0.y, s0.z, s0.w,
                                  s1.x, s1.y, s1.z, s1.w};
      const int b0 = i0 % kStages;
#pragma unroll
      for (int j = 0; j < kGroupRows; ++j) copy_row(sv[j], b0 + j);
    } else {
      for (int i = i0; i < i0 + kGroupRows && i < n; ++i) {
        copy_row(sids[i], i % kStages);
      }
    }
    cp_async_commit();
  };
  // row x4 of the stage (the thread's 4 cells) onto acc, in cell order
  auto add_row = [&](uint4 x4) {
    const T x[kVec] = {bits<T>(x4.x), bits<T>(x4.y), bits<T>(x4.z),
                       bits<T>(x4.w)};
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (v < mine) acc[v] = acc[v] + x[v];
    }
  };

  for (int base = 0; base < rows; base += kMemberBatch) {
    const int n = rows - base < kMemberBatch ? rows - base : kMemberBatch;
    __syncthreads();   // every thread is done with the previous batch
    for (int i = lane; i < n; i += kThreads) sids[i] = member[base + i];
    __syncthreads();
    // kGroups - 1 groups of rows in flight; a group refills the slots of
    // the group read in the iteration before
    for (int q = 0; q < kGroups - 1; ++q) issue(q * kGroupRows, n);
    for (int i0 = 0; i0 < n; i0 += kGroupRows) {
      cp_async_wait_oldest();
      const int i1 = i0 + kGroupRows < n ? i0 + kGroupRows : n;
      if (kUnroll<kForm> && i1 - i0 == kGroupRows) {
        // the group's 8 stage loads first, then its adds in row order
        const int b0 = i0 % kStages;
        uint4 x4[kGroupRows];
#pragma unroll
        for (int j = 0; j < kGroupRows; ++j) {
          x4[j] = *reinterpret_cast<const uint4*>(&stage[b0 + j][lane * kVec]);
        }
#pragma unroll
        for (int j = 0; j < kGroupRows; ++j) add_row(x4[j]);
      } else {
        for (int i = i0; i < i1; ++i) {
          // the thread's 4 cells of row i, one 16-byte shared memory load
          add_row(*reinterpret_cast<const uint4*>(
              &stage[i % kStages][lane * kVec]));
        }
      }
      issue(i0 + (kGroups - 1) * kGroupRows, n);
    }
  }
  const long long e = static_cast<long long>(grp) * nb + cell;
  if constexpr (kForm == kPartials) {
    // one shard: sb is the series block, out[0] its (fb, g, nb) partials
    T* out = a.out[0] + sb * plane + e;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (v < mine) out[v] = acc[v];
    }
    return;
  }
  T* part = a.part + sb * plane + e;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    if (v < mine) __stcg(part + v, acc[v]);
  }

  // one arrival per (shard, series block, tile); the last one folds them
  const int parts = a.ns * a.fb;
  __threadfence();
  __syncthreads();
  if (lane == 0) {
    last = atomicAdd(&a.count[tile], 1u) == static_cast<unsigned>(parts - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const T* p0 = a.part + e;
  if constexpr (kForm == kCont) {
    // from acc, never from the first partial: acc + part[0] + ...
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (v < mine) {
        T total = a.acc[e + v];
        for (int q = 0; q < parts; ++q) {
          total = total + __ldcg(p0 + q * plane + v);
        }
        a.out[0][e + v] = total;
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (v < mine) {
        T total = __ldcg(p0 + v);
        for (int q = 1; q < parts; ++q) {
          total = total + __ldcg(p0 + q * plane + v);
        }
        for (int t = 0; t < a.ns; ++t) a.out[t][e + v] = total;
      }
    }
  }
  if (lane == 0) a.count[tile] = 0u;
}

// One launch of form kForm over a.ns * a.fb block partials: the grid is
// (tiles, shards * blocks); `aligned` picks the 16-byte copies.
template <typename T, int kForm>
int launch_walk(FoldArgs<T>& a, bool aligned, void* stream) {
  const long long plane = static_cast<long long>(a.g) * a.nb;
  if (plane == 0) return 0;
  const long long chunks = (a.nb + kCells - 1) / kCells;
  const long long tiles = a.g * chunks;
  if (tiles > 0x7fffffffLL ||
      static_cast<long long>(a.ns) * a.fb > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.chunks = static_cast<int>(chunks);
  a.plane = plane;
  dim3 grid(static_cast<unsigned int>(tiles),
            static_cast<unsigned int>(a.ns * a.fb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    ring_fold_fused_kernel<T, true, kForm><<<grid, kThreads, 0, st>>>(a);
  } else {
    ring_fold_fused_kernel<T, false, kForm><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ring(const void* const* arrs, const void* const* members,
                const void* const* ptrs, void* const* outs, void* part,
                void* count, int ns, int g, int fb, int nb, void* stream) {
  if (ns < 1 || ns > kMaxShards || fb < 1 || fb > kMaxBlocks || g < 0 ||
      nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FoldArgs<T> a;
  bool aligned = nb % kVec == 0;
  for (int s = 0; s < kMaxShards; ++s) {
    const bool on = s < ns;
    a.arr[s] = on ? static_cast<const T*>(arrs[s]) : nullptr;
    a.member[s] = on ? static_cast<const int32_t*>(members[s]) : nullptr;
    a.ptr[s] = on ? static_cast<const int32_t*>(ptrs[s]) : nullptr;
    a.out[s] = on ? static_cast<T*>(outs[s]) : nullptr;
    if (on) aligned = aligned && reinterpret_cast<uintptr_t>(arrs[s]) % 16 == 0;
  }
  a.acc = nullptr;
  a.part = static_cast<T*>(part);
  a.count = static_cast<unsigned int*>(count);
  a.ns = ns;
  a.g = g;
  a.fb = fb;
  a.nb = nb;
  return launch_walk<T, kRing>(a, aligned, stream);
}

// the single-shard forms: acc, part and count only for kCont
template <typename T, int kForm>
int launch_one(const void* arr, const void* member, const void* ptr,
               const void* acc, void* out, void* part, void* count, int g,
               int fb, int nb, void* stream) {
  if (fb < 1 || g < 0 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs<T> a;
  for (int s = 0; s < kMaxShards; ++s) {
    a.arr[s] = s ? nullptr : static_cast<const T*>(arr);
    a.member[s] = s ? nullptr : static_cast<const int32_t*>(member);
    a.ptr[s] = s ? nullptr : static_cast<const int32_t*>(ptr);
    a.out[s] = s ? nullptr : static_cast<T*>(out);
  }
  a.acc = static_cast<const T*>(acc);
  a.part = static_cast<T*>(part);
  a.count = static_cast<unsigned int*>(count);
  a.ns = 1;
  a.g = g;
  a.fb = fb;
  a.nb = nb;
  const bool aligned =
      nb % kVec == 0 && reinterpret_cast<uintptr_t>(arr) % 16 == 0;
  return launch_walk<T, kForm>(a, aligned, stream);
}

}  // namespace

extern "C" int gtt_ring_fold_fused_f32(const void* const* arrs,
                                       const void* const* members,
                                       const void* const* ptrs,
                                       void* const* outs, void* part,
                                       void* count, int ns, int g, int fb,
                                       int nb, void* stream) {
  return launch_ring<float>(arrs, members, ptrs, outs, part, count, ns, g, fb,
                            nb, stream);
}

extern "C" int gtt_ring_fold_fused_i32(const void* const* arrs,
                                       const void* const* members,
                                       const void* const* ptrs,
                                       void* const* outs, void* part,
                                       void* count, int ns, int g, int fb,
                                       int nb, void* stream) {
  return launch_ring<int32_t>(arrs, members, ptrs, outs, part, count, ns, g,
                              fb, nb, stream);
}

extern "C" int gtt_fold_cont_f32(const void* arr, const void* member,
                                 const void* ptr, const void* acc, void* out,
                                 void* part, void* count, int g, int fb,
                                 int nb, void* stream) {
  return launch_one<float, kCont>(arr, member, ptr, acc, out, part, count, g,
                                  fb, nb, stream);
}

extern "C" int gtt_fold_cont_i32(const void* arr, const void* member,
                                 const void* ptr, const void* acc, void* out,
                                 void* part, void* count, int g, int fb,
                                 int nb, void* stream) {
  return launch_one<int32_t, kCont>(arr, member, ptr, acc, out, part, count,
                                    g, fb, nb, stream);
}

extern "C" int gtt_block_partials_f32(const void* arr, const void* member,
                                      const void* ptr, void* out, int g,
                                      int fb, int nb, void* stream) {
  return launch_one<float, kPartials>(arr, member, ptr, nullptr, out, nullptr,
                                      nullptr, g, fb, nb, stream);
}

extern "C" int gtt_block_partials_i32(const void* arr, const void* member,
                                      const void* ptr, void* out, int g,
                                      int fb, int nb, void* stream) {
  return launch_one<int32_t, kPartials>(arr, member, ptr, nullptr, out,
                                        nullptr, nullptr, g, fb, nb, stream);
}

// The constants this library was built with, for a report of the design:
// cells a tile (the wrappers size the arrival counts by it), rows in a
// thread's ring of slots, rows a wait, rows in flight, the bytes of one
// copy on aligned and on misaligned rows, then for each form (kRing, kCont,
// kPartials) 1 where its full groups run unrolled.
extern "C" void gtt_ring_fold_fused_design(int* out) {
  out[0] = kCells;
  out[1] = kStages;
  out[2] = kGroupRows;
  out[3] = (kGroups - 1) * kGroupRows;
  out[4] = kVec * static_cast<int>(sizeof(float));
  out[5] = static_cast<int>(sizeof(float));
  out[6 + kRing] = kUnroll<kRing>;
  out[6 + kCont] = kUnroll<kCont>;
  out[6 + kPartials] = kUnroll<kPartials>;
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
