// The group fold's whole reduce-then-broadcast ring in one launch.
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
// Design. One cooperative launch covers every shard: blockIdx.y is the
// shard, and each block walks tiles of 256 (group, cell) elements of the
// (g, nb) plane, one element a thread (tile-major: each tile runs its own
// ring, with flags per (shard, tile); the chain is elementwise, so order
// and bits are those of the whole-plane ring). Per tile a thread first
// walks its fb_local block partials with K2's member walk and keeps them in
// registers — all shards at once, where the hop ring ran them one launch
// after another. Then the ring: at step k shard s stores its send value
// into slot (k + 1) % 2 of shard (s + 1) % ns's buffer and raises that
// shard's receive flag; it waits on its own receive flag, reads, acks to
// its left neighbour (the slot may be overwritten two steps later, the role
// of the Pallas send semaphore), and takes its fold turn or latch. On one
// card a hop is a global store; the kernel takes raw per-shard pointers,
// so peer pointers of other cards fit the same interface.
//
// Ordering. A flag is raised after a __syncthreads() that covers the
// block's stores, by thread 0 with __threadfence() then an atomic store
// (a release); it is read by thread 0 with volatile loads, then
// __threadfence() and __syncthreads() (an acquire). Buffers move through
// L2 (__stcg/__ldcg), never a stale L1 line. Flags and buffers outlive the
// launch (the wrapper keeps them per device and stream), so every launch
// carries an epoch `base`: it raises flags to base + k + 1 and waits for
// values at least base + 1, while every launch before it left values below
// that (ring_fold.py _FUSED_EPOCH_STRIDE). No memset between launches.
//
// Co-residency. A spin-wait on a block that is not resident would hang the
// card, so the launch is cooperative (cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident) and the launcher checks the
// grid against the occupancy times the SM count first and returns
// cudaErrorCooperativeLaunchTooLarge instead of launching. The SM count,
// the cooperative attribute and the occupancy are queried once per device
// and dtype.
//
// Bound on this card: bytes — the member rows read once (4 * m * nb over
// all shards) and ns outputs written (4 * ns * g * nb). The ring's hops
// (2(ns - 1) stores and loads of the plane) stay in L2 at the range path's
// shapes and are an artifact of the algorithm, not of the function. At
// those shapes the launch is latency-bound: 2(ns - 1) flag round trips
// through L2 per tile.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 8;   // FOLD_BLOCKS: every shard holds >= 1 block
constexpr int kMaxBlocks = 8;   // fb_local <= FOLD_BLOCKS
constexpr int kThreads = 256;   // one tile; ring_fold.py _FUSED_THREADS
constexpr int kMaxDevices = 64; // devices whose launch limits are cached

template <typename T>
struct RingArgs {
  const T* arr[kMaxShards];          // (s_local, nb) per shard
  const int32_t* member[kMaxShards];  // CSR members over (block, group)
  const int32_t* ptr[kMaxShards];     // (fb * g + 1,)
  T* out[kMaxShards];                 // (g, nb) per shard
  T* buf[kMaxShards];                 // (2, g * nb) receive slots per shard
  int* flags[kMaxShards];             // (2, tiles): recv, then ack
  int ns, g, fb, nb, tiles;
  int base;                           // this launch's epoch: flags > base
  long long plane;
};

// release: the block's stores of this step precede the flag
__device__ __forceinline__ void raise_flag(int* flag, int value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(flag, value);
  }
}

// acquire: nothing of the block reads before the flag reached `value`
__device__ __forceinline__ void wait_flag(const int* flag, int value) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<const volatile int*>(flag) < value) {
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_fold_fused_kernel(RingArgs<T> a) {
  const int s = blockIdx.y;
  const int ns = a.ns;
  const int right = (s + 1) % ns;
  const int left = (s + ns - 1) % ns;
  int* my_recv = a.flags[s];
  int* my_ack = a.flags[s] + a.tiles;
  int* right_recv = a.flags[right];
  int* left_ack = a.flags[left] + a.tiles;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long e = static_cast<long long>(tile) * kThreads + threadIdx.x;
    const bool live = e < a.plane;
    T parts[kMaxBlocks];
    T cur = T(0);
    if (live) {
      const int grp = static_cast<int>(e / a.nb);
      const int cell = static_cast<int>(e - static_cast<long long>(grp) * a.nb);
      const T* arr = a.arr[s];
      const int32_t* member = a.member[s];
      const int32_t* ptr = a.ptr[s];
#pragma unroll
      for (int b = 0; b < kMaxBlocks; ++b) {
        if (b < a.fb) {
          const int k0 = ptr[b * a.g + grp];
          const int k1 = ptr[b * a.g + grp + 1];
          T part = T(0);
          for (int k = k0; k < k1; ++k) {
            part = part + arr[static_cast<long long>(member[k]) * a.nb + cell];
          }
          parts[b] = part;
          cur = b == 0 ? part : cur + part;   // the local seed
        }
      }
    }
    T out = cur;   // placeholder: every shard latches below when ns > 1
    for (int k = 0; k < 2 * ns - 2; ++k) {
      const long long slot = (k + 1) & 1;
      // the right neighbour has read what this shard sent at step k - 2
      if (k >= 2) wait_flag(&my_ack[tile], a.base + k - 1);
      if (live) __stcg(a.buf[right] + slot * a.plane + e, cur);
      raise_flag(&right_recv[tile], a.base + k + 1);
      wait_flag(&my_recv[tile], a.base + k + 1);
      T v = live ? __ldcg(a.buf[s] + slot * a.plane + e) : T(0);
      raise_flag(&left_ack[tile], a.base + k + 1);
      if (k < ns - 1) {
        // fold phase: the shard whose turn it is continues the left fold
        if (live && s == k + 1) {
#pragma unroll
          for (int b = 0; b < kMaxBlocks; ++b) {
            if (b < a.fb) v = v + parts[b];
          }
        }
        if (k == ns - 2 && s == ns - 1) out = v;   // the total
      } else if (s == k - (ns - 1)) {
        out = v;   // broadcast phase: latch the total as it passes by
      }
      cur = v;
    }
    if (live) a.out[s][e] = out;
  }
}

// The blocks of ring_fold_fused_kernel<T> resident at once on device
// `dev` (occupancy times SMs; 0 when the device has no cooperative
// launch), queried on the first launch on each device and kept.
template <typename T>
cudaError_t resident_blocks(int dev, long long* resident) {
  static std::atomic<long long> cache[kMaxDevices];   // 0: not queried yet
  if (dev >= 0 && dev < kMaxDevices) {
    const long long known = cache[dev].load(std::memory_order_relaxed);
    if (known != 0) {
      *resident = known - 1;
      return cudaSuccess;
    }
  }
  int sms = 0;
  int coop = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_fold_fused_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *resident = coop ? static_cast<long long>(per_sm) * sms : 0;
  if (dev >= 0 && dev < kMaxDevices) {
    cache[dev].store(*resident + 1, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <typename T>
int launch_ring(const void* const* arrs, const void* const* members,
                const void* const* ptrs, void* const* outs,
                void* const* bufs, void* const* flags, int ns, int g,
                int fb, int nb, int base, int grid_x, void* stream) {
  if (ns < 1 || ns > kMaxShards || fb < 1 || fb > kMaxBlocks || g < 0 ||
      nb < 0 || base < 0 || base > 0x7fffffff - 2 * kMaxShards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long plane = static_cast<long long>(g) * nb;
  if (plane == 0) return 0;
  RingArgs<T> a;
  for (int s = 0; s < kMaxShards; ++s) {
    const bool on = s < ns;
    a.arr[s] = on ? static_cast<const T*>(arrs[s]) : nullptr;
    a.member[s] = on ? static_cast<const int32_t*>(members[s]) : nullptr;
    a.ptr[s] = on ? static_cast<const int32_t*>(ptrs[s]) : nullptr;
    a.out[s] = on ? static_cast<T*>(outs[s]) : nullptr;
    a.buf[s] = on ? static_cast<T*>(bufs[s]) : nullptr;
    a.flags[s] = on ? static_cast<int*>(flags[s]) : nullptr;
  }
  const long long tiles = (plane + kThreads - 1) / kThreads;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.ns = ns;
  a.g = g;
  a.fb = fb;
  a.nb = nb;
  a.tiles = static_cast<int>(tiles);
  a.base = base;
  a.plane = plane;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long resident = 0;
  err = resident_blocks<T>(dev, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long gx = grid_x > 0 ? grid_x : resident / ns;
  if (grid_x <= 0 && gx > tiles) gx = tiles;
  // every block spins on its neighbours: never launch a grid that cannot
  // be co-resident
  if (gx < 1 || gx * ns > resident || gx > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(ns));
  dim3 block(kThreads);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_fold_fused_kernel<T>), grid, block, args,
      0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtt_ring_fold_fused_f32(const void* const* arrs,
                                       const void* const* members,
                                       const void* const* ptrs,
                                       void* const* outs, void* const* bufs,
                                       void* const* flags, int ns, int g,
                                       int fb, int nb, int base,
                                       int grid_x, void* stream) {
  return launch_ring<float>(arrs, members, ptrs, outs, bufs, flags, ns, g, fb,
                            nb, base, grid_x, stream);
}

extern "C" int gtt_ring_fold_fused_i32(const void* const* arrs,
                                       const void* const* members,
                                       const void* const* ptrs,
                                       void* const* outs, void* const* bufs,
                                       void* const* flags, int ns, int g,
                                       int fb, int nb, int base,
                                       int grid_x, void* stream) {
  return launch_ring<int32_t>(arrs, members, ptrs, outs, bufs, flags, ns, g,
                              fb, nb, base, grid_x, stream);
}

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
