// S: the segmented scans of SQL window running frames, in JAX's tree.
//
// Replaces the jax.lax.associative_scan calls of the JAX package's
// greptimedb_tpu/ops/segment.py:211-292, which XLA computes outside any
// Pallas kernel (query/window_fns.py _running_scans:424 runs them from
// 262,144 rows). Every form scans (value..., flag) cells, where the flag
// marks the first row of a partition, with one combine comb(a, b) of the
// cell on the left and the cell on the right:
//
//   add      (segmented_cumsum:212, int32 / int64 / float64)
//     v = b.f ? b.v : a.v + b.v
//   max, min (segmented_cumextreme:227, float64)
//     v = b.f ? b.v : maximum(a.v, b.v)        (minimum for min)
//   comp     (segmented_cumsum_compensated:250, float32 (s, c))
//     t = a.s + b.s
//     e = |a.s| >= |b.s| ? (a.s - t) + b.s : (b.s - t) + a.s
//     s = b.f ? b.s : t;   c = b.f ? b.c : (a.c + b.c) + e
//   max2, min2 (segmented_cumextreme2:274, float32 (hi, lo))
//     pick_a = a.h > b.h || (a.h == b.h && a.l >= b.l)   (min: <, <=)
//     (h, l) = b.f ? (b.h, b.l) : pick_a ? (a.h, a.l) : (b.h, b.l)
//   and in every form  f = a.f | b.f.
//
// The bit contract is the combine tree. associative_scan's odd/even
// recursion is Brent and Kung's in-place scan: an up-sweep, for levels
// L = 1, 2, ... while 2^L <= n, of a[i] = comb(a[i - 2^(L-1)], a[i]) at
// i = m 2^L - 1 (m >= 1), then a down-sweep, for L from the top level down
// to 1, of the same combine at i = m 2^L + 2^(L-1) - 1 (m >= 1). A float
// add in any other order (a sequential cumsum, a warp-shuffle scan of
// another shape, decoupled look-back, CUB's scan) gives other bits, so
// every form, integer and extreme ones too, runs this one tree. Within a
// level the combines are independent and across levels only the cells
// they read order them, so any thread, shuffle or phase may apply a
// combine as long as its pair of cells and its level stay the same.
//
// Design: one cooperative launch a scan (segscan_kernel), a persistent
// grid of at most as many blocks as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once a form and
// card). A tile is kTile = 2^12 cells, aligned to kTile; a block of 256
// threads scans it, each thread owning kCells = 16 contiguous cells:
//  - levels 1..4 combine a thread's own cells in registers;
//  - levels 5..9 touch only the threads' last cells, which a warp carries
//    with __shfl_up_sync, one shuffle a field of the cell;
//  - levels 10..12 touch only the 8 warps' last cells: warp 0 runs them
//    with shuffles again, after one barrier.
// The down-sweep mirrors it (warp 0, then the shuffles, then the
// registers). Each level's first target whose left cell lies before its
// thread, warp or tile takes that cell's final value: the previous
// thread's last cell by a shuffle, the previous warp's from shared
// memory, the previous tile's scanned total for thread 0. Tile 0 starts at
// m = 1.
// The levels above 12 touch only the tiles' last cells, and are exactly
// the levels of the same tree over the full tiles' totals (a partial last
// tile has no total: no higher level reaches it). So the launch runs:
//  A. every block up-sweeps its tiles and writes each full tile's total;
//  a grid sync (cooperative_groups);
//  the same scan over the totals: one block when they fit in one tile
//  (up to 4096 totals, 16.8 M rows), else the same tiled scheme again
//  inside the launch, behind two more grid syncs (the wrapper takes
//  n < 2^31, so two levels of totals always suffice);
//  a grid sync;
//  B. every block reads its tiles again, redoes their up-sweep (the same
//  bits) and down-sweeps them from the scanned totals.
// When every tile is some block's only tile (the resident form,
// segscan_kernel<F, true>), a block keeps its up-swept tile in registers
// across the syncs and phase B reads nothing again. Values go through a
// per-warp stage in shared memory so that the warp's loads and stores are
// 16-byte and coalesced (rows padded by 16 bytes: no bank conflict on the
// thread-contiguous side), flags load as 16 packed bytes a thread; a
// partial tile, or an array whose base is not 16-byte aligned, loads and
// stores cell by cell.
//
// Outputs: associative_scan interleaves each level's halves by adding two
// zero-padded arrays, so every output of a scan of two or more cells
// passed through x + 0.0, which turns -0.0 into +0.0. Inside the tree this
// changes nothing but zero signs (each combine gives the same value on
// -0.0 and +0.0 up to the sign of a zero result), so the rows are written
// with -0.0 as +0.0 once, at the end (pos_zero; NaN payloads pass).
//
// Arithmetic: float adds are __fadd_rn / __dadd_rn and the build passes
// -fmad=false, so nothing is contracted (the combines hold no product, but
// the contract is the IEEE operations one by one). XLA's maximum/minimum
// propagate NaN and order -0.0 below +0.0; CUDA's fmax/fmin return the
// non-NaN operand, so the extremes select by bits (ext64, as in
// grouped_reduce.cu). Shuffles move bits, so the selections survive them.
// Integer adds wrap, as XLA's do.
//
// Bound on this card: bytes. A form reads each input once and writes each
// output once: (value bytes + 1 flag byte) a row in, value bytes a row
// out; at 17.28 M float64 rows, 9 bytes in and 8 out a row, 294 MB, about
// 0.088 ms at 3.35 TB/s. Past the resident form the design reads the
// input twice (26 bytes a float64 row against the bound's 17); storing
// the up-swept tile instead would cost more (34 bytes: phase B needs the
// flags' ORs too). So at the full table it can reach about 65 % of the
// bytes bound at best; in the resident form, all of it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCellsLog = 4;
constexpr int kCells = 1 << kCellsLog;    // contiguous cells a thread
constexpr int kLaneLog = 5;
constexpr int kLanes = 1 << kLaneLog;
constexpr int kWarpLog = 3;
constexpr int kWarps = 1 << kWarpLog;     // warps a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kTileLog = kCellsLog + kLaneLog + kWarpLog;
constexpr int kTile = 1 << kTileLog;      // cells a block scans at once
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Ports.vec: which arrays are 16-byte aligned (vector loads and stores)
constexpr int kVecX0 = 1, kVecX1 = 2, kVecReset = 4, kVecY0 = 8,
              kVecY1 = 16;

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int64_t add_wrap(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ double add_wrap(double a, double b) {
  return __dadd_rn(a, b);
}

// jnp.maximum(a, x) / jnp.minimum(a, x) as XLA:CPU computes them: order
// the pair by the sign bit of a, compare, and let a NaN first operand win
// (ring_fold.cu ext_f32 says why). Every step is a selection, so NaN
// payloads pass through.
template <bool kMax>
__device__ __forceinline__ double ext64(double a, double x) {
  const long long ab = __double_as_longlong(a);
  const long long xb = __double_as_longlong(x);
  const bool neg = ab < 0;
  long long pb, qb;
  if (kMax) {
    pb = neg ? ab : xb;
    qb = neg ? xb : ab;
  } else {
    pb = neg ? xb : ab;
    qb = neg ? ab : xb;
  }
  const double p = __longlong_as_double(pb);
  const double q = __longlong_as_double(qb);
  const bool take_p = kMax ? (p > q) : (p < q);
  return __longlong_as_double((isnan(p) || take_p) ? pb : qb);
}

__device__ __forceinline__ double pos_zero(double v) {
  return v == 0.0 ? 0.0 : v;
}
__device__ __forceinline__ float pos_zero(float v) {
  return v == 0.0f ? 0.0f : v;
}
template <typename T>
__device__ __forceinline__ T pos_zero(T v) {
  return v;
}

// lane - d's value (a lane below d gets its own); bits move unchanged
template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  return __shfl_up_sync(kAll, v, d);
}
__device__ __forceinline__ uint8_t shfl_up(uint8_t v, int d) {
  return static_cast<uint8_t>(
      __shfl_up_sync(kAll, static_cast<int>(v), d));
}

// ---------------------------------------------------------------------
// forms: a cell's value, how a row of the inputs becomes one, how one
// becomes a row of the outputs, its shuffle and the combine. Every form's
// cell is (value, flag) with f = a.f | b.f; a form combines the values,
// given the right cell's flag.
// ---------------------------------------------------------------------

struct Ports {
  const void* x0;
  const void* x1;
  const uint8_t* reset;
  void* y0;
  void* y1;
  int canon;   // write -0.0 as +0.0 (a scan of two or more rows)
  int vec;     // kVec* bits
};

template <typename T>
struct AddForm {
  using V = T;
  static constexpr bool kTwo = false;
  struct Val {
    T v;
  };
  __device__ static Val make(T a, T) { return {a}; }
  __device__ static T out0(const Val& c) { return c.v; }
  __device__ static T out1(const Val& c) { return c.v; }
  __device__ static Val shfl(const Val& c, int d) { return {shfl_up(c.v, d)}; }
  __device__ static Val comb(const Val& a, const Val& b, bool bf) {
    return {bf ? b.v : add_wrap(a.v, b.v)};
  }
};

template <bool kMax>
struct ExtForm {
  using V = double;
  static constexpr bool kTwo = false;
  struct Val {
    double v;
  };
  __device__ static Val make(double a, double) { return {a}; }
  __device__ static double out0(const Val& c) { return c.v; }
  __device__ static double out1(const Val& c) { return c.v; }
  __device__ static Val shfl(const Val& c, int d) { return {shfl_up(c.v, d)}; }
  __device__ static Val comb(const Val& a, const Val& b, bool bf) {
    return {bf ? b.v : ext64<kMax>(a.v, b.v)};
  }
};

struct CompForm {
  using V = float;
  static constexpr bool kTwo = true;
  struct Val {
    float s;
    float c;
  };
  __device__ static Val make(float a, float b) { return {a, b}; }
  __device__ static float out0(const Val& c) { return c.s; }
  __device__ static float out1(const Val& c) { return c.c; }
  __device__ static Val shfl(const Val& c, int d) {
    return {shfl_up(c.s, d), shfl_up(c.c, d)};
  }
  __device__ static Val comb(const Val& a, const Val& b, bool bf) {
    const float t = __fadd_rn(a.s, b.s);
    const float e = fabsf(a.s) >= fabsf(b.s)
                        ? __fadd_rn(__fsub_rn(a.s, t), b.s)
                        : __fadd_rn(__fsub_rn(b.s, t), a.s);
    return {bf ? b.s : t, bf ? b.c : __fadd_rn(__fadd_rn(a.c, b.c), e)};
  }
};

template <bool kMax>
struct Ext2Form {
  using V = float;
  static constexpr bool kTwo = true;
  struct Val {
    float h;
    float l;
  };
  __device__ static Val make(float a, float b) { return {a, b}; }
  __device__ static float out0(const Val& c) { return c.h; }
  __device__ static float out1(const Val& c) { return c.l; }
  __device__ static Val shfl(const Val& c, int d) {
    return {shfl_up(c.h, d), shfl_up(c.l, d)};
  }
  __device__ static Val comb(const Val& a, const Val& b, bool bf) {
    const bool pick_a = kMax ? (a.h > b.h) || (a.h == b.h && a.l >= b.l)
                             : (a.h < b.h) || (a.h == b.h && a.l <= b.l);
    const bool take_a = !bf && pick_a;
    return {take_a ? a.h : b.h, take_a ? a.l : b.l};
  }
};

// a whole cell: in shared and device memory, and the one-cell operands
// (a warp's, the tile's and the previous tile's last cells)
template <class F>
struct Cell {
  typename F::Val v;
  uint8_t f;
};

template <class F>
__device__ __forceinline__ Cell<F> comb(const Cell<F>& a, const Cell<F>& b) {
  return {F::comb(a.v, b.v, b.f), static_cast<uint8_t>(a.f | b.f)};
}

template <class F>
__device__ __forceinline__ Cell<F> shfl(const Cell<F>& c, int d) {
  return {F::shfl(c.v, d), shfl_up(c.f, d)};
}

// ---------------------------------------------------------------------
// moving a tile: thread t holds cells t kCells .. t kCells + kCells - 1,
// their values in v[] and their flags as the bits of one word
// ---------------------------------------------------------------------

// bytes of one thread's row of V values in a warp's stage (padded by 16)
template <typename V>
__host__ __device__ constexpr int stage_row() {
  return kCells * static_cast<int>(sizeof(V)) + 16;
}

// The thread's kCells values of src from the tile at base (len cells).
// A full, aligned tile goes through the warp's stage: the warp reads its
// span in 16-byte words, lane after lane, then each thread reads its row.
template <typename V>
__device__ __forceinline__ void load_vals(const V* src, long long base,
                                          int len, bool vec,
                                          V (&v)[kCells],
                                          unsigned char* stage) {
  constexpr int kPer = 16 / sizeof(V);            // values a word
  constexpr int kWords = kCells / kPer;           // words a thread
  constexpr int kRow = stage_row<V>();
  const int lane = threadIdx.x & (kLanes - 1);
  const int first = threadIdx.x * kCells;
  if (vec && len == kTile) {
    const uint4* g = reinterpret_cast<const uint4*>(
        src + base + (threadIdx.x & ~(kLanes - 1)) * kCells);
    uint4 r[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) r[q] = g[q * kLanes + lane];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int k = q * kLanes + lane;   // the word's place in the span
      *reinterpret_cast<uint4*>(stage + (k / kWords) * kRow +
                                (k % kWords) * 16) = r[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      union {
        uint4 u;
        V e[kPer];
      } x;
      x.u = *reinterpret_cast<const uint4*>(stage + lane * kRow + q * 16);
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[q * kPer + e] = x.e[e];
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      v[q] = first + q < len ? src[base + first + q] : V(0);
  }
}

template <typename V>
__device__ __forceinline__ void store_vals(V* dst, long long base, int len,
                                           bool vec, const V (&v)[kCells],
                                           unsigned char* stage) {
  constexpr int kPer = 16 / sizeof(V);
  constexpr int kWords = kCells / kPer;
  constexpr int kRow = stage_row<V>();
  const int lane = threadIdx.x & (kLanes - 1);
  const int first = threadIdx.x * kCells;
  if (vec && len == kTile) {
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      union {
        uint4 u;
        V e[kPer];
      } x;
#pragma unroll
      for (int e = 0; e < kPer; ++e) x.e[e] = v[q * kPer + e];
      *reinterpret_cast<uint4*>(stage + lane * kRow + q * 16) = x.u;
    }
    __syncwarp();
    uint4* g = reinterpret_cast<uint4*>(
        dst + base + (threadIdx.x & ~(kLanes - 1)) * kCells);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const int k = q * kLanes + lane;
      g[k] = *reinterpret_cast<const uint4*>(stage + (k / kWords) * kRow +
                                             (k % kWords) * 16);
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      if (first + q < len) dst[base + first + q] = v[q];
  }
}

// the thread's flags as bits (cells past len: set); 16 packed bytes a
// word (cell by cell in a copy built with fewer than 16 cells a thread)
__device__ __forceinline__ unsigned load_flags(const uint8_t* src,
                                               long long base, int len,
                                               bool vec) {
  const int first = threadIdx.x * kCells;
  unsigned f = 0;
  if (kCells % 16 == 0 && vec && len == kTile) {
#pragma unroll
    for (int q = 0; q < kCells / 16; ++q) {
      union {
        uint4 u;
        uint8_t e[16];
      } x;
      x.u = *reinterpret_cast<const uint4*>(src + base + first + q * 16);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        f |= static_cast<unsigned>(x.e[e] != 0) << (q * 16 + e);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      f |= static_cast<unsigned>(first + q >= len || src[base + first + q])
           << q;
  }
  return f;
}

// the caller's rows (the scan's level 0)
template <class F>
struct RowIO {
  using Val = typename F::Val;
  using V = typename F::V;
  Ports p;
  unsigned char* stage;   // this warp's
  __device__ void load(long long base, int len, Val (&c)[kCells],
                       unsigned& f) const {
    V a[kCells], b[kCells];
    load_vals(static_cast<const V*>(p.x0), base, len, p.vec & kVecX0, a,
              stage);
    if constexpr (F::kTwo)
      load_vals(static_cast<const V*>(p.x1), base, len, p.vec & kVecX1, b,
                stage);
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      c[q] = F::make(a[q], F::kTwo ? b[q] : a[q]);
    f = load_flags(p.reset, base, len, p.vec & kVecReset);
  }
  __device__ void store(long long base, int len,
                        const Val (&c)[kCells]) const {
    V a[kCells];
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      a[q] = p.canon ? pos_zero(F::out0(c[q])) : F::out0(c[q]);
    store_vals(static_cast<V*>(p.y0), base, len, p.vec & kVecY0, a, stage);
    if constexpr (F::kTwo) {
#pragma unroll
      for (int q = 0; q < kCells; ++q)
        a[q] = p.canon ? pos_zero(F::out1(c[q])) : F::out1(c[q]);
      store_vals(static_cast<V*>(p.y1), base, len, p.vec & kVecY1, a,
                 stage);
    }
  }
};

// the tiles' totals (the levels above one tile), scanned in place; a
// stored cell keeps its up-swept flag: no combine reads the flag of a
// final cell (only the right cell's flag picks a value)
template <class F>
struct CellIO {
  using Val = typename F::Val;
  Cell<F>* cells;
  __device__ void load(long long base, int len, Val (&c)[kCells],
                       unsigned& f) const {
    const int first = threadIdx.x * kCells;
    f = 0;
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const Cell<F> x = first + q < len ? cells[base + first + q] : Cell<F>{};
      c[q] = x.v;
      f |= static_cast<unsigned>(x.f) << q;
    }
  }
  __device__ void store(long long base, int len,
                        const Val (&c)[kCells]) const {
    const int first = threadIdx.x * kCells;
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      if (first + q < len) cells[base + first + q].v = c[q];
  }
};

// ---------------------------------------------------------------------
// one tile of the tree
// ---------------------------------------------------------------------

template <class F>
struct Tile {
  using Val = typename F::Val;
  using C = Cell<F>;
  Val v[kCells];   // the thread's cells' values
  unsigned f;      // and flags, cell q at bit q
  C w;             // warp 0, lane < kWarps: that warp's last cell

  __device__ C cell(int q) const {
    return {v[q], static_cast<uint8_t>((f >> q) & 1u)};
  }
  __device__ void set(int q, const C& c) {
    v[q] = c.v;
    f = (f & ~(1u << q)) | (static_cast<unsigned>(c.f) << q);
  }
  // cell i = comb(cell left, cell i), within the thread
  __device__ void comb_at(int i, int left) {
    v[i] = F::comb(v[left], v[i], (f >> i) & 1u);
    f |= ((f >> left) & 1u) << i;
  }

  // levels 1 .. kTileLog. Cells past a partial tile's end take part: a
  // cell's value never depends on a cell after it, so they change nothing
  // before the end.
  __device__ void up(C* wsh) {
    const int lane = threadIdx.x & (kLanes - 1);
#pragma unroll
    for (int lev = 1; lev <= kCellsLog; ++lev) {
#pragma unroll
      for (int i = (1 << lev) - 1; i < kCells; i += 1 << lev)
        comb_at(i, i - (1 << (lev - 1)));
    }
    C last = cell(kCells - 1);
#pragma unroll
    for (int l = 1; l <= kLaneLog; ++l) {
      const C left = shfl(last, 1 << (l - 1));
      if (((lane + 1) & ((1 << l) - 1)) == 0) last = comb(left, last);
    }
    set(kCells - 1, last);
    if (lane == kLanes - 1) wsh[threadIdx.x >> kLaneLog] = last;
    __syncthreads();
    if (threadIdx.x < kLanes) {
      w = wsh[lane < kWarps ? lane : kWarps - 1];
#pragma unroll
      for (int l = 1; l <= kWarpLog; ++l) {
        const C left = shfl(w, 1 << (l - 1));
        if (lane < kWarps && ((lane + 1) & ((1 << l) - 1)) == 0)
          w = comb(left, w);
      }
    }
    __syncthreads();
  }

  // levels kTileLog .. 1. first: the array's tile 0 (m starts at 1);
  // top: the final value of the tile's last cell, when a level above the
  // tile set it; prev: the final value of the cell before the tile.
  __device__ void down(C* wsh, bool first, bool have_top, const C& top,
                       const C& prev) {
    const int lane = threadIdx.x & (kLanes - 1);
    const int warp = threadIdx.x >> kLaneLog;
    if (warp == 0) {
      if (have_top && lane == kWarps - 1) w = top;
#pragma unroll
      for (int l = kWarpLog; l >= 1; --l) {
        const int d = 1 << (l - 1);
        C left = shfl(w, d);
        if (lane < d) left = prev;
        if (lane < kWarps && ((lane + 1) & (2 * d - 1)) == d &&
            !(first && lane + 1 == d))
          w = comb(left, w);
      }
      if (lane < kWarps) wsh[lane] = w;
    }
    __syncthreads();
    const C wprev = warp > 0 ? wsh[warp - 1] : prev;
    C last = lane == kLanes - 1 ? wsh[warp] : cell(kCells - 1);
    const bool first_warp = first && warp == 0;
#pragma unroll
    for (int l = kLaneLog; l >= 1; --l) {
      const int d = 1 << (l - 1);
      C left = shfl(last, d);
      if (lane < d) left = wprev;
      if (((lane + 1) & (2 * d - 1)) == d && !(first_warp && lane + 1 == d))
        last = comb(left, last);
    }
    set(kCells - 1, last);
    C tprev = shfl(last, 1);
    if (lane == 0) tprev = wprev;
    const bool first_thread = first && threadIdx.x == 0;
#pragma unroll
    for (int lev = kCellsLog; lev >= 1; --lev) {
      const int s = 1 << lev, h = s >> 1;
      if (!first_thread) set(h - 1, comb(tprev, cell(h - 1)));
#pragma unroll
      for (int i = s + h - 1; i < kCells; i += s) comb_at(i, i - h);
    }
    __syncthreads();
  }

  template <class IO>
  __device__ void load_up(const IO& io, long long tile, long long n,
                          C* wsh) {
    const long long base = tile * kTile;
    io.load(base, static_cast<int>(n - base < kTile ? n - base : kTile), v,
            f);
    up(wsh);
  }

  // down-sweep tile `tile` of n cells and store it; `above` holds the
  // scanned totals of the full tiles (nullptr: the array is one tile)
  template <class IO>
  __device__ void down_store(const IO& io, long long tile, long long n,
                             const C* above, C* wsh) {
    const long long base = tile * kTile;
    const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
    const bool have_top = above != nullptr && len == kTile;
    C top{}, prev{};
    if (have_top) top = above[tile];
    if (above != nullptr && tile > 0) prev = above[tile - 1];
    down(wsh, tile == 0, have_top, top, prev);
    io.store(base, len, v);
  }
};

// The same tree over m > 1 full-tile totals in place (the levels above
// the tiles). One block when they fit in a tile; else their own tiles,
// totals of totals (at most kTile of them) and the same again, behind
// grid syncs. Ends with a grid sync.
template <class F>
__device__ void scan_totals(cg::grid_group& grid, Cell<F>* aux, long long m,
                            Cell<F>* wsh) {
  const CellIO<F> io{aux};
  Tile<F> t;
  if (m <= kTile) {
    if (blockIdx.x == 0) {
      t.load_up(io, 0, m, wsh);
      t.down_store(io, 0, m, nullptr, wsh);
    }
  } else {
    Cell<F>* aux2 = aux + m;
    const long long tiles = (m + kTile - 1) / kTile;
    const long long full = m / kTile;
    for (long long i = blockIdx.x; i < full; i += gridDim.x) {
      t.load_up(io, i, m, wsh);
      if (threadIdx.x == kWarps - 1) aux2[i] = t.w;
    }
    grid.sync();
    if (blockIdx.x == 0 && full > 1) {
      const CellIO<F> io2{aux2};
      t.load_up(io2, 0, full, wsh);
      t.down_store(io2, 0, full, nullptr, wsh);
    }
    grid.sync();
    for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
      t.load_up(io, i, m, wsh);
      t.down_store(io, i, m, aux2, wsh);
    }
  }
  grid.sync();
}

// The whole scan of n rows, in one cooperative launch. kKeep: every block
// has at most one tile and keeps it in registers from phase A to B (one
// block an SM: the registers are its own); else three blocks an SM share
// them (at most 85 registers a thread), so that one block's loads overlap
// the others' combines (the fastest of 1, 2 and 3 blocks on the card).
template <class F, bool kKeep>
__global__ void __launch_bounds__(kThreads, kKeep ? 1 : 3)
    segscan_kernel(Ports p, long long n, Cell<F>* aux) {
  constexpr int kRow = stage_row<typename F::V>();
  __shared__ __align__(16) unsigned char stage[kThreads * kRow];
  __shared__ Cell<F> wsh[kWarps];
  const RowIO<F> rows{p, stage + (threadIdx.x >> kLaneLog) * kLanes * kRow};
  const long long tiles = (n + kTile - 1) / kTile;
  const long long full = n / kTile;
  Tile<F> t;
  if (tiles > 1) {
    cg::grid_group grid = cg::this_grid();
    for (long long i = blockIdx.x; i < (kKeep ? tiles : full);
         i += gridDim.x) {
      t.load_up(rows, i, n, wsh);
      if (i < full && threadIdx.x == kWarps - 1) aux[i] = t.w;
    }
    grid.sync();
    if (full > 1) scan_totals<F>(grid, aux, full, wsh);
  }
  for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
    if (!kKeep || tiles == 1) t.load_up(rows, i, n, wsh);
    t.down_store(rows, i, n, tiles > 1 ? aux : nullptr, wsh);
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

// blocks of segscan_kernel<F, kKeep> that card `dev` holds at once
template <class F, bool kKeep>
cudaError_t co_resident(int dev, long long* out) {
  static std::atomic<int> cache[kMaxDevices];   // 0: not asked yet
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segscan_kernel<F, kKeep>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    v = per_sm * sms;
    if (v <= 0) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev].store(v, std::memory_order_relaxed);
  }
  *out = v;
  return cudaSuccess;
}

template <class F>
long long scratch_bytes(long long n) {
  const long long m = n > kTile ? n / kTile : 0;   // full-tile totals
  return (m + m / kTile) * static_cast<long long>(sizeof(Cell<F>));
}

// the most tiles the resident form takes on the current card (-1 when
// the card cannot be asked)
template <class F>
long long resident_tiles() {
  int dev = 0;
  long long blocks = -1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      co_resident<F, true>(dev, &blocks) != cudaSuccess)
    return -1;
  return blocks;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// grid: blocks to launch, 0 for the most the card holds at once (a
// larger grid is refused, as the card cannot hold it)
template <class F>
int run(const void* x0, const void* x1, const void* reset, void* y0,
        void* y1, void* scratch, long long scratch_size, long long n,
        int grid, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || scratch_size < scratch_bytes<F>(n) || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Ports p{x0, x1, static_cast<const uint8_t*>(reset), y0, y1, n > 1, 0};
  p.vec = (aligned(x0) ? kVecX0 : 0) | (aligned(x1) ? kVecX1 : 0) |
          (aligned(reset) ? kVecReset : 0) | (aligned(y0) ? kVecY0 : 0) |
          (aligned(y1) ? kVecY1 : 0);
  Cell<F>* aux = static_cast<Cell<F>*>(scratch);
  void* args[] = {&p, &n, &aux};
  const long long tiles = (n + kTile - 1) / kTile;
  const auto s = static_cast<cudaStream_t>(stream);
  long long blocks = grid;
  if (grid == 0) {
    err = co_resident<F, true>(dev, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tiles <= blocks) {
      err = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(segscan_kernel<F, true>),
          dim3(static_cast<unsigned int>(tiles)), dim3(kThreads), args, 0, s);
      if (err != cudaSuccess) cudaGetLastError();
      return static_cast<int>(err);
    }
    err = co_resident<F, false>(dev, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > tiles) blocks = tiles;
  }
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segscan_kernel<F, false>),
      dim3(static_cast<unsigned int>(blocks)), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

#define SEGSCAN_ENTRY(name, F)                                               \
  extern "C" int gtt_segscan_##name(const void* x0, const void* x1,          \
                                    const void* reset, void* y0, void* y1,   \
                                    void* scratch, long long scratch_size,   \
                                    long long n, int grid, void* stream) {   \
    return run<F>(x0, x1, reset, y0, y1, scratch, scratch_size, n, grid,     \
                  stream);                                                   \
  }                                                                          \
  extern "C" long long gtt_segscan_##name##_scratch_bytes(long long n) {     \
    return scratch_bytes<F>(n);                                              \
  }                                                                          \
  extern "C" long long gtt_segscan_##name##_resident_tiles() {               \
    return resident_tiles<F>();                                              \
  }

SEGSCAN_ENTRY(add_i32, AddForm<int32_t>)
SEGSCAN_ENTRY(add_i64, AddForm<int64_t>)
SEGSCAN_ENTRY(add_f64, AddForm<double>)
SEGSCAN_ENTRY(max_f64, ExtForm<true>)
SEGSCAN_ENTRY(min_f64, ExtForm<false>)
SEGSCAN_ENTRY(comp_f32, CompForm)
SEGSCAN_ENTRY(max2_f32, Ext2Form<true>)
SEGSCAN_ENTRY(min2_f32, Ext2Form<false>)

extern "C" int gtt_segscan_tile() { return kTile; }

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
