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
// add in any other order (a sequential cumsum, a warp-shuffle scan,
// decoupled look-back, CUB's scan) gives other bits, so every form,
// integer and extreme ones too, runs this one tree.
//
// Design: the tree cut at tiles of kTile = 2^kTileLog cells, aligned to
// kTile, in three phases that apply the same combines in the same order:
//  1. up_kernel: a block loads a full tile into shared memory, up-sweeps
//     levels 1 .. kTileLog, and writes the tile's last cell (its total) to
//     aux. Levels above kTileLog touch only the tiles' last cells.
//  2. the same scan over aux (the levels above kTileLog of the whole
//     array are exactly the levels of aux's own tree), called again while
//     aux holds more than one tile;
//  3. down_kernel: a block loads its tile again, redoes the up-sweep
//     (the same bits), takes its last cell from the scanned aux, and
//     down-sweeps levels kTileLog .. 1; a combine whose left cell lies
//     before the tile reads the previous tile's scanned last cell.
// A partial last tile has no aux cell: no level above kTileLog reaches it.
// The input is read twice and the output written once; recomputing the
// up-sweep saves writing and reading back the tile's intermediate cells.
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
// grouped_reduce.cu). Integer adds wrap, as XLA's do.
//
// Bound on this card: bytes. A form reads each input once and writes each
// output once: (value bytes + 1 flag byte) a row in, value bytes a row
// out; at 17.28 M float64 rows, 9 bytes in and 8 out a row, 294 MB, about
// 0.088 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kTileLog = 11;
constexpr int kTile = 1 << kTileLog;   // cells a block scans: two a thread

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

// ---------------------------------------------------------------------
// forms: the cell, how a row of the inputs becomes one, how one becomes a
// row of the outputs, and the combine
// ---------------------------------------------------------------------

struct Ports {
  const void* x0;
  const void* x1;
  const uint8_t* reset;
  void* y0;
  void* y1;
  bool canon;   // write -0.0 as +0.0 (a scan of two or more rows)
};

template <typename T>
struct AddForm {
  struct Cell {
    T v;
    uint8_t f;
  };
  __device__ static Cell load(const Ports& p, long long i) {
    return {static_cast<const T*>(p.x0)[i], p.reset[i]};
  }
  __device__ static void store(const Ports& p, long long i, const Cell& c) {
    static_cast<T*>(p.y0)[i] = p.canon ? pos_zero(c.v) : c.v;
  }
  __device__ static Cell comb(const Cell& a, const Cell& b) {
    return {b.f ? b.v : add_wrap(a.v, b.v), static_cast<uint8_t>(a.f | b.f)};
  }
};

template <bool kMax>
struct ExtForm {
  struct Cell {
    double v;
    uint8_t f;
  };
  __device__ static Cell load(const Ports& p, long long i) {
    return {static_cast<const double*>(p.x0)[i], p.reset[i]};
  }
  __device__ static void store(const Ports& p, long long i, const Cell& c) {
    static_cast<double*>(p.y0)[i] = p.canon ? pos_zero(c.v) : c.v;
  }
  __device__ static Cell comb(const Cell& a, const Cell& b) {
    return {b.f ? b.v : ext64<kMax>(a.v, b.v),
            static_cast<uint8_t>(a.f | b.f)};
  }
};

struct CompForm {
  struct Cell {
    float s;
    float c;
    uint8_t f;
  };
  __device__ static Cell load(const Ports& p, long long i) {
    return {static_cast<const float*>(p.x0)[i],
            static_cast<const float*>(p.x1)[i], p.reset[i]};
  }
  __device__ static void store(const Ports& p, long long i, const Cell& c) {
    static_cast<float*>(p.y0)[i] = p.canon ? pos_zero(c.s) : c.s;
    static_cast<float*>(p.y1)[i] = p.canon ? pos_zero(c.c) : c.c;
  }
  __device__ static Cell comb(const Cell& a, const Cell& b) {
    const float t = __fadd_rn(a.s, b.s);
    const float e = fabsf(a.s) >= fabsf(b.s)
                        ? __fadd_rn(__fsub_rn(a.s, t), b.s)
                        : __fadd_rn(__fsub_rn(b.s, t), a.s);
    return {b.f ? b.s : t,
            b.f ? b.c : __fadd_rn(__fadd_rn(a.c, b.c), e),
            static_cast<uint8_t>(a.f | b.f)};
  }
};

template <bool kMax>
struct Ext2Form {
  struct Cell {
    float h;
    float l;
    uint8_t f;
  };
  __device__ static Cell load(const Ports& p, long long i) {
    return {static_cast<const float*>(p.x0)[i],
            static_cast<const float*>(p.x1)[i], p.reset[i]};
  }
  __device__ static void store(const Ports& p, long long i, const Cell& c) {
    static_cast<float*>(p.y0)[i] = p.canon ? pos_zero(c.h) : c.h;
    static_cast<float*>(p.y1)[i] = p.canon ? pos_zero(c.l) : c.l;
  }
  __device__ static Cell comb(const Cell& a, const Cell& b) {
    const bool pick_a = kMax ? (a.h > b.h) || (a.h == b.h && a.l >= b.l)
                             : (a.h < b.h) || (a.h == b.h && a.l <= b.l);
    const bool take_a = !b.f && pick_a;
    return {take_a ? a.h : b.h, take_a ? a.l : b.l,
            static_cast<uint8_t>(a.f | b.f)};
  }
};

// Where a level's cells come from and go to: the caller's rows (level 0)
// or an aux array of cells (the levels above).
template <class F>
struct RowIO {
  Ports p;
  __device__ typename F::Cell get(long long i) const { return F::load(p, i); }
  __device__ void put(long long i, const typename F::Cell& c) const {
    F::store(p, i, c);
  }
};

template <class F>
struct CellIO {
  typename F::Cell* cells;
  __device__ typename F::Cell get(long long i) const { return cells[i]; }
  __device__ void put(long long i, const typename F::Cell& c) const {
    cells[i] = c;
  }
};

// ---------------------------------------------------------------------
// the tile kernels
// ---------------------------------------------------------------------

// load `len` cells from base and up-sweep levels 1 .. kTileLog in place
template <class F, class IO>
__device__ void load_up_sweep(typename F::Cell* t, const IO& io,
                              long long base, int len) {
  for (int p = threadIdx.x; p < len; p += kThreads) t[p] = io.get(base + p);
  __syncthreads();
  for (int lev = 1; lev <= kTileLog; ++lev) {
    const int stride = 1 << lev;
    const int half = stride >> 1;
    const int count = len >> lev;   // cells m 2^L - 1 < len, m >= 1
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int i = (j + 1) * stride - 1;
      t[i] = F::comb(t[i - half], t[i]);
    }
    __syncthreads();
  }
}

template <class F, class IO>
__global__ void __launch_bounds__(kThreads)
    up_kernel(IO io, typename F::Cell* aux) {
  __shared__ typename F::Cell t[kTile];
  load_up_sweep<F>(t, io, static_cast<long long>(blockIdx.x) * kTile, kTile);
  if (threadIdx.x == 0) aux[blockIdx.x] = t[kTile - 1];
}

template <class F, class IO>
__global__ void __launch_bounds__(kThreads)
    down_kernel(IO in, IO out, long long n, const typename F::Cell* aux) {
  using Cell = typename F::Cell;
  __shared__ Cell t[kTile];
  __shared__ Cell prev;   // the previous tile's last cell, scanned
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const int len = static_cast<int>(
      n - base < kTile ? n - base : static_cast<long long>(kTile));
  load_up_sweep<F>(t, in, base, len);
  if (aux != nullptr) {
    if (threadIdx.x == 0) {
      if (tile > 0) prev = aux[tile - 1];
      if (len == kTile) t[kTile - 1] = aux[tile];
    }
    __syncthreads();
  }
  // in tile 0 the down-sweep starts at m = 1; in a later tile m = 0 is the
  // cell whose left operand is the previous tile's last
  const int m0 = tile == 0 ? 1 : 0;
  for (int lev = kTileLog; lev >= 1; --lev) {
    const int stride = 1 << lev;
    const int half = stride >> 1;
    const int count = len >= half ? (len - half) / stride + 1 - m0 : 0;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int m = m0 + j;
      const int i = m * stride + half - 1;
      const Cell a = m == 0 ? prev : t[m * stride - 1];
      t[i] = F::comb(a, t[i]);
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < len; p += kThreads) out.put(base + p, t[p]);
}

// The whole scan of n cells from `in` to `out`; aux cells of the levels
// above go to scratch (at most n / (kTile - 1) cells in all).
template <class F, class IO>
cudaError_t scan(IO in, IO out, long long n, typename F::Cell* scratch,
                 cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  typename F::Cell* aux = nullptr;
  if (tiles > 1) {
    const long long full = n / kTile;
    aux = scratch;
    up_kernel<F><<<static_cast<unsigned int>(full), kThreads, 0, stream>>>(
        in, aux);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (full > 1) {
      err = scan<F>(CellIO<F>{aux}, CellIO<F>{aux}, full, scratch + full,
                    stream);
      if (err != cudaSuccess) return err;
    }
  }
  down_kernel<F><<<static_cast<unsigned int>(tiles), kThreads, 0, stream>>>(
      in, out, n, aux);
  return cudaGetLastError();
}

template <class F>
int run(const void* x0, const void* x1, const void* reset, void* y0,
        void* y1, void* scratch, long long n, void* stream) {
  if (n <= 0) return 0;
  const Ports p{x0, x1, static_cast<const uint8_t*>(reset), y0, y1, n > 1};
  return static_cast<int>(scan<F>(
      RowIO<F>{p}, RowIO<F>{p}, n, static_cast<typename F::Cell*>(scratch),
      static_cast<cudaStream_t>(stream)));
}

template <class F>
long long scratch_bytes(long long n) {
  return (n / (kTile - 1) + 1) * static_cast<long long>(sizeof(
      typename F::Cell));
}

}  // namespace

#define SEGSCAN_ENTRY(name, F)                                               \
  extern "C" int gtt_segscan_##name(const void* x0, const void* x1,          \
                                    const void* reset, void* y0, void* y1,   \
                                    void* scratch, long long n,              \
                                    void* stream) {                          \
    return run<F>(x0, x1, reset, y0, y1, scratch, n, stream);                \
  }                                                                          \
  extern "C" long long gtt_segscan_##name##_scratch_bytes(long long n) {     \
    return scratch_bytes<F>(n);                                              \
  }

SEGSCAN_ENTRY(add_i32, AddForm<int32_t>)
SEGSCAN_ENTRY(add_i64, AddForm<int64_t>)
SEGSCAN_ENTRY(add_f64, AddForm<double>)
SEGSCAN_ENTRY(max_f64, ExtForm<true>)
SEGSCAN_ENTRY(min_f64, ExtForm<false>)
SEGSCAN_ENTRY(comp_f32, CompForm)
SEGSCAN_ENTRY(max2_f32, Ext2Form<true>)
SEGSCAN_ENTRY(min2_f32, Ext2Form<false>)

extern "C" const char* gtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
