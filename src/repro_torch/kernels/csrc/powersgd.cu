// PowerSGD factor products for Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas kernels repro/kernels/powersgd.py::encode and ::decode.
//
//   encode  P = A @ X   A (n_a x n_b) fp32 given by strides, X (n_b x R) fp32
//   decode  M = P @ Q^T P (rows x R), Q (cols x R) fp32 -> (rows x cols) fp32
//
// With R <= 16 both do at most two flops per byte of the big operand, so they
// are bound by device-memory bytes: the big matrix is streamed once and the
// skinny factors are read from L1.  At the main path's 26 MB the stream lasts
// about 8 us at the data-sheet rate, so what costs is latency: every warp
// keeps several 16-byte loads (or stores) of each row it owns in flight,
// nothing waits on a block-wide barrier before the first load, the grid is
// cut so that every SM gets about the same number of warps, and indices
// inside a row are 32-bit with masked (not broken-off) unrolled loops, which
// keeps an iteration's loads issued together.  Tensor cores are left out:
// the arithmetic is never the limit, and the products stay in full fp32.
//
// encode has two access patterns, chosen by the wrapper from A's strides:
//   * encode_rows: A's rows are contiguous (M @ Q).  A warp owns kRowsPerWarp
//     rows and walks them together, lanes on neighbouring 16-byte words;
//     each row of X it reads (R floats, from L1) serves all of its rows.  A
//     warp-shuffle sum ends the walk.
//   * encode_cols: A's columns are contiguous (the transposed view M^T @ P,
//     never materialised).  Each thread owns vec neighbouring output rows
//     (one 16-byte load per row of M) and walks a slice of the reduction
//     dim with vec x R sums in registers; the row of X it needs is the same
//     for the whole warp, one broadcast read from L1.  The block's slices
//     meet in shared memory in a fixed tree order.
// Where the output alone gives too few warps to fill the card, the reduction
// dim is split over grid.y: each split writes a partial, and the last block
// of a tile to arrive (an arrival counter per tile that resets itself) adds
// the partials in split order.  No floating-point atomics: the result is the
// same bits on every launch.  vec = 1 variants take a pointer, row stride or
// length that 16-byte accesses cannot; xvec = 4 reads X's rows as float4
// where R % 4 == 0 and X is 16-byte aligned.  Ragged edges are masked in the
// kernels and nothing is padded or copied.  Each form's block shape is fixed
// here; the wrapper (kernels/powersgd.py) picks the form, the variants and
// the split plan, passes the tile count it planned for (refused if it is not
// this file's), and allocates the scratch and counters.
#include <cuda_runtime.h>

namespace {

using ll = long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsThreads = 128;   // encode_rows: threads per block
constexpr int kColsThreads = 256;   // encode_cols: threads per block
constexpr int kColsSlices = kColsThreads / 32;  // encode_cols: warps down the rows
constexpr int kDecodeThreads = 128; // decode: threads per block
constexpr int kDecodeCwarps = 4;    // decode: warps side by side across the columns
constexpr int kDecodeSlices = kDecodeThreads / 32 / kDecodeCwarps;  // turns over the rows
constexpr int kRowsPerWarp = 4;   // encode_rows: rows of A per warp
constexpr int kRowsUnroll = 4;    // encode_rows: 16-byte loads in flight per row
constexpr int kColsUnroll = 8;    // encode_cols: rows of A in flight per thread
constexpr int kDecodeUnroll = 4;  // decode: output rows in flight per thread
static_assert((kColsSlices & (kColsSlices - 1)) == 0, "encode_cols sums its slices in a tree");
static_assert(kDecodeSlices >= 1 && kDecodeThreads % (32 * kDecodeCwarps) == 0,
              "decode's warps fill whole rows of a tile");

// v[0..V) = p[0..V); 16-byte aligned when V == 4.
template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// x[0..R) = row b of X (b x R row-major), float4 at a time when XV == 4.
template <int R, int XV>
__device__ __forceinline__ void load_row(const float* X, int b, float* x) {
#pragma unroll
  for (int k = 0; k < R; k += XV) load<XV>(X + b * R + k, x + k);
}

template <int N>
__device__ __forceinline__ void zero(float* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.f;
}

// The split epilogue shared by both encode forms.  Every thread of the
// block calls it after the block wrote its partial sums (`count` floats at
// offset `base` of its split's slab of `stride` floats in `part`).  The
// last block of the tile to arrive adds the partials in split order into
// `out`.  The tile's partials are read with eight loads in flight per
// thread, 16 bytes each where the offsets allow (part and out come from
// the caching allocator, 16-byte aligned).
template <int W>
__device__ __forceinline__ void add_partials(const float* p, float* o, ll stride, int splits) {
  float s[W];
  zero<W>(s);
  int y = 0;
  for (; y + 8 <= splits; y += 8) {
    float v[8][W];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (W == 4) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(p + (y + j) * stride));
        v[j][0] = t.x; v[j][1] = t.y; v[j][2] = t.z; v[j][3] = t.w;
      } else {
        v[j][0] = __ldcg(p + (y + j) * stride);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] += v[j][w];
  }
  for (; y < splits; ++y)
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] += __ldcg(p + y * stride + w);
  store<W>(o, s);
}

__device__ void finish_splits(const float* part, float* out, int* counter,
                              ll stride, ll base, int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int splits = (int)gridDim.y;
  if (stride % 4 == 0 && base % 4 == 0 && count % 4 == 0) {
    for (int t = threadIdx.x * 4; t < count; t += blockDim.x * 4)
      add_partials<4>(part + base + t, out + base + t, stride, splits);
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x)
      add_partials<1>(part + base + t, out + base + t, stride, splits);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// grid (ceil(n_a / (kRowsPerWarp * warps)), splits), kRowsThreads threads;
// split y reduces over
// [y * per, min(n_b, (y + 1) * per)), per a multiple of V.  Indices inside
// a row are 32-bit and the unrolled loops mask instead of breaking: both
// keep the loads of an iteration issued together.
template <int R, int V, int XV>
__global__ void __launch_bounds__(kRowsThreads)
encode_rows(const float* __restrict__ A, int n_a, int n_b, ll sa,
            const float* __restrict__ X, float* __restrict__ out,
            float* __restrict__ part, int* __restrict__ counters, int per) {
  constexpr int U = kRowsUnroll * 4 / V;  // the same bytes in flight for V = 1
  const int lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * (kRowsThreads / 32) * kRowsPerWarp;
  const int a0 = tile0 + (threadIdx.x >> 5) * kRowsPerWarp;
  const int b_lo = blockIdx.y * per;
  const int b_hi = min(n_b, b_lo + per);
  const float* row[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    live[i] = a0 + i < n_a;
    row[i] = A + (ll)(live[i] ? a0 + i : 0) * sa;
  }
  float acc[kRowsPerWarp][R];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) zero<R>(acc[i]);
  for (int c = b_lo + lane * V; c < b_hi; c += 32 * V * U) {
    float v[kRowsPerWarp][U][V];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cu = c + 32 * V * u;
        if (live[i] && cu < b_hi) load<V>(row[i] + cu, v[i][u]);
        else zero<V>(v[i][u]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cu = c + 32 * V * u;
#pragma unroll
      for (int w = 0; w < V; ++w) {
        float x[R];
        if (cu < b_hi) load_row<R, XV>(X, cu + w, x);
        else zero<R>(x);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[i][k] = fmaf(v[i][u][w], x[k], acc[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float s = acc[i][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      acc[i][k] = s;
    }
  // every lane holds every sum; lane j stores sums j, j + 32, ...
  float* dst = (gridDim.y == 1 ? out : part + (ll)blockIdx.y * n_a * R) + (ll)a0 * R;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (live[i] && (i * R + k) % 32 == lane) dst[i * R + k] = acc[i][k];
  if (gridDim.y == 1) return;
  finish_splits(part, out, counters + blockIdx.x, (ll)n_a * R, (ll)tile0 * R,
                min(kRowsThreads / 32 * kRowsPerWarp, n_a - tile0) * R);
}

// grid (ceil(n_a / (32 V)), splits), blockDim 32 x kColsSlices: the warps split
// the block's rows of M.  Split y reduces over [y * per, min(n_b, (y + 1) *
// per)).  A[a, b] = A[a + b * sb].
template <int R, int V, int XV>
__global__ void __launch_bounds__(kColsThreads)
encode_cols(const float* __restrict__ A, int n_a, int n_b, ll sb,
            const float* __restrict__ X, float* __restrict__ out,
            float* __restrict__ part, int* __restrict__ counters, int per) {
  constexpr int width = 32 * V;  // output rows of the tile
  constexpr int slices = kColsSlices;
  __shared__ float red[(slices / 2) * R * width];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int pos = tx * V;
  const int tile0 = blockIdx.x * width;
  const int a = tile0 + pos;
  const bool active = a < n_a;  // V == 4 only when n_a % 4 == 0
  const int b_lo = blockIdx.y * per;
  const int b_hi = min(n_b, b_lo + per);
  float acc[V][R];
#pragma unroll
  for (int w = 0; w < V; ++w) zero<R>(acc[w]);
  if (active) {
    const ll step = (ll)slices * sb;
    const float* pb = A + a + (ll)(b_lo + ty) * sb;
    for (int b = b_lo + ty; b < b_hi; b += slices * kColsUnroll, pb += step * kColsUnroll) {
      float v[kColsUnroll][V];
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        if (b + slices * u < b_hi) load<V>(pb + step * u, v[u]);
        else zero<V>(v[u]);
      }
#pragma unroll
      for (int u = 0; u < kColsUnroll; ++u) {
        const int bu = b + slices * u;
        float x[R];
        if (bu < b_hi) load_row<R, XV>(X, bu, x);
        else zero<R>(x);
#pragma unroll
        for (int w = 0; w < V; ++w)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[w][k] = fmaf(v[u][w], x[k], acc[w][k]);
      }
    }
  }
  // slices meet in a fixed tree order: the upper half onto the lower half
  for (int h = slices / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (ty >= h && ty < 2 * h) {
#pragma unroll
      for (int w = 0; w < V; ++w)
#pragma unroll
        for (int k = 0; k < R; ++k) red[((ty - h) * R + k) * width + pos + w] = acc[w][k];
    }
    __syncthreads();
    if (ty < h) {
#pragma unroll
      for (int w = 0; w < V; ++w)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[w][k] += red[(ty * R + k) * width + pos + w];
    }
  }
  float* dst = gridDim.y == 1 ? out : part + (ll)blockIdx.y * n_a * R;
  if (ty == 0 && active) {
#pragma unroll
    for (int w = 0; w < V; ++w)
#pragma unroll
      for (int k = 0; k < R; ++k) dst[(ll)(a + w) * R + k] = acc[w][k];
  }
  if (gridDim.y == 1) return;
  finish_splits(part, out, counters + blockIdx.x, (ll)n_a * R, (ll)tile0 * R,
                min(width, n_a - tile0) * R);
}

// grid (ceil(cols / (32 V cw)), splits), kDecodeThreads threads: cw =
// kDecodeCwarps warps side by side cover the tile's 32 V cw columns, the
// kDecodeSlices rows of them take turns over the rows; block row y writes
// rows [y * per, min(rows, (y + 1) * per)).  Each thread keeps Q's rows for
// its V columns in registers and writes one V-wide store per output row; the
// row of P is the same for the whole warp, a broadcast from L1.
template <int R, int V, int XV>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const float* __restrict__ P, const float* __restrict__ Q,
              int rows, int cols, float* __restrict__ out, int per) {
  constexpr int cw = kDecodeCwarps, warps = kDecodeSlices;
  const int tx = threadIdx.x & 31, ty = (threadIdx.x >> 5) / cw;
  const int j = blockIdx.x * 32 * V * cw + ((threadIdx.x >> 5) % cw) * 32 * V + tx * V;
  if (j >= cols) return;  // V == 4 only when cols % 4 == 0
  float q[V][R];
#pragma unroll
  for (int w = 0; w < V; ++w) load_row<R, XV>(Q, j + w, q[w]);
  const int i_lo = blockIdx.y * per;
  const int i_hi = min(rows, i_lo + per);
  float* col = out + j;
  for (int i = i_lo + ty; i < i_hi; i += warps * kDecodeUnroll) {
    float p[kDecodeUnroll][R];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      if (i + warps * u < i_hi) load_row<R, XV>(P, i + warps * u, p[u]);
      else zero<R>(p[u]);
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int iu = i + warps * u;
      if (iu < i_hi) {
        float s[V];
#pragma unroll
        for (int w = 0; w < V; ++w) {
          s[w] = 0.f;
#pragma unroll
          for (int k = 0; k < R; ++k) s[w] = fmaf(p[u][k], q[w][k], s[w]);
        }
        store<V>(col + (ll)iu * cols, s);
      }
    }
  }
}

// Launches Kernel<R, V, XV> for the runtime vec and xvec; xvec 4 exists
// only where R % 4 == 0.
#define RT_VARIANTS(kernel, R, vec, xvec, grid, threads, st, ...)             \
  do {                                                                         \
    if constexpr (R % 4 == 0) {                                                \
      if (xvec == 4) {                                                         \
        if (vec == 4) kernel<R, 4, 4><<<grid, threads, 0, st>>>(__VA_ARGS__);  \
        else kernel<R, 1, 4><<<grid, threads, 0, st>>>(__VA_ARGS__);           \
        break;                                                                 \
      }                                                                        \
    }                                                                          \
    if (vec == 4) kernel<R, 4, 1><<<grid, threads, 0, st>>>(__VA_ARGS__);      \
    else kernel<R, 1, 1><<<grid, threads, 0, st>>>(__VA_ARGS__);               \
  } while (0)

struct Launch {
  int vec, xvec, threads;
  dim3 grid;
  cudaStream_t st;
};

template <int R>
struct EncodeRows {
  static void run(Launch l, const float* A, int n_a, int n_b, ll sa, const float* X,
                  float* out, float* part, int* counters, int per) {
    RT_VARIANTS(encode_rows, R, l.vec, l.xvec, l.grid, l.threads, l.st, A, n_a, n_b, sa,
                X, out, part, counters, per);
  }
};

template <int R>
struct EncodeCols {
  static void run(Launch l, const float* A, int n_a, int n_b, ll sb, const float* X,
                  float* out, float* part, int* counters, int per) {
    RT_VARIANTS(encode_cols, R, l.vec, l.xvec, l.grid, l.threads, l.st, A, n_a, n_b, sb,
                X, out, part, counters, per);
  }
};

template <int R>
struct Decode {
  static void run(Launch l, const float* P, const float* Q, int rows, int cols, float* out,
                  int per) {
    RT_VARIANTS(decode_kernel, R, l.vec, l.xvec, l.grid, l.threads, l.st, P, Q, rows,
                cols, out, per);
  }
};

// Instantiates Launcher<1..16>::run and calls the one for rank r.
template <template <int> class Launcher, typename... Args>
int dispatch_rank(int r, Args... args) {
  switch (r) {
    case 1: Launcher<1>::run(args...); break;
    case 2: Launcher<2>::run(args...); break;
    case 3: Launcher<3>::run(args...); break;
    case 4: Launcher<4>::run(args...); break;
    case 5: Launcher<5>::run(args...); break;
    case 6: Launcher<6>::run(args...); break;
    case 7: Launcher<7>::run(args...); break;
    case 8: Launcher<8>::run(args...); break;
    case 9: Launcher<9>::run(args...); break;
    case 10: Launcher<10>::run(args...); break;
    case 11: Launcher<11>::run(args...); break;
    case 12: Launcher<12>::run(args...); break;
    case 13: Launcher<13>::run(args...); break;
    case 14: Launcher<14>::run(args...); break;
    case 15: Launcher<15>::run(args...); break;
    case 16: Launcher<16>::run(args...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

ll cdiv(ll a, ll b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

// A split plan [y * per, (y + 1) * per) for y < splits covers [0, n) once,
// with no empty split.
bool covers(ll n, int splits, ll per) {
  if (splits < 1 || splits > 65535 || per < 1) return false;
  return n == 0 ? splits == 1 : (splits - 1) * per < n && splits * per >= n;
}

// Lengths the kernels index with 32-bit ints, with room for the unrolled
// steps past the end.
bool small(ll n, int r) { return n >= 0 && n * (r > 1 ? r : 1) < (1LL << 30); }

// xvec 4 reads rows of R floats of `x` as float4.
bool xvec_ok(int xvec, int r, const float* x) {
  return xvec == 1 || (xvec == 4 && r % 4 == 0 && aligned16(x));
}

}  // namespace

// P = A @ X with A[a, b] at A[a * s_a + b * s_b].  cols_form 0 needs s_b == 1
// (encode_rows), 1 needs s_a == 1 (encode_cols).  vec 4 needs A 16-byte
// aligned, the other stride a multiple of 4, and n_b (rows form) or n_a
// (cols form) a multiple of 4; vec 1 takes anything.  `tiles` is the
// wrapper's count of blocks along n_a, which must be this form's.  With
// splits > 1, scratch holds splits * n_a * r floats and counters at least
// n_counters zeroed ints, one per tile, which the kernel leaves zeroed.
extern "C" int rt_powersgd_encode(const float* A, ll n_a, ll n_b, ll s_a, ll s_b,
                                  const float* X, int r, float* out, float* scratch,
                                  int* counters, ll n_counters, int cols_form, int vec,
                                  int xvec, ll tiles, int splits, ll per, void* stream) {
  if (n_a <= 0) return (int)cudaGetLastError();
  if ((vec != 1 && vec != 4) || !covers(n_b, splits, per) || !xvec_ok(xvec, r, X) ||
      !small(n_a, r) || !small(n_b, r))
    return (int)cudaErrorInvalidValue;
  const int threads = cols_form ? kColsThreads : kRowsThreads;
  if (tiles != (cols_form ? cdiv(n_a, 32LL * vec) : cdiv(n_a, threads / 32 * kRowsPerWarp)))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (tiles > n_counters || !scratch || !counters))
    return (int)cudaErrorInvalidValue;
  const Launch l{vec, xvec, threads, dim3((unsigned)tiles, (unsigned)splits),
                 (cudaStream_t)stream};
  if (!cols_form) {
    if (s_b != 1) return (int)cudaErrorInvalidValue;
    if (vec == 4 && (!aligned16(A) || n_b % 4 || per % 4 || (n_a > 1 && s_a % 4)))
      return (int)cudaErrorInvalidValue;
    return dispatch_rank<EncodeRows>(r, l, A, (int)n_a, (int)n_b, s_a, X, out, scratch,
                                     counters, (int)per);
  }
  if (s_a != 1) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (!aligned16(A) || n_a % 4 || (n_b > 1 && s_b % 4)))
    return (int)cudaErrorInvalidValue;
  return dispatch_rank<EncodeCols>(r, l, A, (int)n_a, (int)n_b, s_b, X, out, scratch,
                                   counters, (int)per);
}

// M = P @ Q^T, out (rows x cols) row-major; vec 4 needs cols % 4 == 0 and
// out 16-byte aligned, xvec 4 needs P and Q 16-byte aligned and r % 4 == 0.
// `tiles` (blocks across the columns) must be this file's; block row y
// writes rows [y * per, (y + 1) * per).
extern "C" int rt_powersgd_decode(const float* P, const float* Q, ll rows, ll cols,
                                  int r, float* out, int vec, int xvec, ll tiles,
                                  int splits, ll per, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  if ((vec != 1 && vec != 4) || !covers(rows, splits, per) || !xvec_ok(xvec, r, P) ||
      !xvec_ok(xvec, r, Q) || !small(rows, r) || !small(cols, r) ||
      (vec == 4 && (cols % 4 || !aligned16(out))) ||
      tiles != cdiv(cols, 32LL * vec * kDecodeCwarps))
    return (int)cudaErrorInvalidValue;
  const Launch l{vec, xvec, kDecodeThreads, dim3((unsigned)tiles, (unsigned)splits),
                 (cudaStream_t)stream};
  return dispatch_rank<Decode>(r, l, P, Q, (int)rows, (int)cols, out, (int)per);
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
