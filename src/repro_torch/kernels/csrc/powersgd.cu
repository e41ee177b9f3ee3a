// PowerSGD factor products for Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas kernels repro/kernels/powersgd.py::encode and ::decode.
//
//   encode  P = A @ X   A (n_a x n_b) fp32 given by strides, X (n_b x R) fp32
//   decode  M = P @ Q^T P (rows x R), Q (cols x R) fp32 -> (rows x cols) fp32
//
// With R <= 16 both do about two flops per byte of the big operand, so they
// are bound by device-memory bytes: the big matrix is streamed once, the
// skinny factors stay in registers, shared memory or L1.  Tensor cores,
// wgmma and TMA would not move that bound and are left out.
//
// encode has two access patterns, chosen by the wrapper from A's strides:
//   * encode_rows: A's rows are contiguous (M @ Q).  One warp walks one row,
//     lanes on neighbouring addresses, R partial sums per lane in registers,
//     then a warp-shuffle reduction.
//   * encode_cols: A's columns are contiguous (the transposed view M^T @ P,
//     never materialised).  A block owns 32 neighbouring output rows (one per
//     lane, so every load is coalesced) and 8 slices of the reduction dim;
//     the slices meet in shared memory.  Long reductions are also split over
//     grid.y into a scratch buffer that a second pass sums in a fixed order,
//     so the result does not depend on block scheduling.
// Ragged edges are masked in the kernels; nothing is padded or copied.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsWarps = 8;      // encode_rows: warps (output rows) per block
constexpr int kColsTile = 32;      // encode_cols: output rows per block
constexpr int kColsSlices = 8;     // encode_cols: reduction slices per block
constexpr int kDecodeThreads = 256;
constexpr int kDecodeRows = 32;    // decode: rows of the output per block step

template <int R>
__global__ void __launch_bounds__(kRowsWarps * 32)
encode_rows(const float* __restrict__ A, long long n_a, long long n_b,
            long long sa, const float* __restrict__ X, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long a = (long long)blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (a >= n_a) return;  // uniform over the warp
  const float* row = A + a * sa;
  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
  long long b = lane;
  for (; b + 96 < n_b; b += 128) {  // four loads in flight per lane
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(row + b + 32 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* x = X + (b + 32 * u) * R;
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = fmaf(v[u], __ldg(x + k), acc[k]);
    }
  }
  for (; b < n_b; b += 32) {
    const float v = __ldg(row + b);
    const float* x = X + b * R;
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = fmaf(v, __ldg(x + k), acc[k]);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    acc[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) out[a * R + k] = acc[k];
  }
}

// out (gridDim.y, n_a, R): partial sums over this block's reduction range.
template <int R>
__global__ void __launch_bounds__(kColsTile * kColsSlices)
encode_cols(const float* __restrict__ A, long long n_a, long long n_b,
            long long sb, const float* __restrict__ X, float* __restrict__ out,
            long long b_per_split) {
  __shared__ float part[kColsSlices * R * kColsTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long a = (long long)blockIdx.x * kColsTile + tx;
  const long long b0 = (long long)blockIdx.y * b_per_split;
  const long long b1 = min(n_b, b0 + b_per_split);
  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
  if (a < n_a) {
    const float* col = A + a;
    long long b = b0 + ty;
    constexpr int step = kColsSlices;
    for (; b + 3 * step < b1; b += 4 * step) {  // four loads in flight
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(col + (b + u * step) * sb);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* x = X + (b + u * step) * R;
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = fmaf(v[u], __ldg(x + k), acc[k]);
      }
    }
    for (; b < b1; b += step) {
      const float v = __ldg(col + b * sb);
      const float* x = X + b * R;
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = fmaf(v, __ldg(x + k), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) part[(ty * R + k) * kColsTile + tx] = acc[k];
  __syncthreads();
  if (ty == 0 && a < n_a) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kColsSlices; ++y) s += part[(y * R + k) * kColsTile + tx];
      out[((long long)blockIdx.y * n_a + a) * R + k] = s;
    }
  }
}

// out[i] = sum over splits of part[s][i], in split order.
__global__ void sum_splits(const float* __restrict__ part, long long count,
                           int splits, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * count + i];
    out[i] = s;
  }
}

// One thread per output column keeps Q's row in registers; the block stages
// kDecodeRows rows of P in shared memory and writes them row by row, so the
// stores of a warp are contiguous.
template <int R>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const float* __restrict__ P, const float* __restrict__ Q,
              long long rows, long long cols, float* __restrict__ out) {
  __shared__ float p_s[kDecodeRows * R];
  const long long j = (long long)blockIdx.x * kDecodeThreads + threadIdx.x;
  const bool active = j < cols;
  float q[R];
#pragma unroll
  for (int k = 0; k < R; ++k) q[k] = active ? __ldg(Q + j * R + k) : 0.f;
  for (long long i0 = (long long)blockIdx.y * kDecodeRows; i0 < rows;
       i0 += (long long)gridDim.y * kDecodeRows) {
    const long long n_i = min((long long)kDecodeRows, rows - i0);
    __syncthreads();
    for (int t = threadIdx.x; t < n_i * R; t += kDecodeThreads) p_s[t] = P[i0 * R + t];
    __syncthreads();
    if (active) {
      for (long long di = 0; di < n_i; ++di) {
        const float* p = p_s + di * R;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) s = fmaf(p[k], q[k], s);
        out[(i0 + di) * cols + j] = s;
      }
    }
  }
}

template <int R>
struct EncodeRows {
  static void run(const float* A, long long n_a, long long n_b, long long sa,
                  const float* X, float* out, cudaStream_t st) {
    const unsigned blocks = (unsigned)((n_a + kRowsWarps - 1) / kRowsWarps);
    encode_rows<R><<<blocks, kRowsWarps * 32, 0, st>>>(A, n_a, n_b, sa, X, out);
  }
};

template <int R>
struct EncodeCols {
  static void run(const float* A, long long n_a, long long n_b, long long sb,
                  const float* X, float* out, int splits, cudaStream_t st) {
    const long long per = (n_b + splits - 1) / splits;
    const dim3 grid((unsigned)((n_a + kColsTile - 1) / kColsTile), (unsigned)splits);
    encode_cols<R><<<grid, dim3(kColsTile, kColsSlices), 0, st>>>(A, n_a, n_b, sb, X,
                                                                    out, per);
  }
};

template <int R>
struct Decode {
  static void run(const float* P, const float* Q, long long rows, long long cols,
                  float* out, cudaStream_t st) {
    long long gy = (rows + kDecodeRows - 1) / kDecodeRows;
    if (gy > 65535) gy = 65535;
    const dim3 grid((unsigned)((cols + kDecodeThreads - 1) / kDecodeThreads), (unsigned)gy);
    decode_kernel<R><<<grid, kDecodeThreads, 0, st>>>(P, Q, rows, cols, out);
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

}  // namespace

// Reduction splits over grid.y that rt_powersgd_encode wants for the column
// path on the current device: about four blocks per SM, and no split shorter
// than 256 elements.  The caller sizes the scratch buffer from it.
extern "C" int rt_powersgd_encode_splits(long long n_a, long long n_b, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_a + kColsTile - 1) / kColsTile;
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > 64) s = 64;
  if (s > n_b / 256) s = n_b / 256;
  *splits = s < 1 ? 1 : (int)s;
  return 0;
}

// P = A @ X with A[a, b] at A[a * s_a + b * s_b]; one of s_a, s_b must be 1.
// scratch holds splits * n_a * r floats when splits > 1 (column path only).
extern "C" int rt_powersgd_encode(const float* A, long long n_a, long long n_b,
                                  long long s_a, long long s_b, const float* X,
                                  int r, float* out, float* scratch, int splits,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_a <= 0) return (int)cudaGetLastError();
  if (s_b == 1) return dispatch_rank<EncodeRows>(r, A, n_a, n_b, s_a, X, out, st);
  if (s_a != 1 || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  float* target = splits > 1 ? scratch : out;
  int err = dispatch_rank<EncodeCols>(r, A, n_a, n_b, s_b, X, target, splits, st);
  if (err != 0 || splits == 1) return err;
  const long long count = n_a * r;
  long long blocks = (count + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, 256, 0, st>>>(scratch, count, splits, out);
  return (int)cudaGetLastError();
}

// M = P @ Q^T, out (rows x cols) row-major.
extern "C" int rt_powersgd_decode(const float* P, const float* Q, long long rows,
                                  long long cols, int r, float* out, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  return dispatch_rank<Decode>(r, P, Q, rows, cols, out, (cudaStream_t)stream);
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
