// SignSGD bit packing and vote counting for Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/bitpack.py::pack_signs and
// ::popcount_votes.  Both do a few integer operations per element and are
// bound by device-memory bytes: pack reads 4 bytes per element and writes
// 1 bit; the vote count reads p bits and writes 4 bytes per element.
//
// pack_signs: a warp owns 32 consecutive words.  For each word its lanes
//   load 32 neighbouring floats (one coalesced 128-byte load) and
//   __ballot_sync(g >= 0) yields the word with bit i = lane i, the
//   little-endian order of the reference.  All 32 loads are issued before
//   the ballots, and lane i keeps word i, so the warp stores its 32 words at
//   once.  Elements past n count as negative: the pad bits are 0.  The
//   comparison is IEEE: -0.0 packs as 1 and NaN as 0.
// popcount_votes: one thread per element sums bit (e % 32) of word (e / 32)
//   over the p rows.  The 32 threads of a warp read the same word, which the
//   hardware broadcasts, and store 32 neighbouring counts.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ g, long long n, long long words,
            int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long w0 = warp * 32; w0 < words; w0 += n_warps * 32) {
    float v[32];
#pragma unroll
    for (int it = 0; it < 32; ++it) {
      const long long e = (w0 + it) * 32 + lane;
      v[it] = e < n ? __ldg(g + e) : -1.f;
    }
    unsigned mine = 0;
#pragma unroll
    for (int it = 0; it < 32; ++it) {
      const unsigned word = __ballot_sync(kFull, v[it] >= 0.f);
      if (lane == it) mine = word;
    }
    if (w0 + lane < words) out[w0 + lane] = (int)mine;
  }
}

__global__ void __launch_bounds__(kThreads)
votes_kernel(const int* __restrict__ w, int p, long long words, long long n,
             int* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long word = e >> 5;
    const unsigned bit = (unsigned)(e & 31);
    int s = 0;
    for (int r = 0; r < p; ++r)
      s += (int)(((unsigned)__ldg(w + (long long)r * words + word) >> bit) & 1u);
    out[e] = s;
  }
}

long long capped_blocks(long long want) {
  const long long cap = 1ll << 20;  // the loops are grid-strided
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// g (n,) fp32 -> out (ceil(n / 32),) 32-bit words.
extern "C" int rt_pack_signs(const float* g, long long n, int* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long words = (n + 31) / 32;
  const long long warps = (words + 31) / 32;
  const long long blocks = capped_blocks((warps * 32 + kThreads - 1) / kThreads);
  pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(g, n, words, out);
  return (int)cudaGetLastError();
}

// w (p, words) 32-bit words -> out (n,) int32 counts of set bits per element.
extern "C" int rt_popcount_votes(const int* w, int p, long long words, long long n,
                                 int* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (p < 1 || n > words * 32) return (int)cudaErrorInvalidValue;
  const long long blocks = capped_blocks((n + kThreads - 1) / kThreads);
  votes_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(w, p, words, n,
                                                                        out);
  return (int)cudaGetLastError();
}
