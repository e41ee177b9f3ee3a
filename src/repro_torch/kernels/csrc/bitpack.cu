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
// popcount_votes: at p <= 4 the 4-byte counts are the whole bound (26 MB
//   at the main path's bucket, about 8 us), so what costs is latency and
//   the store path.  A warp owns groups of 32 consecutive words (1024
//   elements); lane i loads word i of each group from each row, one
//   coalesced 128-byte load per row, and a warp issues the loads of
//   kVotesGroups groups and kVotesRows rows before any arithmetic (masked
//   unrolled steps, no break, so nvcc keeps them in flight together).  The
//   counts are kept in bit slices: K = bit_length(p) planes per word, bit j
//   of plane k being bit k of element j's count, and a row is added with a
//   ripple of K and/xor pairs, O(K) operations per 32 elements.  The warp
//   then writes its 4 KB per group with 16-byte stores: for store t, lane l
//   takes the planes of word 4t + l/8 through __shfl_sync, spreads the
//   nibble at bit 4 (l % 8) of each into the four bytes of one word and
//   writes counts 4 (32t + l) ... +3.  Only the last ragged group stores
//   scalars (n % 4, and what lies past n is never written).  Indices inside
//   a row are 32-bit; each row's base pointer is formed once, in 64 bits.
//   The grid is at most kVotesBlocksPerSM blocks per SM and the warps walk
//   the groups grid-strided; the wrapper (kernels/bitpack.py, votes_plan)
//   plans it and passes K, which must be this file's.  p > 255 is counted
//   in chunks of 255 rows (8 planes), each chunk's counts added to 32 int
//   sums per lane, one group at a time.
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

// votes_kernel: the threads per block, word groups a warp loads together,
// rows loaded together per group, resident blocks per SM the grid is cut
// to, and planes at most (chunks of 255 rows); kernels/bitpack.py mirrors
// them.
constexpr int kVotesThreads = 256;
constexpr int kVotesGroups = 2;
constexpr int kVotesRows = 4;
constexpr int kVotesBlocksPerSM = 4;
constexpr int kMaxPlanes = 8;
constexpr int kGroupElems = 32 * 32;  // elements of one group of 32 words

// pl += x, bit by bit: a ripple of carries through the K planes.
template <int K>
__device__ __forceinline__ void add_bits(unsigned (&pl)[K], unsigned x) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned carry = pl[k] & x;
    pl[k] ^= x;
    x = carry;
  }
}

// Planes of rows [r_lo, r_hi) for the G groups whose word this lane holds
// at wi[j] (live[j]: the word holds elements).  The loads of kVotesRows rows
// of all G groups are issued before they are added.
template <int K, int G>
__device__ __forceinline__ void count_rows(const unsigned* __restrict__ w, long long words,
                                           int r_lo, int r_hi, const int (&wi)[G],
                                           const bool (&live)[G], unsigned (&pl)[G][K]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) pl[j][k] = 0u;
  for (int r = r_lo; r < r_hi; r += kVotesRows) {
    unsigned x[kVotesRows][G];
#pragma unroll
    for (int u = 0; u < kVotesRows; ++u) {
      const bool ok = r + u < r_hi;
      const unsigned* row = w + (long long)(r + u) * words;
#pragma unroll
      for (int j = 0; j < G; ++j) x[u][j] = ok && live[j] ? __ldg(row + wi[j]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kVotesRows; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) add_bits<K>(pl[j], x[u][j]);
  }
}

// The counts of elements 4 (32t + lane) ... +3 of a group, one per byte:
// the planes of word `src` (held by lane src), nibble at bit `shift`, bit b
// of each nibble moved to bit 8b (the four shifted copies of the nibble
// that the product adds do not overlap, so nothing carries).
template <int K>
__device__ __forceinline__ unsigned byte_counts(const unsigned (&pl)[K], int src, int shift) {
  unsigned c = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned nib = (__shfl_sync(kFull, pl[k], src) >> shift) & 0xfu;
    c |= ((nib * 0x00204081u) & 0x01010101u) << k;
  }
  return c;
}

// out[e .. e+3] = v, one 16-byte store where all four lie below n (out is
// 16-byte aligned and e a multiple of 4), else the ones that do.
__device__ __forceinline__ void store4(int* __restrict__ out, unsigned e, unsigned n, int4 v) {
  if (e + 4 <= n) {
    *reinterpret_cast<int4*>(out + e) = v;
  } else {
    if (e < n) out[e] = v.x;
    if (e + 1 < n) out[e + 1] = v.y;
    if (e + 2 < n) out[e + 2] = v.z;
  }
}

// K planes, G groups per warp step; kWide counts p > 255 in chunks of 255
// rows (K == kMaxPlanes, G == 1), summing each chunk's counts in ints.
template <int K, int G, bool kWide>
__global__ void __launch_bounds__(kVotesThreads, kVotesBlocksPerSM)
votes_kernel(const unsigned* __restrict__ w, int p, long long words, unsigned n, int groups,
             int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kVotesThreads + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * kVotesThreads) >> 5;
  const int shift = 4 * (lane & 7);
  const int wn = (int)((n + 31) / 32);  // words that hold elements
  for (int g0 = warp * G; g0 < groups; g0 += n_warps * G) {
    int wi[G];
    bool live[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      wi[j] = (g0 + j) * 32 + lane;
      live[j] = wi[j] < wn;
    }
    if constexpr (!kWide) {
      unsigned pl[G][K];
      count_rows<K, G>(w, words, 0, p, wi, live, pl);
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const unsigned c = byte_counts<K>(pl[j], 4 * t + (lane >> 3), shift);
          store4(out, (unsigned)(g0 + j) * kGroupElems + 4u * (32 * t + lane), n,
                 make_int4(c & 0xff, (c >> 8) & 0xff, (c >> 16) & 0xff, c >> 24));
        }
    } else {
      constexpr int chunk = (1 << K) - 1;
      int acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[t][b] = 0;
      for (int r = 0; r < p; r += chunk) {
        unsigned pl[1][K];
        count_rows<K, 1>(w, words, r, min(p, r + chunk), wi, live, pl);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const unsigned c = byte_counts<K>(pl[0], 4 * t + (lane >> 3), shift);
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[t][b] += (int)((c >> (8 * b)) & 0xff);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
        store4(out, (unsigned)g0 * kGroupElems + 4u * (32 * t + lane), n,
               make_int4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]));
    }
  }
}

// bit_length(p), at most kMaxPlanes.
int planes_for(int p) {
  int k = 0;
  while (k < kMaxPlanes && (1 << k) <= p) ++k;
  return k;
}

template <int K>
void launch_votes(int blocks, cudaStream_t st, const unsigned* w, int p, long long words,
                  unsigned n, int groups, int* out) {
  votes_kernel<K, kVotesGroups, false><<<blocks, kVotesThreads, 0, st>>>(w, p, words, n,
                                                                         groups, out);
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

// w (p, words) 32-bit words -> out (n,) int32 counts of set bits per element,
// n < 2^31 and at most 32 words; out 16-byte aligned.  `planes` is the
// wrapper's plan, which must be this file's; any blocks >= 1 is right (the
// warps walk the groups grid-strided).
extern "C" int rt_popcount_votes(const int* w, int p, long long words, long long n,
                                 int* out, int planes, long long blocks, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (p < 1 || n > words * 32 || n >= (1LL << 31) || planes != planes_for(p) ||
      blocks < 1 || blocks > (1LL << 31) - 1 || ((unsigned long long)out & 15))
    return (int)cudaErrorInvalidValue;
  const int groups = (int)((n + kGroupElems - 1) / kGroupElems);
  const unsigned* words_u = reinterpret_cast<const unsigned*>(w);
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = (int)blocks;
  const unsigned un = (unsigned)n;
  if (p > (1 << kMaxPlanes) - 1) {
    votes_kernel<kMaxPlanes, 1, true><<<nb, kVotesThreads, 0, st>>>(words_u, p, words, un,
                                                                     groups, out);
    return (int)cudaGetLastError();
  }
  switch (planes) {
    case 1: launch_votes<1>(nb, st, words_u, p, words, un, groups, out); break;
    case 2: launch_votes<2>(nb, st, words_u, p, words, un, groups, out); break;
    case 3: launch_votes<3>(nb, st, words_u, p, words, un, groups, out); break;
    case 4: launch_votes<4>(nb, st, words_u, p, words, un, groups, out); break;
    case 5: launch_votes<5>(nb, st, words_u, p, words, un, groups, out); break;
    case 6: launch_votes<6>(nb, st, words_u, p, words, un, groups, out); break;
    case 7: launch_votes<7>(nb, st, words_u, p, words, un, groups, out); break;
    default: launch_votes<8>(nb, st, words_u, p, words, un, groups, out); break;
  }
  return (int)cudaGetLastError();
}
