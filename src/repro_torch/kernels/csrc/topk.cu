// MSTop-K threshold masking for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/topk.py::threshold_mask:
//   out = |g| >= t ? g : 0
// with t a scalar threshold read from device memory through a pointer (the
// wrapper never copies it to the host).  NaN fails the comparison and
// masks to 0; -0.0 passes when t <= 0 and is stored as it is.
//
// Bound: device-memory bytes, 4 read and 4 written per element.  One
// thread per element, grid-strided, coalesced loads and stores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
threshold_mask_kernel(const float* __restrict__ g, const float* __restrict__ t,
                      long long n, float* __restrict__ out) {
  const float tv = __ldg(t);
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const float x = __ldg(g + e);
    out[e] = fabsf(x) >= tv ? x : 0.f;
  }
}

long long capped_blocks(long long want) {
  const long long cap = 1ll << 20;  // the loop is grid-strided
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// g (n,) fp32, t a device pointer to one fp32 -> out (n,) fp32.
extern "C" int rt_topk_threshold_mask(const float* g, const float* t, long long n,
                                      float* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = capped_blocks((n + kThreads - 1) / kThreads);
  threshold_mask_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, t, n, out);
  return (int)cudaGetLastError();
}
