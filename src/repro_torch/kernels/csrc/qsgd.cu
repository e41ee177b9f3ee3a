// QSGD stochastic quantization for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/qsgd.py::quantize.  Per element:
//   s = |g| / norm * levels,  q = sign(g) * (floor(s) + [u < s - floor(s)])
// stored as int8 in [-levels, levels].  The uniform draw u comes from the
// caller, as in the Pallas kernel, so the kernel holds no generator.
//
// Bound: device-memory bytes.  It reads g and u (8 bytes) and writes q
// (1 byte) per element and does a handful of fp32 operations on them.
//
// It must equal the plain version (kernels/ref.py::qsgd_quantize) bit for
// bit.  So the scale is computed in the plain version's order, |g| / norm
// then * levels, with IEEE round-to-nearest intrinsics that the compiler
// never contracts or replaces; a hoisted levels / norm (the Pallas kernel's
// form) would round differently and flip carries.  norm is read from device
// memory through a pointer: the wrapper never copies it to the host.
// One thread per element, grid-strided; neighbouring threads read
// neighbouring addresses.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ g, const float* __restrict__ u,
                const float* __restrict__ norm, float levels, long long n,
                signed char* __restrict__ out) {
  const float nv = __ldg(norm);
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const float x = __ldg(g + e);
    const float s = __fmul_rn(__fdiv_rn(fabsf(x), nv), levels);
    const float low = floorf(s);
    const float mag = __fadd_rn(low, __ldg(u + e) < __fsub_rn(s, low) ? 1.f : 0.f);
    // sign(x) * mag; mag is a small whole number, so the cast is exact
    const float q = x > 0.f ? mag : (x < 0.f ? -mag : 0.f);
    out[e] = (signed char)(int)q;
  }
}

long long capped_blocks(long long want) {
  const long long cap = 1ll << 20;  // the loop is grid-strided
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// g, u (n,) fp32, norm a device pointer to one fp32 -> out (n,) int8.
extern "C" int rt_qsgd_quantize(const float* g, const float* u, const float* norm,
                                int levels, long long n, signed char* out,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (levels < 1 || levels > 127) return (int)cudaErrorInvalidValue;
  const long long blocks = capped_blocks((n + kThreads - 1) / kThreads);
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, u, norm, (float)levels, n, out);
  return (int)cudaGetLastError();
}
