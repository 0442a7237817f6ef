// ADMM x-update pointwise spectral solve for Hopper (sm_90a).
//
//   X = (Ht * Y + Z) / (rho + HtH)        with Ht = conj(H), one rho per galaxy
//
// Replaces the TPU kernel galaxy_deconv_tpu/ops/pallas_kernels.py::
// x_update_spectral_pallas (body _solve_kernel), which ran the same algebra on
// separate real/imaginary fp32 planes in a batch-last (K, B) layout: that
// layout only served the TPU's 128-wide lanes.  Here the operands stay in the
// model's batch-first layout: Y, Ht, Z and X are complex64 (B, 2H, W+1) read as
// float2, HtH is fp32 (B, 2H, W+1) and rho is fp32 (B,).
//
// Bound on an H100: memory.  Each element reads 28 bytes and writes 8 for about
// 10 flops, far below the card's ~20 flops/byte balance point in fp32.  At the
// flagship's shapes (B = 256, 96 x 49 spectra: 1,204,224 elements) a launch
// moves 43.4 MB, 12.9 us at 3.35 TB/s.  The design therefore only keeps the
// traffic minimal: one thread per complex element in a grid-stride loop,
// neighbouring threads on neighbouring 8-byte elements (coalesced), every
// operand read once and the result written once, no shared memory, and one
// reciprocal per element as _solve_kernel computes it.

#include <climits>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) x_update_solve_kernel(
    const float2* __restrict__ Y, const float2* __restrict__ Ht, const float2* __restrict__ Z,
    const float* __restrict__ HtH, const float* __restrict__ rho, float2* __restrict__ out,
    long long n_per_gal, long long n_total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_total;
       i += stride) {
    const float recip = 1.0f / (rho[i / n_per_gal] + HtH[i]);
    const float2 y = Y[i];
    const float2 h = Ht[i];
    const float2 z = Z[i];
    float2 x;
    x.x = (h.x * y.x - h.y * y.y + z.x) * recip;
    x.y = (h.x * y.y + h.y * y.x + z.y) * recip;
    out[i] = x;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() as an int.
extern "C" int x_update_solve(const void* Y, const void* Ht, const void* Z, const void* HtH,
                              const void* rho, void* out, long long n_per_gal, int B,
                              void* stream) {
  const long long n_total = n_per_gal * static_cast<long long>(B);
  if (n_total <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_total + threads - 1) / threads;
  if (blocks > INT_MAX) blocks = INT_MAX;  // the grid-stride loop covers the rest
  x_update_solve_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(Y), static_cast<const float2*>(Ht),
      static_cast<const float2*>(Z), static_cast<const float*>(HtH),
      static_cast<const float*>(rho), static_cast<float2*>(out), n_per_gal, n_total);
  return static_cast<int>(cudaGetLastError());
}
