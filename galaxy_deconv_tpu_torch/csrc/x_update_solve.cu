// ADMM x-update pointwise spectral solve for Hopper (sm_90a), and its gradient.
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
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// Gradient of the solve for a real loss L, in PyTorch's convention for complex
// tensors: G = dL/dRe X + i dL/dIm X, d = rho + HtH,
//
//   grad_Z      = G / d
//   grad_rho[b] = -sum_k (Re G Re X + Im G Im X) / d          over galaxy b
//
// The JAX package has no backward kernel: it differentiates XLA's fused solve.
// Bound: memory again, 28 bytes per element (read G, X, HtH; write grad_Z) for
// about 9 flops: 1.26 us at the trainer's (32, 96, 49), 10.1 us at (256, 96, 49).
//
// Design.  S blocks per galaxy (S in 1, 2, 4, 8, picked by the launcher from
// the batch and the card's SM count, so that even B = 32 fills 132 SMs), each
// on a contiguous chunk of the galaxy's K elements.  When K is even and the
// pointers allow it, a thread loads two complex values of G and X as one
// float4 and two of HtH as one float2, kBackwardUnroll such triples before it
// uses any, so enough bytes are in flight to hide DRAM latency; otherwise it
// takes 8-byte loads on the same plan.  grad_Z is written as it goes.  Each
// block sums its share of grad_rho in registers, then with warp shuffles and
// one shared slot per warp in a fixed order.  With S > 1 the S blocks of a
// galaxy form one thread-block cluster: each block writes its sum into block
// rank 0's shared memory through distributed shared memory, and after one
// cluster barrier rank 0 adds the S sums in rank order and writes grad_rho.
// The barrier that makes remote shared memory safe to touch (every block of
// the cluster has started) is split: arrived at the kernel's start, waited
// for only after the block's loads.  With S = 1 the kernel is launched
// without a cluster, which costs a graph-replayed launch about 1 us less.
// No atomics, no global scratch, nothing to zero: the same inputs give the
// same bits every run, and the launch captures into a CUDA graph.
constexpr int kBackwardThreads = 256;
constexpr int kBackwardUnroll = 4;
constexpr int kMaxSplits = 8;         // the largest portable cluster
constexpr int kMinBlocksPerSM = 1;    // the launcher raises S until every SM has a block

// Sum of -grad_rho's terms over units [lo, hi) of one galaxy, writing grad_Z.
// A unit is two complex elements (kVec) or one.
template <bool kVec>
__device__ __forceinline__ float backward_chunk(const float2* __restrict__ G, const float2* __restrict__ X,
                                                const float* __restrict__ HtH, float2* __restrict__ grad_Z,
                                                float r, long long lo, long long hi) {
  using C = typename std::conditional<kVec, float4, float2>::type;  // complex values of a unit
  using H = typename std::conditional<kVec, float2, float>::type;   // HtH values of a unit
  const C* g_in = reinterpret_cast<const C*>(G);
  const C* x_in = reinterpret_cast<const C*>(X);
  const H* h_in = reinterpret_cast<const H*>(HtH);
  C* z_out = reinterpret_cast<C*>(grad_Z);
  float acc = 0.0f;
  for (long long p = lo + threadIdx.x; p < hi; p += kBackwardThreads * kBackwardUnroll) {
    C g[kBackwardUnroll], x[kBackwardUnroll];
    H h[kBackwardUnroll];
#pragma unroll
    for (int u = 0; u < kBackwardUnroll; ++u) {
      const long long q = p + u * kBackwardThreads;
      if (q < hi) {
        g[u] = g_in[q];
        x[u] = x_in[q];
        h[u] = h_in[q];
      }
    }
#pragma unroll
    for (int u = 0; u < kBackwardUnroll; ++u) {
      const long long q = p + u * kBackwardThreads;
      if (q < hi) {
        if constexpr (kVec) {
          const float r0 = 1.0f / (r + h[u].x);
          const float r1 = 1.0f / (r + h[u].y);
          z_out[q] = make_float4(g[u].x * r0, g[u].y * r0, g[u].z * r1, g[u].w * r1);
          acc += (g[u].x * x[u].x + g[u].y * x[u].y) * r0;
          acc += (g[u].z * x[u].z + g[u].w * x[u].w) * r1;
        } else {
          const float r0 = 1.0f / (r + h[u]);
          z_out[q] = make_float2(g[u].x * r0, g[u].y * r0);
          acc += (g[u].x * x[u].x + g[u].y * x[u].y) * r0;
        }
      }
    }
  }
  return acc;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// Grid: S * B blocks, in clusters of S when S > 1; block b * S + s takes chunk s
// of galaxy b.
template <int S, bool kVec>
__global__ void __launch_bounds__(kBackwardThreads) x_update_solve_backward_kernel(
    const float2* __restrict__ G, const float2* __restrict__ X, const float* __restrict__ HtH,
    const float* __restrict__ rho, float2* __restrict__ grad_Z, float* __restrict__ grad_rho,
    long long n_per_gal) {
  if constexpr (S > 1) cluster_arrive_relaxed();  // this block has started
  const unsigned int rank = blockIdx.x % S;         // the block's rank in its cluster
  const long long gal = blockIdx.x / S;
  const long long base = gal * n_per_gal;
  const long long units = kVec ? n_per_gal / 2 : n_per_gal;
  const long long per = (units + S - 1) / S;
  const long long lo = rank * per;
  const long long hi = lo + per < units ? lo + per : units;
  float acc = backward_chunk<kVec>(G + base, X + base, HtH + base, grad_Z + base, rho[gal], lo, hi);

  for (int offset = 16; offset > 0; offset >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, offset);
  __shared__ float warp_sums[kBackwardThreads / 32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kBackwardThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int offset = 16; offset > 0; offset >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if constexpr (S == 1) {
    if (threadIdx.x == 0) grad_rho[gal] = -acc;
  } else {
    __shared__ float block_sums[S];  // rank 0's receives the cluster's S block sums
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every block of the cluster has started: its shared memory exists
    if (threadIdx.x == 0) *cluster.map_shared_rank(&block_sums[rank], 0) = acc;
    cluster.sync();  // the S sums are in rank 0's shared memory
    if (rank == 0 && threadIdx.x == 0) {
      float total = 0.0f;
      for (int s = 0; s < S; ++s) total += block_sums[s];
      grad_rho[gal] = -total;
    }
  }
}

template <int S, bool kVec>
cudaError_t launch_backward(const float2* G, const float2* X, const float* HtH, const float* rho, float2* grad_Z,
                            float* grad_rho, long long n_per_gal, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(S) * static_cast<unsigned int>(B));
  cfg.blockDim = dim3(kBackwardThreads);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, x_update_solve_backward_kernel<S, kVec>, G, X, HtH, rho, grad_Z, grad_rho,
                            n_per_gal);
}

template <bool kVec>
cudaError_t launch_backward_splits(int S, const float2* G, const float2* X, const float* HtH, const float* rho,
                                   float2* grad_Z, float* grad_rho, long long n_per_gal, int B,
                                   cudaStream_t stream) {
  switch (S) {
    case 1: return launch_backward<1, kVec>(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream);
    case 2: return launch_backward<2, kVec>(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream);
    case 4: return launch_backward<4, kVec>(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream);
    case 8: return launch_backward<8, kVec>(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Launches the backward at S blocks per galaxy; returns the launch's CUDA error.
int backward_at(const void* G_, const void* X_, const void* HtH_, const void* rho_, void* grad_Z_,
                void* grad_rho_, long long n_per_gal, int B, int S, void* stream_) {
  if (B <= 0) return 0;
  if (static_cast<long long>(S) * B > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* G = static_cast<const float2*>(G_);
  const auto* X = static_cast<const float2*>(X_);
  const auto* HtH = static_cast<const float*>(HtH_);
  const auto* rho = static_cast<const float*>(rho_);
  auto* grad_Z = static_cast<float2*>(grad_Z_);
  auto* grad_rho = static_cast<float*>(grad_rho_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  // 16-byte loads need every galaxy's base 16-byte aligned: K even and aligned pointers
  const bool vec = n_per_gal % 2 == 0 && aligned(G, 16) && aligned(X, 16) && aligned(grad_Z, 16) && aligned(HtH, 8);
  const cudaError_t err =
      vec ? launch_backward_splits<true>(S, G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream)
          : launch_backward_splits<false>(S, G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// S for (n_per_gal, B) on the current device: the least S in 1, 2, 4, 8 that
// gives the grid kMinBlocksPerSM blocks per SM, without cutting a galaxy into
// chunks of fewer than kBackwardThreads elements.  On an H100 (132 SMs) at
// K = 4,704: S = 8 at B = 32, S = 1 from B = 132 on.
cudaError_t pick_splits(long long n_per_gal, int B, int* S) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *S = 1;
  while (*S < kMaxSplits && static_cast<long long>(*S) * B < static_cast<long long>(kMinBlocksPerSM) * sms &&
         n_per_gal >= 2LL * *S * kBackwardThreads)
    *S *= 2;
  return cudaSuccess;
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

// The blocks per galaxy that x_update_solve_backward launches for (n_per_gal, B)
// on the current device, or 0 if the device cannot be queried.
extern "C" int x_update_solve_backward_splits(long long n_per_gal, int B) {
  int S = 0;
  return pick_splits(n_per_gal, B, &S) == cudaSuccess ? S : 0;
}

// Launches on `stream` (a cudaStream_t), x_update_solve_backward_splits() blocks
// per galaxy, and returns the launch's CUDA error as an int.
extern "C" int x_update_solve_backward(const void* G, const void* X, const void* HtH, const void* rho,
                                       void* grad_Z, void* grad_rho, long long n_per_gal, int B,
                                       void* stream) {
  int S = 0;
  const cudaError_t err = pick_splits(n_per_gal, B, &S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return backward_at(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, S, stream);
}

// The same at a given S in 1, 2, 4, 8 (cudaErrorInvalidValue otherwise): a
// measurement entry point, so that each S can be timed on the card.
extern "C" int x_update_solve_backward_at(const void* G, const void* X, const void* HtH, const void* rho,
                                          void* grad_Z, void* grad_rho, long long n_per_gal, int B, int S,
                                          void* stream) {
  return backward_at(G, X, HtH, rho, grad_Z, grad_rho, n_per_gal, B, S, stream);
}
