// K1: the W == 1 rank-1 (Sherman-Morrison) z-solve of CCSC, for Hopper.
//
// Replaces the TPU kernel ccsc_code_iccv2017_tpu/ops/pallas_kernels.py::
// solve_z_rank1_pallas (pallas_call at :118). Per image n and frequency f:
//
//   g_k = dinv_k * (conj(d_k) * xi1 + rho * xi2_k)
//   t   = sum_k d_k g_k
//   den = 1 + sum_k |d_k|^2 dinv_k
//   z_k = g_k - dinv_k * conj(d_k) * t / den
//
// Shapes (all contiguous, complex64 interleaved as float2):
//   dhat [K, F] c64, xi1 [N, F] c64, xi2 [N, K, F] c64, dinv [K, F] f32
//   -> z [N, K, F] c64.
//
// Bound: bytes. Each frequency needs ~35 K N real flops against
// K * (12 + 16 N) + 8 N bytes moved (dhat 8K, dinv 4K, xi2 8NK, z 8NK,
// xi1 8N), far below the card's flop/byte balance, so the least time is
// those bytes over the memory rate.
//
// Design (simple and right first): one thread per (n, f), f fastest across
// the warp, so every k-row access is one coalesced 8-byte (or 4-byte) load
// per thread. A first loop over k accumulates t and den in registers; a
// second loop over k recomputes g_k and writes z_k. The second pass
// re-reads dhat, dinv and xi2 (dhat/dinv are shared by every n and mostly
// hit in L2; xi2 is read twice from memory). Keeping the k-column of
// dhat/dinv/xi2 in shared memory between the passes is left to a later
// change. The TPU kernel's re/im plane split and its padding of K to 8
// sublanes do not carry over: the kernel reads interleaved complex64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void solve_z_rank1_kernel(const float2* __restrict__ dhat,
                                     const float2* __restrict__ xi1,
                                     const float2* __restrict__ xi2,
                                     const float* __restrict__ dinv,
                                     float2* __restrict__ z, float rho, int K,
                                     int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (f >= F) return;
  const size_t nF = (size_t)n * F;
  const size_t nKF = (size_t)n * K * F;
  const float2 x1 = xi1[nF + f];

  float tre = 0.f, tim = 0.f, den = 1.f;
  for (int k = 0; k < K; ++k) {
    const size_t kf = (size_t)k * F + f;
    const float2 d = dhat[kf];
    const float gi = dinv[kf];
    const float2 x2 = xi2[nKF + kf];
    const float gre = gi * (d.x * x1.x + d.y * x1.y + rho * x2.x);
    const float gim = gi * (d.x * x1.y - d.y * x1.x + rho * x2.y);
    tre += d.x * gre - d.y * gim;
    tim += d.x * gim + d.y * gre;
    den += (d.x * d.x + d.y * d.y) * gi;
  }
  const float sre = tre / den;
  const float sim = tim / den;

  for (int k = 0; k < K; ++k) {
    const size_t kf = (size_t)k * F + f;
    const float2 d = dhat[kf];
    const float gi = dinv[kf];
    const float2 x2 = xi2[nKF + kf];
    const float gre = gi * (d.x * x1.x + d.y * x1.y + rho * x2.x);
    const float gim = gi * (d.x * x1.y - d.y * x1.x + rho * x2.y);
    float2 out;
    out.x = gre - gi * (d.x * sre + d.y * sim);
    out.y = gim - gi * (d.x * sim - d.y * sre);
    z[nKF + kf] = out;
  }
}

constexpr int kThreads = 256;

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers of contiguous tensors; the caller checks
// shapes, types and that N <= 65535 (the grid's y extent).
extern "C" int ccsc_solve_z_rank1(const void* dhat, const void* xi1,
                                  const void* xi2, const void* dinv, void* z,
                                  float rho, int K, int F, int N,
                                  void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((F + kThreads - 1) / kThreads, N);
  solve_z_rank1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)dhat, (const float2*)xi1, (const float2*)xi2,
      (const float*)dinv, (float2*)z, rho, K, F);
  return (int)cudaGetLastError();
}
