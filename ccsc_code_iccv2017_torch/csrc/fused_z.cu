// K2: one fused z-ADMM inner iteration of the 2D consensus learner, for
// Hopper. Two kernels, K2a (pass A) and K2b (pass B).
//
// Replaces the TPU kernel ccsc_code_iccv2017_tpu/ops/pallas_fused_z.py::
// fused_z_iter: kernel_a (pallas_call at :262) and kernel_b (pallas_call
// at :311). Per image n and filter k, on one [Sy, Sx] plane, Fx = Sx/2+1:
//
//   pass A  s = z + du, u2 = soft(s, theta), dual' = s - u2,
//           xi = 2 u2 - s, X = rDFT2(xi),
//           g = conj(d_k) b_n / rho + X,
//           t_n = sum_k d_k g_k                      (k-reduction)
//   pass B  recompute X and g,
//           zhat = g - (1/rho) conj(d_k) (minv .* t_n),
//           z' = irDFT2(zhat)
//
// The between-pass step s_n = minv .* t_n of the TPU kernel
// (pallas_fused_z.py:277-278) is folded into pass B's epilogue.
//
// Shapes (contiguous): z, du, dual', z' [N*K, Sy, Sx] in the storage type
// T (float or bf16; loads widen to f32, stores round once);
// dhat [K, Sy, Fx] and bhat [N, Sy, Fx] complex64 read interleaved as
// float2; minv [Sy, Fx] f32; t [N, Sy, Fx] complex64 (pass A's output).
// All arithmetic is f32 on the CUDA cores: the "highest" tier of the TPU
// kernel, its float-tolerance parity contract.
//
// Bound: operations. Per plane, the dense transforms cost
// 4 Sy Sx Fx (real row DFT) + 8 Sy^2 Fx (complex column DFT) flops in
// pass A and twice the forward work plus the same again inverse in pass
// B: ~8.1 and ~16.3 MFLOP at 110 x 110, against ~145 KB of state moved,
// far above the card's flop/byte balance.
//
// Design (simple and right first). The TPU kernel's layout does not
// carry over: no k in the grid (that was a Mosaic limit), no re/im
// planes (complex64 is read in place), no whole-dhat VMEM block (dhat,
// 4.9 MB at K=100, stays in L2 and each plane's slice is read once).
//   pass A: one thread block per image n loops over k in a fixed order,
//           so t_n is a deterministic sum: each thread owns the same
//           frequency bins for every k and accumulates them into t (which
//           only this block touches) in global memory — no atomics; two
//           launches on the same inputs give the same bits.
//   pass B: one thread block per (n, k) plane (no reduction).
// Each plane lives in shared memory: the real plane xi [Sy, Sx] and the
// row-transform intermediate [Sy, Fx] complex, ~99 KB at 110 x 110 (two
// blocks per SM); pass B reuses the xi buffer for zhat. The transforms
// are dense sums against one twiddle table per axis, tw[j] =
// exp(2 pi i j / S), indexed by (j * k) mod S reduced in integers (an f32
// angle 2 pi j k / S would lose digits at j k ~ 1e4); the table itself is
// evaluated in double with sincospi. Each thread computes kRows outputs
// along the transformed axis, so a loaded coefficient is reused kRows
// times. The inverse last-axis transform is Re(H W) with weight 1 for DC
// and (even Sx) the Nyquist bin, 2 for the rest, scaled 1/Sx; the
// imaginary parts of DC and Nyquist are ignored, as irfft does. Tensor
// cores (3xTF32 or bf16 splits through wgmma) and a k-split of pass A are
// left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// tw[j] = (cos(2 pi j / S), sin(2 pi j / S)), j < S
__device__ void fill_twiddles(float2* tw, int S) {
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * j / S, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
}

// s = z + du, u2 = soft(s, theta); xi = 2 u2 - s into shared memory and,
// when dual_out is given, dual' = s - u2 to global memory.
template <typename T>
__device__ void prox_plane(const T* __restrict__ z, const T* __restrict__ du,
                           float* xi, T* __restrict__ dual_out, int P,
                           float theta) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float s = load_f(z + i) + load_f(du + i);
    const float m = fmaxf(fabsf(s) - theta, 0.f);
    const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
    const float u2 = sg * m;
    if (dual_out != nullptr) store_f(dual_out + i, s - u2);
    xi[i] = 2.f * u2 - s;
  }
}

// A[y, v] = sum_x xi[y, x] exp(-2 pi i x v / Sx), v < Fx (the real
// half-spectrum transform of each row).
__device__ void rdft_rows(const float* xi, float2* A, const float2* twx,
                          int Sy, int Sx, int Fx) {
  const int groups = (Sy + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < groups * Fx; item += blockDim.x) {
    const int v = item % Fx;
    const int y0 = (item / Fx) * kRows;
    int row[kRows];
    float re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row[r] = min(y0 + r, Sy - 1) * Sx;  // rows past the edge are dropped
      re[r] = 0.f;
      im[r] = 0.f;
    }
    int idx = 0;  // (x * v) mod Sx
    for (int x = 0; x < Sx; ++x) {
      const float2 w = twx[idx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = xi[row[r] + x];
        re[r] = fmaf(a, w.x, re[r]);
        im[r] = fmaf(-a, w.y, im[r]);
      }
      idx += v;
      if (idx >= Sx) idx -= Sx;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (y0 + r < Sy) A[(y0 + r) * Fx + v] = make_float2(re[r], im[r]);
  }
}

// X[u, v] = sum_y A[y, v] exp(-2 pi i y u / Sy); epi(u, v, X) consumes
// each output bin.
template <typename Epilogue>
__device__ void dft_cols(const float2* A, const float2* twy, int Sy, int Fx,
                         Epilogue epi) {
  const int groups = (Sy + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < groups * Fx; item += blockDim.x) {
    const int v = item % Fx;
    const int u0 = (item / Fx) * kRows;
    int step[kRows], idx[kRows];
    float re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      step[r] = min(u0 + r, Sy - 1);
      idx[r] = 0;
      re[r] = 0.f;
      im[r] = 0.f;
    }
    for (int y = 0; y < Sy; ++y) {
      const float2 a = A[y * Fx + v];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 w = twy[idx[r]];  // (cos, sin); the kernel is conj
        re[r] = fmaf(a.x, w.x, fmaf(a.y, w.y, re[r]));
        im[r] = fmaf(a.y, w.x, fmaf(-a.x, w.y, im[r]));
        idx[r] += step[r];
        if (idx[r] >= Sy) idx[r] -= Sy;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (u0 + r < Sy) epi(u0 + r, v, re[r], im[r]);
  }
}

// Y[y, v] = (1/Sy) sum_u Z[u, v] exp(+2 pi i y u / Sy)
__device__ void idft_cols(const float2* Z, float2* Y, const float2* twy,
                          int Sy, int Fx) {
  const int groups = (Sy + kRows - 1) / kRows;
  const float scale = 1.f / (float)Sy;
  for (int item = threadIdx.x; item < groups * Fx; item += blockDim.x) {
    const int v = item % Fx;
    const int y0 = (item / Fx) * kRows;
    int step[kRows], idx[kRows];
    float re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      step[r] = min(y0 + r, Sy - 1);
      idx[r] = 0;
      re[r] = 0.f;
      im[r] = 0.f;
    }
    for (int u = 0; u < Sy; ++u) {
      const float2 a = Z[u * Fx + v];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 w = twy[idx[r]];
        re[r] = fmaf(a.x, w.x, fmaf(-a.y, w.y, re[r]));
        im[r] = fmaf(a.y, w.x, fmaf(a.x, w.y, im[r]));
        idx[r] += step[r];
        if (idx[r] >= Sy) idx[r] -= Sy;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (y0 + r < Sy)
        Y[(y0 + r) * Fx + v] = make_float2(re[r] * scale, im[r] * scale);
  }
}

// out[y, x] = (1/Sx) sum_v c_v Re(Y[y, v] exp(+2 pi i v x / Sx)),
// c_v = 1 for DC and (even Sx) Nyquist, 2 otherwise.
template <typename T>
__device__ void irdft_rows(const float2* Y, T* __restrict__ out,
                           const float2* twx, int Sy, int Sx, int Fx) {
  const int groups = (Sy + kRows - 1) / kRows;
  const float scale = 1.f / (float)Sx;
  for (int item = threadIdx.x; item < groups * Sx; item += blockDim.x) {
    const int x = item % Sx;  // x fastest: coalesced stores
    const int y0 = (item / Sx) * kRows;
    int row[kRows];
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row[r] = min(y0 + r, Sy - 1) * Fx;
      acc[r] = 0.f;
    }
    int idx = 0;  // (v * x) mod Sx
    for (int v = 0; v < Fx; ++v) {
      const float2 w = twx[idx];
      const float c = (v == 0 || 2 * v == Sx) ? 1.f : 2.f;
      const float wr = c * w.x, wi = c * w.y;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 a = Y[row[r] + v];
        acc[r] = fmaf(a.x, wr, fmaf(-a.y, wi, acc[r]));
      }
      idx += x;
      if (idx >= Sx) idx -= Sx;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (y0 + r < Sy) store_f(out + (y0 + r) * Sx + x, acc[r] * scale);
  }
}

// g = conj(d) b / rho + X (pallas_fused_z.py:139-143)
__device__ __forceinline__ float2 g_bin(float2 d, float2 b, float xr,
                                        float xi, float inv_rho) {
  return make_float2((d.x * b.x + d.y * b.y) * inv_rho + xr,
                     (d.x * b.y - d.y * b.x) * inv_rho + xi);
}

// shared memory: twiddles of both axes, one [Sy, Fx] complex buffer and
// one buffer that holds the real plane (pass A: Sy*Sx floats; pass B: a
// second [Sy, Fx] complex buffer, which also fits the real plane)
__host__ __device__ size_t smem_bytes(int Sy, int Sx, bool pass_b) {
  const int Fx = Sx / 2 + 1;
  const size_t tw = sizeof(float2) * (size_t)(Sx + Sy);
  const size_t cplx = sizeof(float2) * (size_t)Sy * Fx;
  const size_t real = sizeof(float) * (size_t)Sy * Sx;
  return tw + cplx + (pass_b ? cplx : real);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_z_pass_a(const T* __restrict__ z, const T* __restrict__ du,
                   const float2* __restrict__ dhat,
                   const float2* __restrict__ bhat, T* __restrict__ dual_out,
                   float2* __restrict__ t, int K, int Sy, int Sx,
                   float inv_rho, float theta) {
  extern __shared__ float4 smem[];
  const int Fx = Sx / 2 + 1;
  float2* twx = reinterpret_cast<float2*>(smem);
  float2* twy = twx + Sx;
  float2* A = twy + Sy;
  float* xi = reinterpret_cast<float*>(A + Sy * Fx);
  const int n = blockIdx.x;
  const size_t P = (size_t)Sy * Sx;
  const size_t Fp = (size_t)Sy * Fx;
  const float2* bn = bhat + n * Fp;
  float2* tn = t + n * Fp;
  fill_twiddles(twx, Sx);
  fill_twiddles(twy, Sy);
  for (int k = 0; k < K; ++k) {
    const size_t plane = ((size_t)n * K + k) * P;
    const float2* dk = dhat + k * Fp;
    __syncthreads();  // the previous plane's column pass is done with A
    prox_plane(z + plane, du + plane, xi, dual_out + plane, (int)P, theta);
    __syncthreads();
    rdft_rows(xi, A, twx, Sy, Sx, Fx);
    __syncthreads();
    // every thread owns the same bins for every k: t_n is summed in k
    // order by one thread per bin
    dft_cols(A, twy, Sy, Fx, [&](int u, int v, float xr, float xim) {
      const int f = u * Fx + v;
      const float2 d = dk[f];
      const float2 g = g_bin(d, bn[f], xr, xim, inv_rho);
      const float2 p = make_float2(d.x * g.x - d.y * g.y,
                                   d.x * g.y + d.y * g.x);
      if (k == 0) {
        tn[f] = p;
      } else {
        const float2 acc = tn[f];
        tn[f] = make_float2(acc.x + p.x, acc.y + p.y);
      }
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_z_pass_b(const T* __restrict__ z, const T* __restrict__ du,
                   const float2* __restrict__ dhat,
                   const float2* __restrict__ bhat,
                   const float2* __restrict__ t,
                   const float* __restrict__ minv, T* __restrict__ z_out,
                   int K, int Sy, int Sx, float inv_rho, float theta) {
  extern __shared__ float4 smem[];
  const int Fx = Sx / 2 + 1;
  float2* twx = reinterpret_cast<float2*>(smem);
  float2* twy = twx + Sx;
  float2* A = twy + Sy;
  float2* B = A + Sy * Fx;
  float* xi = reinterpret_cast<float*>(B);
  const size_t p = blockIdx.x;  // plane n * K + k
  const int n = (int)(p / K), k = (int)(p % K);
  const size_t P = (size_t)Sy * Sx;
  const size_t Fp = (size_t)Sy * Fx;
  const float2* dk = dhat + k * Fp;
  const float2* bn = bhat + n * Fp;
  const float2* tn = t + n * Fp;
  fill_twiddles(twx, Sx);
  fill_twiddles(twy, Sy);
  prox_plane<T>(z + p * P, du + p * P, xi, nullptr, (int)P, theta);
  __syncthreads();
  rdft_rows(xi, A, twx, Sy, Sx, Fx);
  __syncthreads();  // xi is dead: B takes zhat
  dft_cols(A, twy, Sy, Fx, [&](int u, int v, float xr, float xim) {
    const int f = u * Fx + v;
    const float2 d = dk[f];
    const float2 g = g_bin(d, bn[f], xr, xim, inv_rho);
    const float m = minv[f];
    const float2 tf = tn[f];
    const float sr = m * tf.x, si = m * tf.y;
    // zhat = g - (1/rho) conj(d) s (pallas_fused_z.py:298-299)
    B[f] = make_float2(g.x - inv_rho * (d.x * sr + d.y * si),
                       g.y - inv_rho * (d.x * si - d.y * sr));
  });
  __syncthreads();
  idft_cols(B, A, twy, Sy, Fx);
  __syncthreads();
  irdft_rows(A, z_out + p * P, twx, Sy, Sx, Fx);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_a(const void* z, const void* du, const void* dhat,
             const void* bhat, void* dual_out, void* t, int N, int K, int Sy,
             int Sx, float inv_rho, float theta, cudaStream_t stream) {
  const size_t smem = smem_bytes(Sy, Sx, false);
  if (int rc = set_smem(fused_z_pass_a<T>, smem)) return rc;
  fused_z_pass_a<T><<<N, kThreads, smem, stream>>>(
      (const T*)z, (const T*)du, (const float2*)dhat, (const float2*)bhat,
      (T*)dual_out, (float2*)t, K, Sy, Sx, inv_rho, theta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(const void* z, const void* du, const void* dhat,
             const void* bhat, const void* t, const void* minv, void* z_out,
             int N, int K, int Sy, int Sx, float inv_rho, float theta,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(Sy, Sx, true);
  if (int rc = set_smem(fused_z_pass_b<T>, smem)) return rc;
  fused_z_pass_b<T><<<(unsigned)((size_t)N * K), kThreads, smem, stream>>>(
      (const T*)z, (const T*)du, (const float2*)dhat, (const float2*)bhat,
      (const float2*)t, (const float*)minv, (T*)z_out, K, Sy, Sx, inv_rho,
      theta);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block of pass A (pass_b = 0) or pass B
// (pass_b = 1) needs for an [Sy, Sx] plane; the caller refuses planes
// above the card's per-block limit.
extern "C" size_t ccsc_fused_z_smem_bytes(int Sy, int Sx, int pass_b) {
  return smem_bytes(Sy, Sx, pass_b != 0);
}

// Launch K2a / K2b on `stream` and return the CUDA error code (0 =
// launched). `bf16` selects the storage type of z, du and the outputs
// (0: float32, 1: bfloat16). Pointers are device pointers of contiguous
// tensors; the caller checks shapes, types and sizes.
extern "C" int ccsc_fused_z_pass_a(const void* z, const void* du,
                                   const void* dhat, const void* bhat,
                                   void* dual_out, void* t, int N, int K,
                                   int Sy, int Sx, float inv_rho, float theta,
                                   int bf16, void* stream) {
  if (bf16)
    return launch_a<__nv_bfloat16>(z, du, dhat, bhat, dual_out, t, N, K, Sy,
                                   Sx, inv_rho, theta, (cudaStream_t)stream);
  return launch_a<float>(z, du, dhat, bhat, dual_out, t, N, K, Sy, Sx,
                         inv_rho, theta, (cudaStream_t)stream);
}

extern "C" int ccsc_fused_z_pass_b(const void* z, const void* du,
                                   const void* dhat, const void* bhat,
                                   const void* t, const void* minv,
                                   void* z_out, int N, int K, int Sy, int Sx,
                                   float inv_rho, float theta, int bf16,
                                   void* stream) {
  if (bf16)
    return launch_b<__nv_bfloat16>(z, du, dhat, bhat, t, minv, z_out, N, K,
                                   Sy, Sx, inv_rho, theta,
                                   (cudaStream_t)stream);
  return launch_b<float>(z, du, dhat, bhat, t, minv, z_out, N, K, Sy, Sx,
                         inv_rho, theta, (cudaStream_t)stream);
}
