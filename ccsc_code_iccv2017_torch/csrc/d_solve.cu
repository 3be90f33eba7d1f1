// The d-iteration's Woodbury solve on frequency-major code spectra, for
// Hopper. Per consensus block l and frequency f, with Z = zhat[l, f]
// (ni x K) and ginv = (rho I + Z Z^H)^{-1} (ni x ni):
//
//     r = zb + rho xi          (K x W)
//     t = Z r                  (ni x W)
//     s = ginv t               (ni x W)
//     x = (r - Z^H s) / rho    (K x W)
//
// so that x solves (rho I_K + Z^H Z) x = Z^H b + rho xi, zb = Z^H b
// (solve_conv_term_D, dParallel.m:252-276).
//
// Replaces no TPU kernel: the JAX package leaves this solve to XLA einsums
// (ccsc_code_iccv2017_tpu/ops/freq_solvers.py::solve_d). The port ran the
// same three einsums on cuBLAS, which on every call materialised the code
// spectra's conjugate and a copy permuted from their k-major layout
// [L, ni, K, F] into batches over F, then ran batched GEMVs.
//
// What bounds it: bytes. A block-frequency needs its code matrix and its
// inverse, each read once (of the Hermitian inverse, one triangle), and
// a few vectors: 8 (ni K + ni (ni + 1) / 2) + 24 K W bytes for about
// 8 W (2 ni K + ni^2) real multiply-adds, about one flop a byte. At the
// north star (8 blocks x 6160 frequencies, ni = K = 100, W = 1) that is
// 6.05 GB a call, 1.81 ms at 3.35 TB/s (7.88 GB and 2.35 ms reading
// the whole inverse).
//
// How the design meets it: one block per (l, f). The caller keeps the
// code spectra frequency-major ([L, F, ni, K], transposed once a step),
// so the block's Z is one contiguous run, copied whole into shared
// memory by cp.async (16 bytes a thread where aligned) while the block
// forms r. t is summed from shared memory. ginv streams from device
// memory once, a warp R rows at a time, its lanes on neighbouring
// columns, every load of a round in flight before any is used, as
// evict-first loads (nothing reads them again); for W = 1 only its lower
// triangle: row n's entries left of the diagonal also give column n's
// above it, conj(G[n][m]) t[n] into s[m], each lane summing the columns
// it owns over the warp's rows. x is summed from shared memory again.
// Two blocks share an SM (~89 KB of shared memory each at the north
// star), so one block's copy overlaps the other's sums. zb, xi and x
// keep the callers' k-major [L, K, W, F] layout: a block's K W values lie
// F apart, but the blocks resident together are neighbouring
// frequencies, whose accesses share L2 sectors.
//
// W runs in tiles of WT columns (1, 2, 4 or 8, a template), each thread
// keeping WT sums in registers; past 8 the tiles loop, and ginv is read
// whole once a tile (after the first from L2).
//
// Arithmetic: FP32 multiply-adds on complex64 throughout (no TF32, no
// tensor cores). Every sum runs in a fixed order with no atomics (across
// a warp by xor shuffles, a lane's columns over its warp's rows, the
// warps' column sums and the parts of Z^H s in shared memory in order),
// so two launches on the same input give the same bits.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // the H100's per-block opt-in limit
constexpr int kMaxParts = 8;         // threads that split one x sum
constexpr int kUnroll = 4;           // 32-column chunks of a row in flight

__host__ __device__ inline int wtile(int W) {
  return W <= 1 ? 1 : W <= 2 ? 2 : W <= 4 ? 4 : 8;
}

// Rows of Z or ginv a warp sums at once: more loads in flight and
// interleaved warp sums, within 128 registers a thread at 8 columns.
__host__ __device__ constexpr int rows_at_once(int WT) {
  return WT <= 2 ? 4 : 2;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The parts buffer, in complex: the parts of x [kThreads][WT], and for
// W = 1 also the warps' column sums of s [kWarps][ni32].
__host__ __device__ inline size_t parts(int ni, int wt) {
  const size_t x = (size_t)kThreads * wt, c = (size_t)kWarps * round_up(ni, 32);
  return wt == 1 && c > x ? c : x;
}

// One block's shared memory in bytes: Z [ni][K], r [wp][K], t [wp][ni32]
// (rows past ni zero), s [wp][ni] and the parts, with wp = W rounded up
// to whole tiles and ni32 = ni rounded up to a warp.
__host__ __device__ inline size_t smem_bytes(int ni, int K, int W) {
  const int wt = wtile(W);
  const size_t wp = round_up(W, wt);
  return 8 * ((size_t)ni * K + wp * K + wp * round_up(ni, 32) + wp * ni +
              parts(ni, wt));
}

__device__ inline void cmac(float2& acc, float2 a, float2 b) {  // += a b
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ inline void cmac_conj(float2& acc, float2 a, float2 b) {
  // += conj(a) b
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}

// The warp's sum, the same bits in every lane.
__device__ inline float2 warp_sum(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// x[k, w0 .. w0 + WT) = (r - sums) / rho, the columns past W left out.
template <int WT>
__device__ inline void store_x(float2* __restrict__ out, const float2* rs,
                               const float2* acc, size_t base, int k, int w0,
                               int K, int W, int F, size_t f, float rho) {
#pragma unroll
  for (int j = 0; j < WT; ++j) {
    const int w = w0 + j;
    if (w >= W) break;
    const float2 r = rs[w * K + k];
    out[(base + (size_t)k * W + w) * F + f] =
        make_float2((r.x - acc[j].x) / rho, (r.y - acc[j].y) / rho);
  }
}

template <int WT, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    d_solve_kernel(const float2* __restrict__ zt,
                   const float2* __restrict__ ginv,
                   const float2* __restrict__ zb,
                   const float2* __restrict__ xi, float2* __restrict__ out,
                   int F, int ni, int K, int W, float rho) {
  extern __shared__ float4 smem4[];
  constexpr int R = rows_at_once(WT);
  const int wp = round_up(W, WT), ntile = wp / WT, ni32 = round_up(ni, 32);
  const int nrg = (ni + R - 1) / R;  // groups of R rows
  float2* zs = reinterpret_cast<float2*>(smem4);
  float2* rs = zs + (size_t)ni * K;
  float2* ts = rs + (size_t)wp * K;
  float2* ss = ts + (size_t)wp * ni32;
  float2* ps = ss + (size_t)wp * ni;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = blockIdx.x;  // l F + f
  const size_t l = blk / F, f = blk - l * F;
  const size_t base = l * K * W;  // [L, K, W, F]: (base + k W + w) F + f
  const float2 zero = make_float2(0.f, 0.f);

  // Z[l, f] into shared memory, in flight while r is formed
  {
    const float2* src = zt + blk * ni * K;
    const int n = ni * K;
    if (kVec16) {
      for (int e = 2 * tid; e < n; e += 2 * kThreads)
        cp_async16(zs + e, src + e);
    } else {
      for (int e = tid; e < n; e += kThreads) cp_async8(zs + e, src + e);
    }
  }
  // r = zb + rho xi (tile columns past W zero), t's rows past ni zero
  for (int e = tid; e < wp * K; e += kThreads) {
    const int w = e / K, k = e - w * K;
    float2 v = zero;
    if (w < W) {
      const size_t g = (base + (size_t)k * W + w) * F + f;
      const float2 a = zb[g], b = xi[g];
      v = make_float2(__fadd_rn(a.x, __fmul_rn(rho, b.x)),
                      __fadd_rn(a.y, __fmul_rn(rho, b.y)));
    }
    rs[e] = v;
  }
  for (int e = tid; e < wp * (ni32 - ni); e += kThreads) {
    const int w = e / (ni32 - ni);
    ts[w * ni32 + ni + (e - w * (ni32 - ni))] = zero;
  }
  cp_async_wait_all();
  __syncthreads();

  // t = Z r: a warp per R rows and a tile, its lanes over k; the R rows'
  // warp sums interleave
  for (int task = warp; task < nrg * ntile; task += kWarps) {
    const int n0 = task / ntile * R, w0 = (task - task / ntile * ntile) * WT;
    float2 acc[R][WT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < WT; ++j) acc[i][j] = zero;
    for (int k = lane; k < K; k += 32) {
      float2 rv[WT];
#pragma unroll
      for (int j = 0; j < WT; ++j) rv[j] = rs[(w0 + j) * K + k];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (n0 + i >= ni) break;  // the same in every lane
        const float2 z = zs[(size_t)(n0 + i) * K + k];
#pragma unroll
        for (int j = 0; j < WT; ++j) cmac(acc[i][j], z, rv[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < WT; ++j) acc[i][j] = warp_sum(acc[i][j]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < WT; ++j)
          if (n0 + i < ni) ts[(w0 + j) * ni32 + n0 + i] = acc[i][j];
    }
  }
  __syncthreads();

  const float2* gm = ginv + blk * ni * ni;
  if constexpr (WT == 1) {
    // s = ginv t from ginv's lower triangle (ginv is Hermitian): row n's
    // entries m <= n add G[n][m] t[m] to s[n], a warp sum, and those
    // left of the diagonal add conj(G[n][m]) t[n] to s[m], summed by the
    // lane that owns column m over the warp's rows into the warp's row
    // of column sums; then s is the row sums plus the warps' column
    // sums in warp order. A warp takes R rows at once, every load of a
    // round issued before any is used.
    float2* cw = ps + (size_t)warp * ni32;
    for (int m = lane; m < ni32; m += 32) cw[m] = zero;
    for (int n0 = R * warp; n0 < ni; n0 += R * kWarps) {
      const int last = min(n0 + R, ni) - 1;
      float2 acc[R], tn[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = zero;
        tn[i] = n0 + i < ni ? ts[n0 + i] : zero;
      }
      for (int m0 = 0; m0 <= last; m0 += 32 * kUnroll) {
        float2 v[R][kUnroll];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int m = m0 + 32 * u + lane;
            v[i][u] = m <= n0 + i && n0 + i < ni
                          ? __ldcs(gm + (size_t)(n0 + i) * ni + m)
                          : zero;
          }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (m0 + 32 * u > last) break;  // the same in every lane
          const int m = m0 + 32 * u + lane;
          const float2 tv = ts[m];
          float2 col = cw[m];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            cmac(acc[i], v[i][u], tv);
            if (m < n0 + i) cmac_conj(col, v[i][u], tn[i]);
          }
          cw[m] = col;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = warp_sum(acc[i]);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (n0 + i < ni) ss[n0 + i] = acc[i];
      }
    }
    __syncthreads();
    for (int m = tid; m < ni; m += kThreads) {
      float2 a = ss[m];
      for (int w = 0; w < kWarps; ++w) {
        a.x += ps[(size_t)w * ni32 + m].x;
        a.y += ps[(size_t)w * ni32 + m].y;
      }
      ss[m] = a;
    }
    __syncthreads();
  } else {
    // s = ginv t: a warp per R rows, its lanes over the columns, every load
    // of a round of R rows issued before any is used
    for (int w0 = 0; w0 < wp; w0 += WT) {
      for (int n0 = R * warp; n0 < ni; n0 += R * kWarps) {
        float2 acc[R][WT];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < WT; ++j) acc[i][j] = zero;
        for (int m0 = 0; m0 < ni; m0 += 32 * kUnroll) {
          float2 v[R][kUnroll];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int m = m0 + 32 * u + lane;
              v[i][u] = n0 + i < ni && m < ni
                            ? __ldcs(gm + (size_t)(n0 + i) * ni + m)
                            : zero;
            }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (m0 + 32 * u >= ni) break;  // the same in every lane
            const int m = m0 + 32 * u + lane;
#pragma unroll
            for (int j = 0; j < WT; ++j) {
              const float2 tv = ts[(w0 + j) * ni32 + m];
#pragma unroll
              for (int i = 0; i < R; ++i) cmac(acc[i][j], v[i][u], tv);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < WT; ++j) acc[i][j] = warp_sum(acc[i][j]);
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < WT; ++j)
              if (n0 + i < ni) ss[(w0 + j) * ni + n0 + i] = acc[i][j];
        }
      }
    }
    __syncthreads();
  }

  // x = (r - Z^H s) / rho: a thread per (k, tile); where that leaves
  // threads idle, P of them split the n-sum and the parts are added in
  // order after a barrier
  const int items = K * ntile;
  const int P = min(kMaxParts, max(1, kThreads / items));
  for (int task = tid; task < items * P; task += kThreads) {
    const int part = task / items, item = task - part * items;
    const int w0 = item / K * WT, k = item - item / K * K;
    const int lo = part * ni / P, hi = (part + 1) * ni / P;
    float2 acc[WT];
#pragma unroll
    for (int j = 0; j < WT; ++j) acc[j] = zero;
    for (int n = lo; n < hi; ++n) {
      const float2 z = zs[(size_t)n * K + k];
#pragma unroll
      for (int j = 0; j < WT; ++j) cmac_conj(acc[j], z, ss[(w0 + j) * ni + n]);
    }
    if (P == 1) {
      store_x<WT>(out, rs, acc, base, k, w0, K, W, F, f, rho);
    } else {
#pragma unroll
      for (int j = 0; j < WT; ++j) ps[(size_t)task * WT + j] = acc[j];
    }
  }
  if (P == 1) return;
  __syncthreads();
  if (tid < items) {  // P > 1: items * P <= kThreads
    float2 acc[WT];
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      acc[j] = ps[(size_t)tid * WT + j];
      for (int p = 1; p < P; ++p) {
        const float2 q = ps[((size_t)p * items + tid) * WT + j];
        acc[j].x += q.x;
        acc[j].y += q.y;
      }
    }
    store_x<WT>(out, rs, acc, base, tid - tid / K * K, tid / K * WT, K, W, F,
                f, rho);
  }
}

template <int WT, bool kVec16>
int launch(unsigned grid, size_t smem, cudaStream_t stream, const void* zt,
           const void* ginv, const void* zb, const void* xi, void* out,
           int F, int ni, int K, int W, float rho) {
  auto kernel = d_solve_kernel<WT, kVec16>;
  if (int rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return rc;
  // all of the SM's L1 as shared memory: two blocks of the north star
  if (int rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared))
    return rc;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float2*)zt, (const float2*)ginv, (const float2*)zb,
      (const float2*)xi, (float2*)out, F, ni, K, W, rho);
  return (int)cudaGetLastError();
}

template <int WT>
int launch_wt(bool vec16, unsigned grid, size_t smem, cudaStream_t stream,
              const void* zt, const void* ginv, const void* zb,
              const void* xi, void* out, int F, int ni, int K, int W,
              float rho) {
  return vec16 ? launch<WT, true>(grid, smem, stream, zt, ginv, zb, xi, out,
                                  F, ni, K, W, rho)
               : launch<WT, false>(grid, smem, stream, zt, ginv, zb, xi,
                                   out, F, ni, K, W, rho);
}

}  // namespace

// Shared memory one block takes for (ni, K, W); the wrapper's fits() is
// its twin.
extern "C" size_t ccsc_d_solve_smem_bytes(int ni, int K, int W) {
  return smem_bytes(ni, K, W);
}

// Launch on `stream` and return the CUDA error code (0 = launched).
// zt [batch, F, ni, K], ginv [batch, F, ni, ni], zb and xi [batch, K, W, F]
// complex64, contiguous device memory; out [batch, K, W, F] is written.
// Refuses what the kernel was not built for.
extern "C" int ccsc_d_solve(const void* zt, const void* ginv, const void* zb,
                            const void* xi, void* out, int batch, int F,
                            int ni, int K, int W, float rho, void* stream) {
  if (batch < 1 || F < 1 || ni < 1 || K < 1 || W < 1 ||
      (long long)batch * F > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ni, K, W);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec16 = ni * K % 2 == 0 && ((uintptr_t)zt & 15) == 0;
  const unsigned grid = (unsigned)(batch * F);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (wtile(W)) {
    case 1:
      return launch_wt<1>(vec16, grid, smem, s, zt, ginv, zb, xi, out, F,
                          ni, K, W, rho);
    case 2:
      return launch_wt<2>(vec16, grid, smem, s, zt, ginv, zb, xi, out, F,
                          ni, K, W, rho);
    case 4:
      return launch_wt<4>(vec16, grid, smem, s, zt, ginv, zb, xi, out, F,
                          ni, K, W, rho);
    default:
      return launch_wt<8>(vec16, grid, smem, s, zt, ginv, zb, xi, out, F,
                          ni, K, W, rho);
  }
}
