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
// Layout. The TPU kernel's layout does not carry over: no k in the grid
// (that was a Mosaic limit), no re/im planes (complex64 is read in
// place), no whole-dhat VMEM block (dhat, 4.9 MB at K=100, stays in L2
// and each plane's slice is read once).
//   pass A: one thread block per image n loops over k in a fixed order,
//           so t_n is a deterministic sum: each thread owns the same
//           frequency bins for every k and accumulates them into t (which
//           only this block touches) in global memory — no atomics; two
//           launches on the same inputs give the same bits.
//   pass B: one thread block per (n, k) plane (no reduction).
// Each plane lives in shared memory in two buffers: R, the packed rows
// (below), and A, the half spectrum [Sy, Fx] complex; pass B computes
// zhat in A and runs both inverse transforms in place. ~101 KB at
// 110 x 110: two blocks per SM.
//
// Transforms: one P x Q split per axis, in place. For an axis of length
// S the host picks P, the largest divisor of S with P <= sqrt(S), and
// Q = S / P (110 = 10 x 11, 12 = 3 x 4, 9 = 3 x 3) and passes both to
// the kernels. With n = n1 + P n2 and k = Q k1 + k2 (n1, k1 < P;
// n2, k2 < Q),
//   X[Q k1 + k2] = sum_n1 W_P^{n1 k1} W_S^{n1 k2}
//                  sum_n2 x[n1 + P n2] W_Q^{n2 k2}.
// Forward: stage 1 takes, for each n1, a Q-point DFT of the elements
// n1 + P n2, multiplies output k2 by W_S^{n1 k2} and stores it back at
// n1 + P k2; stage 2 takes, for each k2, a P-point DFT of the
// contiguous elements n1 + P k2 and stores output k1 at k1 + P k2. So
// bin k ends at element k / Q + P (k mod Q), a permuted order that the
// epilogues read through that map and the inverse consumes as it is:
// stage 1' takes, for each k2, a P-point inverse DFT of the contiguous
// block times W_S^{-n1 k2}; stage 2' takes, for each n1, a Q-point
// inverse DFT over stride P; y[n] lands at element n. Cost per complex
// line: S (P + Q) complex multiply-adds, against S^2 dense, and the
// sub-DFTs halve that again (below).
// Each thread runs one sub-DFT: it loads L = P or Q values into
// registers, multiplies them by the L x L DFT matrix (a template on
// L <= 16, fully unrolled, reached through a switch; the matrix's cos/sin
// symmetry pairs outputs m and L - m, so about L^2 / 2 real-by-complex
// products instead of L^2 complex ones), applies the inter-stage
// twiddle and stores back to the same elements. The lanes
// of a warp run along the untransformed axis (other rows for a row
// stage, other columns for a column stage), so every lane reads the same
// DFT-matrix entry (a broadcast); the pitches of R and A are odd in
// 8-byte words, so strided rows hit distinct banks.
// Real rows, two for one: the prox step writes xi of row 2j into the
// real part and row 2j+1 into the imaginary part of packed row j (zero
// for an odd Sy's last row); after the complex row DFT Z,
//   X_2j[v] = (Z[v] + conj(Z[-v])) / 2,
//   X_2j+1[v] = (Z[v] - conj(Z[-v])) / 2i,
// read through the position map into A in natural (y, v) order. The
// inverse packs Y_2j + i Y_2j+1 over the Hermitian extension
// Y[Sx - v] = conj(Y[v]), with the imaginary parts of DC and (even Sx)
// Nyquist dropped first, as irfft does; its real and imaginary parts are
// rows 2j and 2j+1. Scales: 1/Sy in the column inverse, 1/Sx on store.
// An axis with no split whose factors are both <= 16 (a prime length,
// or 2 p with p > 16) keeps the dense routines (rdft_rows, dft_cols,
// idft_cols, irdft_rows): sums against the same table, each thread
// computing kRows outputs along the transformed axis.
// Twiddles: one table per axis, tw[j] = exp(2 pi i j / S) evaluated in
// double with sincospi; W_L^j = tw[j S / L] and W_S^{n1 k2} =
// tw[n1 k2] (n1 k2 < S), all integer-indexed. The position maps of the
// split axes sit in small int tables, and the per-item loops step
// (row, column) without dividing (Walk): integer division per item cost
// as many instruction slots as a transform stage.
//
// Bound: bytes, the state planes read and written (3.49 ms per pass at
// the learner's launch shape, N*K = 800*100 planes of 110 x 110 f32).
// The split's FP32 operations come to ~0.86 MFLOP per plane in pass A
// and ~1.5 in pass B at 110 x 110, so what the card spends beyond the
// bytes is memory latency: the prox step and the split path's
// epilogues start the global loads of kBatch items before using any.
// Tensor cores and a k-split of pass A are left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kMaxFactor = 16;  // longest sub-DFT of a split
// items whose global loads one thread starts together before using any
// (prox and the split path's epilogues: latency-bound otherwise)
constexpr int kBatch = 4;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// An axis S = P * Q split in two stages; P = 1 takes the dense routines.
struct Split {
  int P, Q;
};

// P is the largest divisor of S with P <= sqrt(S); an axis whose Q would
// exceed kMaxFactor (a prime S, or 2 p with p > 16) stays dense.
__host__ __device__ inline Split plan_axis(int S) {
  int P = 1;
  for (int p = 2; p * p <= S; ++p)
    if (S % p == 0) P = p;
  if (P == 1 || S / P > kMaxFactor) return Split{1, S};
  return Split{P, S / P};
}

// an odd pitch (in float2, 8-byte words) of at least n
__host__ __device__ inline int odd_pitch(int n) { return n | 1; }

// element of bin k after a forward split transform
__device__ __forceinline__ int split_pos(int k, Split sp) {
  return k / sp.Q + sp.P * (k % sp.Q);
}

// bin held by element e after a forward split transform
__device__ __forceinline__ int split_bin(int e, Split sp) {
  return sp.Q * (e % sp.P) + e / sp.P;
}

// The items i = threadIdx.x + r blockDim.x of a [rows, C] array as
// (row, col) = (i / C, i % C), stepped without a division per item.
struct Walk {
  int r, c, dr, dc;
  __device__ explicit Walk(int C)
      : r(threadIdx.x / C), c(threadIdx.x % C), dr(blockDim.x / C),
        dc(blockDim.x % C) {}
  __device__ void next(int C) {
    r += dr;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
};

// tw[j] = (cos(2 pi j / S), sin(2 pi j / S)), j < S
__device__ void fill_twiddles(float2* tw, int S) {
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * j / S, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
}

// posx[k] = split_pos(k) of the row axis, biny[e] = split_bin(e) of the
// column axis (read only when that axis splits)
__device__ void fill_maps(int* posx, int* biny, int Sx, int Sy, Split sx,
                          Split sy) {
  for (int k = threadIdx.x; k < Sx; k += blockDim.x)
    posx[k] = sx.P > 1 ? split_pos(k, sx) : k;
  for (int e = threadIdx.x; e < Sy; e += blockDim.x)
    biny[e] = sy.P > 1 ? split_bin(e, sy) : e;
}

// u2 = soft(s, theta); dual' = s - u2 to *dual when given; returns
// xi = 2 u2 - s.
template <typename T>
__device__ __forceinline__ float prox_one(float s, float theta, T* dual) {
  const float m = fmaxf(fabsf(s) - theta, 0.f);
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  const float u2 = sg * m;
  if (dual != nullptr) store_f(dual, s - u2);
  return 2.f * u2 - s;
}

// s = z + du; xi into the real plane xi [Sy, Sx] in shared memory and,
// when dual_out is given, dual' to global memory (dense row transform).
template <typename T>
__device__ void prox_plane(const T* __restrict__ z, const T* __restrict__ du,
                           float* xi, T* __restrict__ dual_out, int P,
                           float theta) {
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    xi[i] = prox_one(load_f(z + i) + load_f(du + i), theta,
                     dual_out != nullptr ? dual_out + i : nullptr);
}

// The same, two rows for one: xi of rows 2j and 2j+1 into the real and
// imaginary parts of packed row j of R (pitch pR); an odd Sy's last
// packed row gets a zero imaginary part.
template <typename T>
__device__ void prox_rows(const T* __restrict__ z, const T* __restrict__ du,
                          float2* R, int pR, T* __restrict__ dual_out, int Sy,
                          int Sx, float theta) {
  const int J = (Sy + 1) / 2;
  for (Walk w(Sx); w.r < J;) {
    float s0[kBatch], s1[kBatch];
    Walk it = w;
#pragma unroll
    for (int b = 0; b < kBatch; ++b, it.next(Sx)) {  // all loads first
      const bool in = it.r < J;  // past the end: load the last item
      const int o = 2 * (in ? it.r : J - 1) * Sx + (in ? it.c : Sx - 1);
      const int o1 = o + Sx < Sy * Sx ? o + Sx : o;
      s0[b] = load_f(z + o) + load_f(du + o);
      s1[b] = load_f(z + o1) + load_f(du + o1);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b, w.next(Sx)) {
      if (w.r >= J) break;
      const int j = w.r, x = w.c, o = 2 * j * Sx + x;
      const float xi0 = prox_one(s0[b], theta,
                                 dual_out != nullptr ? dual_out + o : nullptr);
      float xi1 = 0.f;
      if (2 * j + 1 < Sy)
        xi1 = prox_one(s1[b], theta,
                       dual_out != nullptr ? dual_out + o + Sx : nullptr);
      R[j * pR + x] = make_float2(xi0, xi1);
    }
  }
}

// One L-point DFT, in place, of the L complex values at p[0], p[s], ...,
// p[(L-1) s]: out[m] = sum_n in[n] W^{nm}, W = exp(+2 pi i / L)
// (inverse) or its conjugate (forward); w[j] = exp(2 pi i j / L). The
// matrix's symmetry halves the work: with a_n = in[n] + in[L-n] and
// b_n = in[n] - in[L-n] (n <= H), C_m = in[0] + sum_n a_n cos(2 pi nm/L)
// and S_m = sum_n b_n sin(2 pi nm/L) give out[m] and out[L-m] as
// C_m -+ i S_m (forward; +- inverse); an even L adds in[L/2] (-1)^m to
// every C_m. When tstep > 0, output m is then multiplied by the
// inter-stage twiddle tw[m * tstep] (conjugated forward). Every output is
// scaled by `scale`.
template <int L, bool kInv>
__device__ __forceinline__ void sub_dft(float2* p, int s, const float2 (&w)[L],
                                        const float2* tw, int tstep,
                                        float scale) {
  constexpr int H = (L - 1) / 2;  // the pairs (n, L - n)
  float2 x[L];
#pragma unroll
  for (int n = 0; n < L; ++n) x[n] = p[n * s];
#pragma unroll
  for (int n = 1; n <= H; ++n) {  // a_n into x[n], b_n into x[L - n]
    const float2 u = x[n], v = x[L - n];
    x[n] = make_float2(u.x + v.x, u.y + v.y);
    x[L - n] = make_float2(u.x - v.x, u.y - v.y);
  }
  auto emit = [&](int m, float re, float im) {
    if (tstep > 0) {
      const float2 t = tw[m * tstep];
      const float c = t.x, sn = kInv ? t.y : -t.y;
      const float r = fmaf(re, c, -im * sn);
      im = fmaf(im, c, re * sn);
      re = r;
    }
    p[m * s] = make_float2(re * scale, im * scale);
  };
#pragma unroll
  for (int m = 0; m <= L / 2; ++m) {  // m = 0, the pairs, L/2 for even L
    float cr = x[0].x, ci = x[0].y, sr = 0.f, si = 0.f;
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      const int j = (n * m) % L;  // a constant once unrolled
      if (j == 0) {  // cos 1, sin 0
        cr += x[n].x;
        ci += x[n].y;
      } else if (2 * j == L) {  // cos -1, sin 0
        cr -= x[n].x;
        ci -= x[n].y;
      } else {
        cr = fmaf(x[n].x, w[j].x, cr);
        ci = fmaf(x[n].y, w[j].x, ci);
        sr = fmaf(x[L - n].x, w[j].y, sr);
        si = fmaf(x[L - n].y, w[j].y, si);
      }
    }
    if (L % 2 == 0) {  // the unpaired in[L/2], times (-1)^m
      cr += m % 2 ? -x[L / 2].x : x[L / 2].x;
      ci += m % 2 ? -x[L / 2].y : x[L / 2].y;
    }
    if (m == 0 || 2 * m == L) {  // S_m = 0
      emit(m, cr, ci);
    } else if (kInv) {  // C + i S, C - i S
      emit(m, cr - si, ci + sr);
      emit(L - m, cr + si, ci - sr);
    } else {  // C - i S, C + i S
      emit(m, cr + si, ci - sr);
      emit(L - m, cr - si, ci + sr);
    }
  }
}

// One stage of a split transform over `lines` lines (line l starts at
// buf + l * ls): item (sub, l) runs one L-point sub-DFT on the elements
// at sub * sub_step + j * es, j < L. Consecutive lanes take consecutive
// lines. wstride = S / L indexes the axis table tw; `twiddle` applies
// W_S^{m * sub} to output m.
template <int L, bool kInv>
__device__ void stage_loop(float2* buf, int lines, int ls, int subs,
                           int sub_step, int es, const float2* tw,
                           int wstride, bool twiddle, float scale) {
  float2 w[L];
#pragma unroll
  for (int j = 0; j < L; ++j) w[j] = tw[j * wstride];  // a broadcast
  for (int item = threadIdx.x; item < subs * lines; item += blockDim.x) {
    const int sub = item / lines, l = item - sub * lines;
    sub_dft<L, kInv>(buf + l * ls + sub * sub_step, es, w, tw,
                     twiddle ? sub : 0, scale);
  }
}

template <bool kInv>
__device__ void stage(int L, float2* buf, int lines, int ls, int subs,
                      int sub_step, int es, const float2* tw, int wstride,
                      bool twiddle, float scale) {
  switch (L) {
#define CCSC_STAGE(n)                                                     \
  case n:                                                                 \
    stage_loop<n, kInv>(buf, lines, ls, subs, sub_step, es, tw, wstride, \
                        twiddle, scale);                                  \
    break;
    CCSC_STAGE(2)
    CCSC_STAGE(3)
    CCSC_STAGE(4)
    CCSC_STAGE(5)
    CCSC_STAGE(6)
    CCSC_STAGE(7)
    CCSC_STAGE(8)
    CCSC_STAGE(9)
    CCSC_STAGE(10)
    CCSC_STAGE(11)
    CCSC_STAGE(12)
    CCSC_STAGE(13)
    CCSC_STAGE(14)
    CCSC_STAGE(15)
    CCSC_STAGE(16)
#undef CCSC_STAGE
    default:
      break;  // plan_axis never gives a factor outside 2..kMaxFactor
  }
}

// Forward split DFT, in place, of `lines` lines of length S = P Q
// (element stride es, line stride ls): natural order in, bin k out at
// element split_pos(k).
__device__ void split_forward(float2* buf, int lines, int ls, int es,
                              Split sp, const float2* tw) {
  // stage 1: per n1 a Q-point DFT over n1 + P n2, times W_S^{n1 k2}
  stage<false>(sp.Q, buf, lines, ls, sp.P, es, sp.P * es, tw, sp.P, true,
               1.f);
  __syncthreads();
  // stage 2: per k2 a P-point DFT over the contiguous n1 + P k2
  stage<false>(sp.P, buf, lines, ls, sp.Q, sp.P * es, es, tw, sp.Q, false,
               1.f);
}

// Inverse split DFT, in place: bin k in at element split_pos(k), natural
// order out, times `scale`.
__device__ void split_inverse(float2* buf, int lines, int ls, int es,
                              Split sp, const float2* tw, float scale) {
  // stage 1': per k2 a P-point inverse DFT over the contiguous block,
  // times W_S^{-n1 k2}
  stage<true>(sp.P, buf, lines, ls, sp.Q, sp.P * es, es, tw, sp.Q, true,
              1.f);
  __syncthreads();
  // stage 2': per n1 a Q-point inverse DFT over stride P
  stage<true>(sp.Q, buf, lines, ls, sp.P, es, sp.P * es, tw, sp.P, false,
              scale);
}

// Two real rows from one complex row: packed row j of R after its
// forward split DFT (bin k at element posx[k]) gives the half spectra of
// rows 2j and 2j+1 in A [Sy, pA], v < Fx, natural order.
__device__ void unpack_rows(const float2* R, int pR, float2* A, int pA,
                            int Sy, int Sx, int Fx, const int* posx) {
  const int J = (Sy + 1) / 2;
  for (Walk w(Fx); w.r < J; w.next(Fx)) {
    const int j = w.r, v = w.c;
    const float2 a = R[j * pR + posx[v]];
    const float2 b = R[j * pR + posx[v == 0 ? 0 : Sx - v]];
    // X_2j = (a + conj(b)) / 2, X_2j+1 = (a - conj(b)) / 2i
    A[2 * j * pA + v] = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    if (2 * j + 1 < Sy)
      A[(2 * j + 1) * pA + v] =
          make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
  }
}

// The inverse pairing: rows 2j and 2j+1 of A (natural order) extended to
// Hermitian spectra of length Sx, the imaginary parts of DC and (even
// Sx) Nyquist dropped as irfft does, packed as Y_2j + i Y_2j+1 into row
// j of R, bin k at element posx[k].
__device__ void pack_rows(const float2* A, int pA, float2* R, int pR, int Sy,
                          int Sx, int Fx, const int* posx) {
  const int J = (Sy + 1) / 2;
  for (Walk w(Sx); w.r < J; w.next(Sx)) {
    const int j = w.r, k = w.c;
    const bool mirror = k >= Fx;
    const int v = mirror ? Sx - k : k;
    float2 ya = A[2 * j * pA + v];
    float2 yb = 2 * j + 1 < Sy ? A[(2 * j + 1) * pA + v] : make_float2(0.f, 0.f);
    if (v == 0 || 2 * v == Sx) {
      ya.y = 0.f;
      yb.y = 0.f;
    } else if (mirror) {
      ya.y = -ya.y;
      yb.y = -yb.y;
    }
    R[j * pR + posx[k]] = make_float2(ya.x - yb.y, ya.y + yb.x);
  }
}

// Rows 2j and 2j+1 of the output from the real and imaginary parts of
// packed row j (natural order), times `scale`.
template <typename T>
__device__ void store_rows(const float2* R, int pR, T* __restrict__ out,
                           int Sy, int Sx, float scale) {
  const int J = (Sy + 1) / 2;
  for (Walk w(Sx); w.r < J; w.next(Sx)) {
    const int j = w.r, x = w.c;
    const float2 c = R[j * pR + x];
    store_f(out + 2 * j * Sx + x, c.x * scale);
    if (2 * j + 1 < Sy) store_f(out + (2 * j + 1) * Sx + x, c.y * scale);
  }
}

// Dense: A[y, v] = sum_x xi[y, x] exp(-2 pi i x v / Sx), v < Fx (the
// real half-spectrum transform of each row), A of pitch pA.
__device__ void rdft_rows(const float* xi, float2* A, int pA,
                          const float2* twx, int Sy, int Sx, int Fx) {
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
      if (y0 + r < Sy) A[(y0 + r) * pA + v] = make_float2(re[r], im[r]);
  }
}

// Dense: X[u, v] = sum_y A[y, v] exp(-2 pi i y u / Sy); epi(u, v, X)
// consumes each output bin.
template <typename Epilogue>
__device__ void dft_cols(const float2* A, int pA, const float2* twy, int Sy,
                         int Fx, Epilogue epi) {
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
      const float2 a = A[y * pA + v];
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

// Dense: Y[y, v] = (1/Sy) sum_u Z[u, v] exp(+2 pi i y u / Sy)
__device__ void idft_cols(const float2* Z, float2* Y, int pA,
                          const float2* twy, int Sy, int Fx) {
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
      const float2 a = Z[u * pA + v];
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
        Y[(y0 + r) * pA + v] = make_float2(re[r] * scale, im[r] * scale);
  }
}

// Dense: out[y, x] = (1/Sx) sum_v c_v Re(Y[y, v] exp(+2 pi i v x / Sx)),
// c_v = 1 for DC and (even Sx) Nyquist, 2 otherwise.
template <typename T>
__device__ void irdft_rows(const float2* Y, int pA, T* __restrict__ out,
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
      row[r] = min(y0 + r, Sy - 1) * pA;
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

// The prox step of one plane and the forward transform of its rows: the
// half spectra [Sy, Fx] land in A (pitch pA) in natural order, complete
// after the caller's next __syncthreads. R is scratch.
template <typename T>
__device__ void forward_rows(const T* z, const T* du, T* dual_out, float2* R,
                             float2* A, const float2* twx, const int* posx,
                             int Sy, int Sx, Split sx, float theta) {
  const int Fx = Sx / 2 + 1, pA = odd_pitch(Fx);
  if (sx.P > 1) {
    const int pR = odd_pitch(Sx);
    prox_rows(z, du, R, pR, dual_out, Sy, Sx, theta);
    __syncthreads();
    split_forward(R, (Sy + 1) / 2, pR, 1, sx, twx);
    __syncthreads();
    unpack_rows(R, pR, A, pA, Sy, Sx, Fx, posx);
  } else {
    float* xi = reinterpret_cast<float*>(R);
    prox_plane(z, du, xi, dual_out, Sy * Sx, theta);
    __syncthreads();
    rdft_rows(xi, A, pA, twx, Sy, Sx, Fx);
  }
}

// g = conj(d) b / rho + X (pallas_fused_z.py:139-143)
__device__ __forceinline__ float2 g_bin(float2 d, float2 b, float xr,
                                        float xi, float inv_rho) {
  return make_float2((d.x * b.x + d.y * b.y) * inv_rho + xr,
                     (d.x * b.y - d.y * b.x) * inv_rho + xi);
}

// one term d_k g_k of t_n
__device__ __forceinline__ float2 t_term(float2 d, float2 b, float2 X,
                                         float inv_rho) {
  const float2 g = g_bin(d, b, X.x, X.y, inv_rho);
  return make_float2(d.x * g.x - d.y * g.y, d.x * g.y + d.y * g.x);
}

// zhat = g - (1/rho) conj(d) s, s = minv t (pallas_fused_z.py:298-299)
__device__ __forceinline__ float2 zhat_bin(float2 d, float2 b, float m,
                                           float2 t, float2 X,
                                           float inv_rho) {
  const float2 g = g_bin(d, b, X.x, X.y, inv_rho);
  const float sr = m * t.x, si = m * t.y;
  return make_float2(g.x - inv_rho * (d.x * sr + d.y * si),
                     g.y - inv_rho * (d.x * si - d.y * sr));
}

// shared memory: twiddles of both axes, A [Sy, pA] complex and R, which
// holds the packed rows ([ceil(Sy/2), pR] complex) or, for a dense row
// axis, the real plane (pass B with a dense column axis also keeps zhat
// [Sy, pA] in R); then the int maps posx [Sx] and biny [Sy].
__host__ __device__ size_t smem_bytes(int Sy, int Sx, bool pass_b) {
  const int Fx = Sx / 2 + 1;
  const size_t tw = sizeof(float2) * (size_t)(Sx + Sy);
  const size_t a = sizeof(float2) * (size_t)Sy * odd_pitch(Fx);
  size_t r = plan_axis(Sx).P > 1
                 ? sizeof(float2) * (size_t)((Sy + 1) / 2) * odd_pitch(Sx)
                 : sizeof(float) * (size_t)Sy * Sx;
  if (pass_b && plan_axis(Sy).P == 1 && a > r) r = a;
  return tw + a + r + sizeof(int) * (size_t)(Sx + Sy);
}

// the int maps follow the float2 buffers
__device__ __forceinline__ char* smem_char_end(float4* smem, int Sy, int Sx,
                                               bool pass_b) {
  return reinterpret_cast<char*>(smem) + smem_bytes(Sy, Sx, pass_b) -
         sizeof(int) * (size_t)(Sx + Sy);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fused_z_pass_a(const T* __restrict__ z, const T* __restrict__ du,
                   const float2* __restrict__ dhat,
                   const float2* __restrict__ bhat, T* __restrict__ dual_out,
                   float2* __restrict__ t, int K, int Sy, int Sx, Split sy,
                   Split sx, float inv_rho, float theta) {
  extern __shared__ float4 smem[];
  const int Fx = Sx / 2 + 1, pA = odd_pitch(Fx);
  float2* twx = reinterpret_cast<float2*>(smem);
  float2* twy = twx + Sx;
  float2* A = twy + Sy;
  float2* R = A + Sy * pA;
  int* posx = reinterpret_cast<int*>(smem_char_end(smem, Sy, Sx, false));
  int* biny = posx + Sx;
  const int n = blockIdx.x;
  const size_t P = (size_t)Sy * Sx;
  const size_t Fp = (size_t)Sy * Fx;
  const float2* bn = bhat + n * Fp;
  float2* tn = t + n * Fp;
  fill_twiddles(twx, Sx);
  fill_twiddles(twy, Sy);
  fill_maps(posx, biny, Sx, Sy, sx, sy);
  for (int k = 0; k < K; ++k) {
    const size_t plane = ((size_t)n * K + k) * P;
    const float2* dk = dhat + k * Fp;
    __syncthreads();  // the previous plane's epilogue is done with A
    forward_rows(z + plane, du + plane, dual_out + plane, R, A, twx, posx, Sy,
                 Sx, sx, theta);
    __syncthreads();
    // every thread owns the same bins for every k: t_n is summed in k
    // order by one thread per bin
    if (sy.P > 1) {
      split_forward(A, Fx, 1, pA, sy, twy);
      __syncthreads();
      for (Walk w(Fx); w.r < Sy;) {  // element (e, v) holds bin biny[e]
        float2 X[kBatch], d[kBatch], b[kBatch], acc[kBatch];
        int f[kBatch];
        Walk it = w;
#pragma unroll
        for (int q = 0; q < kBatch; ++q, it.next(Fx)) {  // all loads first
          const bool in = it.r < Sy;
          const int e = in ? it.r : Sy - 1, v = in ? it.c : Fx - 1;
          f[q] = biny[e] * Fx + v;
          X[q] = A[e * pA + v];
          d[q] = dk[f[q]];
          b[q] = bn[f[q]];
          acc[q] = k > 0 ? tn[f[q]] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q, w.next(Fx)) {
          if (w.r >= Sy) break;
          const float2 p = t_term(d[q], b[q], X[q], inv_rho);
          tn[f[q]] = k == 0 ? p : make_float2(acc[q].x + p.x, acc[q].y + p.y);
        }
      }
    } else {
      dft_cols(A, pA, twy, Sy, Fx, [&](int u, int v, float xr, float xim) {
        const int f = u * Fx + v;
        const float2 p = t_term(dk[f], bn[f], make_float2(xr, xim), inv_rho);
        if (k == 0) {
          tn[f] = p;
        } else {
          const float2 acc = tn[f];
          tn[f] = make_float2(acc.x + p.x, acc.y + p.y);
        }
      });
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fused_z_pass_b(const T* __restrict__ z, const T* __restrict__ du,
                   const float2* __restrict__ dhat,
                   const float2* __restrict__ bhat,
                   const float2* __restrict__ t,
                   const float* __restrict__ minv, T* __restrict__ z_out,
                   int K, int Sy, int Sx, Split sy, Split sx, float inv_rho,
                   float theta) {
  extern __shared__ float4 smem[];
  const int Fx = Sx / 2 + 1, pA = odd_pitch(Fx);
  float2* twx = reinterpret_cast<float2*>(smem);
  float2* twy = twx + Sx;
  float2* A = twy + Sy;
  float2* R = A + Sy * pA;
  int* posx = reinterpret_cast<int*>(smem_char_end(smem, Sy, Sx, true));
  int* biny = posx + Sx;
  const size_t p = blockIdx.x;  // plane n * K + k
  const int n = (int)(p / K), k = (int)(p % K);
  const size_t P = (size_t)Sy * Sx;
  const size_t Fp = (size_t)Sy * Fx;
  const float2* dk = dhat + k * Fp;
  const float2* bn = bhat + n * Fp;
  const float2* tn = t + n * Fp;
  fill_twiddles(twx, Sx);
  fill_twiddles(twy, Sy);
  fill_maps(posx, biny, Sx, Sy, sx, sy);
  forward_rows<T>(z + p * P, du + p * P, nullptr, R, A, twx, posx, Sy, Sx,
                  sx, theta);
  __syncthreads();  // R is dead
  if (sy.P > 1) {
    split_forward(A, Fx, 1, pA, sy, twy);
    __syncthreads();
    for (Walk w(Fx); w.r < Sy;) {  // element (e, v) holds bin biny[e]
      float2 X[kBatch], d[kBatch], b[kBatch], tf[kBatch];
      float m[kBatch];
      Walk it = w;
#pragma unroll
      for (int q = 0; q < kBatch; ++q, it.next(Fx)) {  // all loads first
        const bool in = it.r < Sy;
        const int e = in ? it.r : Sy - 1, v = in ? it.c : Fx - 1;
        const int f = biny[e] * Fx + v;
        X[q] = A[e * pA + v];
        d[q] = dk[f];
        b[q] = bn[f];
        m[q] = minv[f];
        tf[q] = tn[f];
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q, w.next(Fx)) {
        if (w.r >= Sy) break;
        A[w.r * pA + w.c] = zhat_bin(d[q], b[q], m[q], tf[q], X[q], inv_rho);
      }
    }
    __syncthreads();
    split_inverse(A, Fx, 1, pA, sy, twy, 1.f / (float)Sy);
  } else {
    dft_cols(A, pA, twy, Sy, Fx, [&](int u, int v, float xr, float xim) {
      const int f = u * Fx + v;
      R[u * pA + v] = zhat_bin(dk[f], bn[f], minv[f], tn[f],
                               make_float2(xr, xim), inv_rho);
    });
    __syncthreads();
    idft_cols(R, A, pA, twy, Sy, Fx);
  }
  __syncthreads();
  if (sx.P > 1) {
    const int pR = odd_pitch(Sx);
    pack_rows(A, pA, R, pR, Sy, Sx, Fx, posx);
    __syncthreads();
    split_inverse(R, (Sy + 1) / 2, pR, 1, sx, twx, 1.f);
    __syncthreads();
    store_rows(R, pR, z_out + p * P, Sy, Sx, 1.f / (float)Sx);
  } else {
    irdft_rows(A, pA, z_out + p * P, twx, Sy, Sx, Fx);
  }
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
      (T*)dual_out, (float2*)t, K, Sy, Sx, plan_axis(Sy), plan_axis(Sx),
      inv_rho, theta);
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
      (const float2*)t, (const float*)minv, (T*)z_out, K, Sy, Sx,
      plan_axis(Sy), plan_axis(Sx), inv_rho, theta);
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
