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
// those bytes over the memory rate. To reach it the kernel needs many
// loads in flight on every SM and must move each byte once.
//
// Design. A block of kThreads = kTF x kG threads covers a tile of kTF = 32
// consecutive frequencies (a warp's lanes, so every k-row access is one
// coalesced 256-byte load) and kG = 8 k-groups (one warp each): thread
// (f, g) owns k in {g, g + kG, g + 2 kG, ...}. With KPT (a template
// parameter, reached through a switch so no register array takes a dynamic
// index) values per thread it keeps its d, dinv and xi2 (then g) in
// registers, and issues all of its global loads before it uses any. The
// partial t (complex) and den of the kG groups are summed through shared
// memory in the fixed order g = 0..kG-1 by every thread of the column, so
// the result is bitwise repeatable (no atomics); each thread then writes
// its z_k from registers. xi2 is read once and nothing is re-read.
// A block loops over a chunk of NC images with d, dinv and den (computed
// once per block) held in registers, so dhat/dinv cross memory once per
// chunk instead of once per image; the grid is (ceil(F / kTF),
// ceil(N / NC)), both chosen by ops/kernels.py::k1_launch_plan. K > kG * 16
// runs a generic loop that re-reads d, dinv and xi2 in a second pass over
// k. The TPU kernel's re/im plane split and its padding of K to 8 sublanes
// do not carry over.
//
// Two blocks per SM (__launch_bounds__, at most 128 registers a thread):
// sized for three, KPT = 13 spilled and ran slower. z is written with
// plain stores: evict-first stores (__stcs) were no faster (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTF = 32;  // frequencies per tile: one warp's lanes
constexpr int kG = 8;    // k-groups: one warp each
constexpr int kThreads = kTF * kG;
constexpr int kMaxGridY = 65535;

struct Args {
  const float2* dhat;
  const float2* xi1;
  const float2* xi2;
  const float* dinv;
  float2* z;
  float rho;
  int K, F, N, NC;
};

// g = dinv (conj(d) x1 + rho x2)
__device__ __forceinline__ float2 g_of(float2 d, float di, float2 x1,
                                       float2 x2, float rho) {
  return make_float2(di * (d.x * x1.x + d.y * x1.y + rho * x2.x),
                     di * (d.x * x1.y - d.y * x1.x + rho * x2.y));
}

// z = g - dinv conj(d) s
__device__ __forceinline__ float2 z_of(float2 g, float2 d, float di,
                                       float2 s) {
  return make_float2(g.x - di * (d.x * s.x + d.y * s.y),
                     g.y - di * (d.x * s.y - d.y * s.x));
}

// The column's den: 1 + the kG partials summed in order g = 0..kG-1.
__device__ __forceinline__ float reduce_den(float (*part)[kTF], float p) {
  part[threadIdx.y][threadIdx.x] = p;
  __syncthreads();
  float acc = part[0][threadIdx.x];
#pragma unroll
  for (int i = 1; i < kG; ++i) acc += part[i][threadIdx.x];
  return 1.f + acc;
}

// The column's t / den, from the kG partials of t in order g = 0..kG-1.
// `part` alternates between two buffers from one image to the next, so one
// barrier per image suffices: a thread can only overwrite a buffer after
// every thread has passed the next image's barrier, i.e. has read it.
__device__ __forceinline__ float2 reduce_s(float2 (*part)[kTF], float2 p,
                                           float den) {
  part[threadIdx.y][threadIdx.x] = p;
  __syncthreads();
  float2 acc = part[0][threadIdx.x];
#pragma unroll
  for (int i = 1; i < kG; ++i) {
    const float2 q = part[i][threadIdx.x];
    acc.x += q.x;
    acc.y += q.y;
  }
  return make_float2(acc.x / den, acc.y / den);
}

// KPT values of k per thread, kept in registers: kG * KPT >= K.
template <int KPT>
__global__ void __launch_bounds__(kThreads, 2) k1_registers(Args a) {
  __shared__ float den_part[kG][kTF];
  __shared__ float2 t_part[2][kG][kTF];
  const int g = threadIdx.y;
  const int f = blockIdx.x * kTF + threadIdx.x;
  const bool f_in = f < a.F;
  const int n0 = blockIdx.y * a.NC;
  const int n1 = min(a.N, n0 + a.NC);
  const size_t KF = (size_t)a.K * a.F;
  const size_t base = (size_t)g * a.F + f;  // offset of this thread's j = 0
  const size_t step = (size_t)kG * a.F;     // from j to j + 1
  const float2 zero = make_float2(0.f, 0.f);

  bool ok[KPT];
  float2 d[KPT];
  float di[KPT];
  float2 x[KPT];  // xi2, then g
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    ok[j] = f_in && g + j * kG < a.K;
    d[j] = ok[j] ? __ldg(a.dhat + base + j * step) : zero;
    di[j] = ok[j] ? __ldg(a.dinv + base + j * step) : 0.f;
  }
  float2 x1 = f_in ? __ldg(a.xi1 + (size_t)n0 * a.F + f) : zero;
#pragma unroll
  for (int j = 0; j < KPT; ++j)
    x[j] = ok[j] ? __ldg(a.xi2 + n0 * KF + base + j * step) : zero;

  float pden = 0.f;
#pragma unroll
  for (int j = 0; j < KPT; ++j)
    pden += (d[j].x * d[j].x + d[j].y * d[j].y) * di[j];
  const float den = reduce_den(den_part, pden);

  for (int n = n0; n < n1; ++n) {
    if (n > n0) {  // the first image's loads were issued with d's
      x1 = f_in ? __ldg(a.xi1 + (size_t)n * a.F + f) : zero;
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        x[j] = ok[j] ? __ldg(a.xi2 + n * KF + base + j * step) : zero;
    }
    float2 t = zero;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      x[j] = g_of(d[j], di[j], x1, x[j], a.rho);
      t.x += d[j].x * x[j].x - d[j].y * x[j].y;
      t.y += d[j].x * x[j].y + d[j].y * x[j].x;
    }
    const float2 s = reduce_s(t_part[(n - n0) & 1], t, den);
    float2* zn = a.z + n * KF + base;
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      if (ok[j]) zn[j * step] = z_of(x[j], d[j], di[j], s);
  }
}

// Any K: each pass loops over the thread's k and re-reads d, dinv and xi2.
__global__ void __launch_bounds__(kThreads, 2) k1_loop(Args a) {
  __shared__ float den_part[kG][kTF];
  __shared__ float2 t_part[2][kG][kTF];
  const int g = threadIdx.y;
  const int f = blockIdx.x * kTF + threadIdx.x;
  const bool f_in = f < a.F;
  const int n0 = blockIdx.y * a.NC;
  const int n1 = min(a.N, n0 + a.NC);
  const size_t KF = (size_t)a.K * a.F;
  const size_t base = (size_t)g * a.F + f;
  const size_t step = (size_t)kG * a.F;
  const float2 zero = make_float2(0.f, 0.f);
  const int kpt = f_in && g < a.K ? (a.K - g + kG - 1) / kG : 0;

  float pden = 0.f;
  for (int j = 0; j < kpt; ++j) {
    const float2 d = __ldg(a.dhat + base + j * step);
    pden += (d.x * d.x + d.y * d.y) * __ldg(a.dinv + base + j * step);
  }
  const float den = reduce_den(den_part, pden);

  for (int n = n0; n < n1; ++n) {
    const float2 x1 = f_in ? __ldg(a.xi1 + (size_t)n * a.F + f) : zero;
    const float2* xn = a.xi2 + n * KF + base;
    float2 t = zero;
    for (int j = 0; j < kpt; ++j) {
      const float2 d = __ldg(a.dhat + base + j * step);
      const float2 gk = g_of(d, __ldg(a.dinv + base + j * step), x1,
                             __ldg(xn + j * step), a.rho);
      t.x += d.x * gk.x - d.y * gk.y;
      t.y += d.x * gk.y + d.y * gk.x;
    }
    const float2 s = reduce_s(t_part[(n - n0) & 1], t, den);
    float2* zn = a.z + n * KF + base;
    for (int j = 0; j < kpt; ++j) {
      const float2 d = __ldg(a.dhat + base + j * step);
      const float di = __ldg(a.dinv + base + j * step);
      zn[j * step] =
          z_of(g_of(d, di, x1, __ldg(xn + j * step), a.rho), d, di, s);
    }
  }
}

template <int KPT>
void launch(const Args& a, dim3 grid, cudaStream_t stream) {
  k1_registers<KPT><<<grid, dim3(kTF, kG), 0, stream>>>(a);
}

}  // namespace

// Launches K1 on `stream` with the plan of ops/kernels.py::k1_launch_plan
// and returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for a plan this source was not built for: tf and g must be kTF and kG,
// kpt one of the register instantiations with g * kpt >= K (0: the generic
// loop), and the grid (ceil(F / tf), ceil(N / nc)) with at most 65535
// chunks. Pointers are device pointers of contiguous tensors; the caller
// checks shapes and types.
extern "C" int ccsc_solve_z_rank1(const void* dhat, const void* xi1,
                                  const void* xi2, const void* dinv, void* z,
                                  float rho, int K, int F, int N, int tf,
                                  int g, int kpt, int nc, int grid_x,
                                  int grid_y, void* stream) {
  if (K < 1 || F < 1 || N < 1 || nc < 1 || tf != kTF || g != kG ||
      (kpt != 0 && kG * kpt < K) || grid_x != (F + kTF - 1) / kTF ||
      grid_y != (N + nc - 1) / nc || grid_y > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float2*)dhat, (const float2*)xi1, (const float2*)xi2,
               (const float*)dinv,  (float2*)z,          rho,
               K,                   F,                   N,
               nc};
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kpt) {
    case 0: k1_loop<<<grid, dim3(kTF, kG), 0, s>>>(a); break;
    case 1: launch<1>(a, grid, s); break;
    case 2: launch<2>(a, grid, s); break;
    case 4: launch<4>(a, grid, s); break;
    case 8: launch<8>(a, grid, s); break;
    case 13: launch<13>(a, grid, s); break;
    case 16: launch<16>(a, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
