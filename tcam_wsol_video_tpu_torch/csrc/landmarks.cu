// Landmark (Nystrom) bilateral filter kernels for Hopper (sm_90a).
//
// The landmark CRF filter is AS ~= K_nm (K_mm + ridge I)^-1 K_mn v with
//   K[b, p, m] = exp(-1/2 ||f[b, p] - fm[b, m]||^2)
// over centred pixel features f (B, P, D) and landmark features fm
// (B, M, D).  Three kernels:
//
// build_knm_kernel replaces build_knm_pallas (tcam_wsol_video_tpu/ops/
//   pallas/landmarks.py:219, body _build_kernel): it writes K (B, P, M) in
//   fp32 or bf16; the wrapper launches it for K_nm and for K_mm = K(fm, fm).
//   Bound: the write, B P M 4 bytes (6.58 GB, 1.96 ms at the recipe's
//   B = 32, P = 224^2, M = 1024; half in bf16); its E = B P M ex2 need
//   0.39 ms.  Design: one column m per thread, its landmark in registers;
//   a tile of pixel rows staged in shared memory; each warp stores 32
//   consecutive entries of a row (coalesced).
//
// nystrom_rhs_kernel + nystrom_reduce_kernel and nystrom_out_kernel
//   replace nystrom_filter_pallas (landmarks.py:91; bodies _rhs_kernel :61
//   and _out_kernel :77), the fused two-pass filter that never writes K_nm:
//   pass 1 rhs = K_mn v (B, M, K), the wrapper's Cholesky solve gives
//   alpha, pass 2 out = K_nm alpha (B, P, K), each recomputing every weight.
//   Bound: operations, E ex2 (0.39 ms) and E (2D + 2 + 2K) fp32 flops
//   (0.39 ms at D = 5, K = 2) per pass.  Pass 1 is a reduction over P: the
//   TPU kernel carries it across a sequential grid; Hopper blocks run in no
//   order, so each block sums one slice of P into its own partial
//   (B, nsplit, M, K) and a second kernel adds the slices in a fixed order.
//   No atomics: the result is deterministic.  Pass 2 is the exact
//   bilateral kernel's shape with the landmarks as keys and alpha as values.
//
// Numerics, as csrc/bilateral.cu: the distance is the centred norm
// expansion in full fp32 on CUDA cores (never TF32), folded into the base-2
// exponent
//   e = c ||f_p||^2 + c ||fm_m||^2 + sum_d (-2 c f_p[d]) fm_m[d],
//   c = -log2(e) / 2,  w = 2^min(e, 0)       (min(e, 0) is max(d2, 0)),
// in the same order in all three kernels, so they compute the same weights.
// Ragged edges of P and M are masked in the kernels (no sentinel features,
// no padding of M).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float C_EXP2 = -0.72134752044448170368f;  // -log2(e) / 2

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float w) { *p = w; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float w) {
  *p = __float2bfloat16_rn(w);
}

// Shared-memory row width: NF = D features + 1 norm term (+ K values),
// rounded up to whole float4s.
__host__ __device__ constexpr int round4(int n) { return ((n + 3) / 4) * 4; }

template <int N>
__device__ __forceinline__ void load_row(const float* s, float (&r)[N]) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 t = reinterpret_cast<const float4*>(s)[c];
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}

// Writes one pixel row of shared memory: -2 c f (D), c ||f||^2, then the
// K values v (if any), zero up to the padded width.
template <int D, int K, int NF>
__device__ __forceinline__ void stage_pixel(float* s, const float* f,
                                            const float* v) {
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = f[d];
    sq = fmaf(x, x, sq);
    s[d] = -2.f * C_EXP2 * x;
  }
  s[D] = C_EXP2 * sq;
#pragma unroll
  for (int k = 0; k < K; ++k) s[D + 1 + k] = v[k];
#pragma unroll
  for (int d = D + 1 + K; d < NF; ++d) s[d] = 0.f;
}

// Writes one landmark row of shared memory: fm (D), c ||fm||^2, then the
// K values a, zero up to the padded width.
template <int D, int K, int NF>
__device__ __forceinline__ void stage_landmark(float* s, const float* g,
                                               const float* a) {
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = g[d];
    sq = fmaf(x, x, sq);
    s[d] = x;
  }
  s[D] = C_EXP2 * sq;
#pragma unroll
  for (int k = 0; k < K; ++k) s[D + 1 + k] = a[k];
#pragma unroll
  for (int d = D + 1 + K; d < NF; ++d) s[d] = 0.f;
}

// ------------------------------------------------------------ build_knm
constexpr int KNM_THREADS = 128;  // landmark columns per block
constexpr int KNM_ROWS = 128;     // pixel rows per block

// grid (ceil(P / KNM_ROWS), ceil(M / KNM_THREADS), B)
template <int D, typename T>
__global__ void __launch_bounds__(KNM_THREADS)
build_knm_kernel(const float* __restrict__ feats, const float* __restrict__ fm,
                 T* __restrict__ out, int P, int M) {
  constexpr int NF = round4(D + 1);
  __shared__ __align__(16) float s_r[KNM_ROWS * NF];

  const int b = blockIdx.z;
  const int p0 = blockIdx.x * KNM_ROWS;
  const int m = blockIdx.y * KNM_THREADS + threadIdx.x;
  const float* fb = feats + static_cast<size_t>(b) * P * D;

  for (int r = threadIdx.x; r < KNM_ROWS; r += KNM_THREADS) {
    const int p = min(p0 + r, P - 1);
    stage_pixel<D, 0, NF>(s_r + r * NF, fb + static_cast<size_t>(p) * D,
                          nullptr);
  }
  __syncthreads();
  if (m >= M) return;

  const float* gm = fm + (static_cast<size_t>(b) * M + m) * D;
  float g[D];
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    g[d] = gm[d];
    sq = fmaf(g[d], g[d], sq);
  }
  const float qm = C_EXP2 * sq;

  const int rows = min(KNM_ROWS, P - p0);
  T* o = out + (static_cast<size_t>(b) * P + p0) * M + m;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float h[NF];
    load_row(s_r + r * NF, h);
    float e = h[D] + qm;
#pragma unroll
    for (int d = 0; d < D; ++d) e = fmaf(h[d], g[d], e);
    store(o + static_cast<size_t>(r) * M, ex2_approx(fminf(e, 0.f)));
  }
}

// ------------------------------------------------- Nystrom pass 1: rhs
constexpr int RHS_THREADS = 128;
constexpr int RHS_LMK = 2;  // landmarks per thread
constexpr int RHS_TILE = 128;  // pixel rows per shared-memory round

// grid (ceil(M / (RHS_THREADS RHS_LMK)), nsplit, B).  Block (x, s, b) sums
// the pixels of slice s into partial[b, s, m, :] for its landmarks.
template <int D, int K>
__global__ void __launch_bounds__(RHS_THREADS)
nystrom_rhs_kernel(const float* __restrict__ feats,
                   const float* __restrict__ fm,
                   const float* __restrict__ vals,
                   float* __restrict__ partial, int P, int M, int nsplit) {
  constexpr int NF = round4(D + 1 + K);
  __shared__ __align__(16) float s_r[RHS_TILE * NF];

  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int chunk = (P + nsplit - 1) / nsplit;
  const int pb = s * chunk;
  const int pe = min(P, pb + chunk);
  const float* fb = feats + static_cast<size_t>(b) * P * D;
  const float* vb = vals + static_cast<size_t>(b) * P * K;
  const int m0 = static_cast<int>(blockIdx.x * RHS_THREADS * RHS_LMK +
                                  threadIdx.x);

  float g[RHS_LMK][D];
  float qm[RHS_LMK];
  float acc[RHS_LMK][K];
#pragma unroll
  for (int l = 0; l < RHS_LMK; ++l) {
    const int m = min(m0 + l * RHS_THREADS, M - 1);
    const float* gm = fm + (static_cast<size_t>(b) * M + m) * D;
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      g[l][d] = gm[d];
      sq = fmaf(g[l][d], g[l][d], sq);
    }
    qm[l] = C_EXP2 * sq;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[l][k] = 0.f;
  }

  for (int t0 = pb; t0 < pe; t0 += RHS_TILE) {
    const int rows = min(RHS_TILE, pe - t0);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += RHS_THREADS) {
      const size_t p = static_cast<size_t>(t0 + r);
      stage_pixel<D, K, NF>(s_r + r * NF, fb + p * D, vb + p * K);
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float h[NF];
      load_row(s_r + r * NF, h);
#pragma unroll
      for (int l = 0; l < RHS_LMK; ++l) {
        float e = h[D] + qm[l];
#pragma unroll
        for (int d = 0; d < D; ++d) e = fmaf(h[d], g[l][d], e);
        const float w = ex2_approx(fminf(e, 0.f));
#pragma unroll
        for (int k = 0; k < K; ++k) acc[l][k] = fmaf(w, h[D + 1 + k], acc[l][k]);
      }
    }
  }

#pragma unroll
  for (int l = 0; l < RHS_LMK; ++l) {
    const int m = m0 + l * RHS_THREADS;
    if (m < M) {
      float* o = partial + ((static_cast<size_t>(b) * nsplit + s) * M + m) * K;
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = acc[l][k];
    }
  }
}

// rhs[b, m, k] = sum over s = 0 .. nsplit - 1 of partial[b, s, m, k], in
// that order.  One thread per (b, m, k).
__global__ void nystrom_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ rhs, int B, int MK,
                                      int nsplit) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * MK) return;
  const size_t b = i / MK;
  const size_t j = i - b * MK;
  const float* src = partial + b * nsplit * MK + j;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += src[static_cast<size_t>(s) * MK];
  rhs[i] = acc;
}

// ------------------------------------------------- Nystrom pass 2: out
constexpr int OUT_THREADS = 128;
constexpr int OUT_ROWS = 2;    // pixels per thread
constexpr int OUT_TILE = 256;  // landmarks per shared-memory round

// grid (ceil(P / (OUT_THREADS OUT_ROWS)), B)
template <int D, int K>
__global__ void __launch_bounds__(OUT_THREADS)
nystrom_out_kernel(const float* __restrict__ feats,
                   const float* __restrict__ fm,
                   const float* __restrict__ alpha, float* __restrict__ out,
                   int P, int M) {
  constexpr int NF = round4(D + 1 + K);
  __shared__ __align__(16) float s_l[OUT_TILE * NF];

  const int b = blockIdx.y;
  const float* fb = feats + static_cast<size_t>(b) * P * D;
  const float* gb = fm + static_cast<size_t>(b) * M * D;
  const float* ab = alpha + static_cast<size_t>(b) * M * K;
  const int row0 = blockIdx.x * (OUT_THREADS * OUT_ROWS) + threadIdx.x;

  float h[OUT_ROWS][D];  // -2 c f_p
  float q[OUT_ROWS];     // c ||f_p||^2
  float acc[OUT_ROWS][K];
#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) {
    const int p = min(row0 + r * OUT_THREADS, P - 1);
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float x = fb[static_cast<size_t>(p) * D + d];
      sq = fmaf(x, x, sq);
      h[r][d] = -2.f * C_EXP2 * x;
    }
    q[r] = C_EXP2 * sq;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
  }

  for (int t0 = 0; t0 < M; t0 += OUT_TILE) {
    const int cols = min(OUT_TILE, M - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cols; j += OUT_THREADS) {
      const size_t m = static_cast<size_t>(t0 + j);
      stage_landmark<D, K, NF>(s_l + j * NF, gb + m * D, ab + m * K);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cols; ++j) {
      float gj[NF];
      load_row(s_l + j * NF, gj);
#pragma unroll
      for (int r = 0; r < OUT_ROWS; ++r) {
        float e = q[r] + gj[D];
#pragma unroll
        for (int d = 0; d < D; ++d) e = fmaf(h[r][d], gj[d], e);
        const float w = ex2_approx(fminf(e, 0.f));
#pragma unroll
        for (int k = 0; k < K; ++k) acc[r][k] = fmaf(w, gj[D + 1 + k], acc[r][k]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < OUT_ROWS; ++r) {
    const int p = row0 + r * OUT_THREADS;
    if (p < P) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[(static_cast<size_t>(b) * P + p) * K + k] = acc[r][k];
    }
  }
}

bool grid_ok(int B, int P, int M) {
  return B > 0 && P > 0 && M > 0 && B <= 65535;
}

}  // namespace

// feats (B, P, D) centred fp32, fm (B, M, D) fp32, out (B, P, M) fp32 or
// (out_bf16 != 0) bf16, all contiguous on the current device.  D in
// {3, 5, 8}: the wrapper zero-pads other widths (zero columns change no
// distance).  Returns cudaGetLastError() after the launch.
extern "C" int landmarks_build_knm(const void* feats, const void* fm,
                                   void* out, int B, int P, int M, int D,
                                   int out_bf16, void* stream) {
  if (!grid_ok(B, P, M) || (M + KNM_THREADS - 1) / KNM_THREADS > 65535)
    return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const float* g = static_cast<const float*>(fm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((P + KNM_ROWS - 1) / KNM_ROWS,
            (M + KNM_THREADS - 1) / KNM_THREADS, B);
#define TCAM_KNM_CASE(DD)                                                  \
  if (D == DD) {                                                           \
    if (out_bf16)                                                          \
      build_knm_kernel<DD, __nv_bfloat16><<<grid, KNM_THREADS, 0, s>>>(    \
          f, g, static_cast<__nv_bfloat16*>(out), P, M);                   \
    else                                                                   \
      build_knm_kernel<DD, float><<<grid, KNM_THREADS, 0, s>>>(            \
          f, g, static_cast<float*>(out), P, M);                           \
    return cudaGetLastError();                                             \
  }
  TCAM_KNM_CASE(3)
  TCAM_KNM_CASE(5)
  TCAM_KNM_CASE(8)
#undef TCAM_KNM_CASE
  return cudaErrorInvalidValue;
}

// Pass 1.  feats (B, P, D) centred, fm (B, M, D), vals (B, P, K) fp32;
// partial (B, nsplit, M, K) fp32 scratch, rhs (B, M, K) fp32 out.  D in
// {3, 5, 8}, K in {2, 8}.  Launches the slice sums and the fixed-order
// reduction; returns cudaGetLastError() after each.
extern "C" int landmarks_nystrom_rhs(const void* feats, const void* fm,
                                     const void* vals, void* partial,
                                     void* rhs, int B, int P, int M, int D,
                                     int K, int nsplit, void* stream) {
  if (!grid_ok(B, P, M) || nsplit < 1 || nsplit > 65535)
    return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const float* g = static_cast<const float*>(fm);
  const float* v = static_cast<const float*>(vals);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((M + RHS_THREADS * RHS_LMK - 1) / (RHS_THREADS * RHS_LMK),
            nsplit, B);
  bool launched = false;
#define TCAM_RHS_CASE(DD, KK)                                              \
  if (D == DD && K == KK) {                                                \
    nystrom_rhs_kernel<DD, KK><<<grid, RHS_THREADS, 0, s>>>(f, g, v, part, \
                                                            P, M, nsplit); \
    launched = true;                                                       \
  }
  TCAM_RHS_CASE(3, 2)
  TCAM_RHS_CASE(5, 2)
  TCAM_RHS_CASE(8, 2)
  TCAM_RHS_CASE(3, 8)
  TCAM_RHS_CASE(5, 8)
  TCAM_RHS_CASE(8, 8)
#undef TCAM_RHS_CASE
  if (!launched) return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * M * K;
  const int threads = 256;
  nystrom_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, s>>>(part, static_cast<float*>(rhs), B,
                                           M * K, nsplit);
  return cudaGetLastError();
}

// Pass 2.  feats (B, P, D) centred, fm (B, M, D), alpha (B, M, K) fp32;
// out (B, P, K) fp32.  D in {3, 5, 8}, K in {2, 8}.
extern "C" int landmarks_nystrom_out(const void* feats, const void* fm,
                                     const void* alpha, void* out, int B,
                                     int P, int M, int D, int K,
                                     void* stream) {
  if (!grid_ok(B, P, M)) return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const float* g = static_cast<const float*>(fm);
  const float* a = static_cast<const float*>(alpha);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((P + OUT_THREADS * OUT_ROWS - 1) / (OUT_THREADS * OUT_ROWS), B);
#define TCAM_OUT_CASE(DD, KK)                                               \
  if (D == DD && K == KK) {                                                 \
    nystrom_out_kernel<DD, KK><<<grid, OUT_THREADS, 0, s>>>(f, g, a, o, P,  \
                                                            M);             \
    return cudaGetLastError();                                              \
  }
  TCAM_OUT_CASE(3, 2)
  TCAM_OUT_CASE(5, 2)
  TCAM_OUT_CASE(8, 2)
  TCAM_OUT_CASE(3, 8)
  TCAM_OUT_CASE(5, 8)
  TCAM_OUT_CASE(8, 8)
#undef TCAM_OUT_CASE
  return cudaErrorInvalidValue;
}
