// Exact dense bilateral (Gaussian-attention) filter for Hopper (sm_90a).
//
//   out[b, i, :] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) * v[b, j, :]
//
// Replaces the TPU kernel gaussian_filter_apply_pallas_batched
// (tcam_wsol_video_tpu/ops/pallas/bilateral.py:159, body
// _kernel_batched_sym) and, as its B = 1 case, gaussian_filter_apply_pallas
// (bilateral.py:210).
//
// Design.  Each block owns ROWS_PER_THREAD * THREADS query pixels of one
// image (grid = (query tiles, B)) and loops over every key pixel of that
// image: key features and values are staged through shared memory one
// TILE at a time, each thread keeps its queries' K sums in fp32 registers.
// No atomics and no cross-block reduction, so results are deterministic.
// The TPU kernel's symmetry trick (a scratch carried across the
// sequential grid) has no Hopper counterpart; this first kernel computes
// every (i, j) pair.
//
// Numerics.  The wrapper centres the features per image.  The distance
// uses the centred norm expansion in full fp32 on CUDA cores (never TF32:
// the cancellation in ||f_i||^2 + ||f_j||^2 - 2 f_i.f_j needs fp32), folded
// into the base-2 exponent:
//   e = c ||f_i||^2 + c ||f_j||^2 + sum_d (-2 c f_i[d]) f_j[d],  c = -log2(e)/2
//   w = 2^min(e, 0)                       (min(e, 0) is max(d2, 0))
// Key pixels past P get c ||f_j||^2 = -inf and zero values, so the ragged
// edge is masked in the kernel: w = 2^-inf = 0.
//
// Bound.  The weight is symmetric, so the function needs per unordered
// pair one MUFU ex2 (16 / clk / SM), D FMAs, an add and a min, and 2K FMAs
// (W v both ways): B P (P + 1) / 2 = 4.0e10 pairs at the recipe's shapes
// (B = 32, P = 224^2, D = 5, K = 2) give ~12 ms on the FP32 pipe and
// ~9.6 ms of ex2; bytes are ~58 MB (0.02 ms).  This kernel computes every
// ordered pair (twice the exps of that bound).  Holding ROWS_PER_THREAD
// queries per thread amortises the shared-memory loads over the pairs.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS_PER_THREAD = 2;
constexpr int TILE = 256;  // key pixels staged per shared-memory round
constexpr float C_EXP2 = -0.72134752044448170368f;  // -log2(e) / 2

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NF: features + the c||f||^2 term, padded to a multiple of 4 floats.
template <int D>
struct KeyWidth {
  static constexpr int NF = ((D + 1 + 3) / 4) * 4;
};

template <int D, int K>
__global__ void __launch_bounds__(THREADS)
bilateral_exact_kernel(const float* __restrict__ feats,
                       const float* __restrict__ vals,
                       float* __restrict__ out, int P) {
  constexpr int NF = KeyWidth<D>::NF;
  __shared__ __align__(16) float s_f[TILE * NF];
  __shared__ __align__(16) float s_v[TILE * K];

  const int b = blockIdx.y;
  const float* fb = feats + static_cast<size_t>(b) * P * D;
  const float* vb = vals + static_cast<size_t>(b) * P * K;
  float* ob = out + static_cast<size_t>(b) * P * K;
  const int row0 = blockIdx.x * (THREADS * ROWS_PER_THREAD) + threadIdx.x;

  float h[ROWS_PER_THREAD][D];  // -2 c f_i
  float q[ROWS_PER_THREAD];     // c ||f_i||^2
  float acc[ROWS_PER_THREAD][K];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int i = min(row0 + r * THREADS, P - 1);
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float f = fb[static_cast<size_t>(i) * D + d];
      sq = fmaf(f, f, sq);
      h[r][d] = -2.f * C_EXP2 * f;
    }
    q[r] = C_EXP2 * sq;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
  }

  for (int t0 = 0; t0 < P; t0 += TILE) {
    __syncthreads();
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int jj = t0 + j;
      float* sf = s_f + j * NF;
      if (jj < P) {
        float sq = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float f = fb[static_cast<size_t>(jj) * D + d];
          sq = fmaf(f, f, sq);
          sf[d] = f;
        }
        sf[D] = C_EXP2 * sq;
#pragma unroll
        for (int k = 0; k < K; ++k)
          s_v[j * K + k] = vb[static_cast<size_t>(jj) * K + k];
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) sf[d] = 0.f;
        sf[D] = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < K; ++k) s_v[j * K + k] = 0.f;
      }
#pragma unroll
      for (int d = D + 1; d < NF; ++d) sf[d] = 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float fj[NF];
#pragma unroll
      for (int c = 0; c < NF / 4; ++c) {
        const float4 t = reinterpret_cast<const float4*>(s_f + j * NF)[c];
        fj[4 * c] = t.x;
        fj[4 * c + 1] = t.y;
        fj[4 * c + 2] = t.z;
        fj[4 * c + 3] = t.w;
      }
      float vj[K];
      if constexpr (K % 4 == 0) {
#pragma unroll
        for (int c = 0; c < K / 4; ++c) {
          const float4 t = reinterpret_cast<const float4*>(s_v + j * K)[c];
          vj[4 * c] = t.x;
          vj[4 * c + 1] = t.y;
          vj[4 * c + 2] = t.z;
          vj[4 * c + 3] = t.w;
        }
      } else if constexpr (K % 2 == 0) {
#pragma unroll
        for (int c = 0; c < K / 2; ++c) {
          const float2 t = reinterpret_cast<const float2*>(s_v + j * K)[c];
          vj[2 * c] = t.x;
          vj[2 * c + 1] = t.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) vj[k] = s_v[j * K + k];
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        float e = q[r] + fj[D];
#pragma unroll
        for (int d = 0; d < D; ++d) e = fmaf(h[r][d], fj[d], e);
        const float w = ex2_approx(fminf(e, 0.f));
#pragma unroll
        for (int k = 0; k < K; ++k) acc[r][k] = fmaf(w, vj[k], acc[r][k]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int i = row0 + r * THREADS;
    if (i < P) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        ob[static_cast<size_t>(i) * K + k] = acc[r][k];
    }
  }
}

template <int D, int K>
cudaError_t launch(const float* feats, const float* vals, float* out, int B,
                   int P, cudaStream_t stream) {
  const int rows_per_block = THREADS * ROWS_PER_THREAD;
  dim3 grid((P + rows_per_block - 1) / rows_per_block, B);
  bilateral_exact_kernel<D, K><<<grid, THREADS, 0, stream>>>(feats, vals,
                                                             out, P);
  return cudaGetLastError();
}

}  // namespace

// feats (B, P, D) centred fp32, vals (B, P, K) fp32, out (B, P, K) fp32,
// all contiguous on the current device.  D in {3, 5, 8}, K in {2, 8}: the
// wrapper zero-pads other widths up to these (zero columns change neither
// distances nor sums).  Returns cudaGetLastError() after the launch.
extern "C" int bilateral_exact_forward(const void* feats, const void* vals,
                                       void* out, int B, int P, int D, int K,
                                       void* stream) {
  if (B <= 0 || P <= 0 || B > 65535) return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TCAM_BILATERAL_CASE(DD, KK) \
  if (D == DD && K == KK) return launch<DD, KK>(f, v, o, B, P, s);
  TCAM_BILATERAL_CASE(3, 2)
  TCAM_BILATERAL_CASE(5, 2)
  TCAM_BILATERAL_CASE(8, 2)
  TCAM_BILATERAL_CASE(3, 8)
  TCAM_BILATERAL_CASE(5, 8)
  TCAM_BILATERAL_CASE(8, 8)
#undef TCAM_BILATERAL_CASE
  return cudaErrorInvalidValue;
}
