// Landmark (Nystrom) bilateral filter kernels for Hopper (sm_90a).
//
// The landmark CRF filter is AS ~= K_nm (K_mm + ridge I)^-1 K_mn v with
//   K[b, p, m] = exp(-1/2 ||f[b, p] - fm[b, m]||^2)
// over centred pixel features f (B, P, D) and landmark features fm
// (B, M, D).  Kernels:
//
// build_knm_kernel replaces build_knm_pallas (tcam_wsol_video_tpu/ops/
//   pallas/landmarks.py:219, body _build_kernel): it writes K (B, P, M) in
//   fp32 or bf16; the wrapper launches it for K_nm and for K_mm = K(fm, fm).
//   Bound: the write, B P M 4 bytes (6.58 GB, 1.96 ms at the recipe's
//   B = 32, P = 224^2, M = 1024; half in bf16); its E = B P M ex2 need
//   0.39 ms.  Design: one column m per thread, its landmark in registers;
//   a tile of pixel rows staged in shared memory; each warp stores 32
//   consecutive entries of a row (coalesced).  The distance is the centred
//   norm expansion in full fp32 on the CUDA cores, folded into the base-2
//   exponent
//     e = c ||f_p||^2 + c ||fm_m||^2 + sum_d (-2 c f_p[d]) fm_m[d],
//     c = -log2(e) / 2,  w = 2^min(e, 0)     (min(e, 0) is max(d2, 0)).
//
// nystrom_kernel + nystrom_reduce_kernel replace nystrom_filter_pallas
//   (landmarks.py:91; bodies _rhs_kernel :61 and _out_kernel :77), the
//   fused two-pass filter that never writes K_nm: pass 1 rhs = K_mn v
//   (B, M, K), the wrapper's Cholesky solve gives alpha, pass 2 out =
//   K_nm alpha (B, P, K).  Both passes are one kernel body: each row sums
//   its keys' values weighted by w = 2^min(e, 0), unnormalized.  Pass 1
//   takes landmarks as rows and pixels as keys with the values v; pass 2
//   pixels as rows and landmarks as keys with alpha.
//
//   Bound: operations.  Each of the E = B P M entries of a pass needs one
//   ex2 (MUFU, 16 a clock per SM: 0.39 ms at the recipe's shape) and
//   2D + 2 + 2K fp32 flops (0.39 ms at D = 5, K = 2).  Kernels that
//   compute the exponent on the CUDA cores too need ~10 fp32-pipe
//   instructions per ex2, and a scheduler issues one warp instruction a
//   clock, so they are issue-bound at ~2x the bound.  Here the cross term
//   of the exponent comes off the tensor cores.  Per entry the CUDA cores
//   keep one FADD (the norms, below), fminf, one ex2.approx.ftz and the K
//   value FFMAs, plus a share of the mma and the shared-memory loads.  ex2
//   stays on MUFU.  On the H100 an mma.sync is not free beside MUFU: the
//   time of a pass grows by about the mma's own share (PERF.md), so the
//   design issues as few as it can, one m16n8k16 per 16 x 8 tile at
//   D <= 5.
//
//   The exponent.  e = (c ||x||^2 + c ||y||^2) + sum_d a_d y_d with
//   a = -2c x: the two norms in fp32 on the CUDA cores, their sum the
//   accumulator's start, and the cross term as one fp16 mma.sync.m16n8k16
//   product in a 3-way split: each operand is split once, when it is
//   staged, into hi = fp16(x) and lo = fp16(x - hi), and the k = 16 columns
//   hold rows [hi(a) | lo(a) | hi(a)] against keys [hi(y) | hi(y) | lo(y)]
//   (3D <= 15 columns at D <= 5; two products at D = 8), so that one
//   product gives hi(a) hi(y) + lo(a) hi(y) + hi(a) lo(y) in the fp32
//   accumulators.  Precision: one fp16 part keeps 11 significant bits, the
//   cross term reaches ~1e3 at the recipe's features (colours over
//   sigma_rgb = 15), so plain fp16 (or TF32, which has the same
//   significand) would leave ~0.1 in e, ~7% of a weight.  The split keeps
//   ~22 bits: the dropped lo(a) lo(y) and the rounding of lo are below
//   2^-22 of their term, < 1e-4 in e at the largest features (< 7e-5 of a
//   weight), the order of the fp32 norm expansion's own cancellation
//   error.  fp16 has TF32's significand but not its exponent range: the
//   operands must stay under 65504 in magnitude, i.e. each feature under
//   4.5e4 (the CRF features are colours and positions over their sigmas,
//   under 256 at sigmas down to 1); a lo part under 6e-5 is subnormal,
//   which costs at most 3e-8 of absolute error a product.  A 3xTF32 version (three
//   m16n8k8 products) and an asynchronous wgmma version held the same
//   tolerances and ran slower.  tests/test_torch_nystrom_mma.py emulates this
//   decomposition against the JAX kernel; PERF.md gives the error
//   measured on the card.
//
//   Layout.  A block is 4 warps; a warp holds its 16-row tiles as A
//   fragments in registers for the whole kernel.  Keys stream through
//   shared memory, NYS_KEYS a round: raw features and values arrive by
//   cp.async in a two-stage ring (round i + 1's copies fly while round i
//   computes), and each thread splits one key into the B-fragment layout:
//   for thread t of a quad, the columns {2t, 2t + 1, 2t + 8, 2t + 9} of a
//   key are one 8-byte word, so a fragment is one conflict-free LDS.64.
//   An accumulator fragment holds rows g, g + 8 and keys 2t, 2t + 1; those
//   two keys' values and norms are two more LDS.128 (K = 2), shared by all
//   of the warp's row tiles.  After the last key the four threads of a
//   quad add their sums with two shuffles.
//
//   Pass 1 is a reduction over P: the TPU kernel carries it across a
//   sequential grid; Hopper blocks run in no order, so each block sums one
//   slice of P into its own partial (B, nsplit, M, K) and a second kernel
//   adds the slices in a fixed order.  No atomics: two calls are bit-equal.
//   Ragged P and M are masked in the kernel: a key past its slice has the
//   value 0, a row past the end is computed on the last row's features and
//   not stored (no sentinel features, no padding of M).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Shared-memory row width: NF = D features + 1 norm term, rounded up to
// whole float4s.
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

// Writes one pixel row of shared memory: -2 c f (D), c ||f||^2, zero up to
// the padded width.
template <int D, int NF>
__device__ __forceinline__ void stage_pixel(float* s, const float* f) {
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = f[d];
    sq = fmaf(x, x, sq);
    s[d] = -2.f * C_EXP2 * x;
  }
  s[D] = C_EXP2 * sq;
#pragma unroll
  for (int d = D + 1; d < NF; ++d) s[d] = 0.f;
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
    stage_pixel<D, NF>(s_r + r * NF, fb + static_cast<size_t>(p) * D);
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

// ------------------------------------------------------ Nystrom passes
constexpr int NYS_THREADS = 128;  // 4 warps
constexpr int NYS_KEYS = 128;     // keys a shared-memory round, one a thread

// k = 16 steps of the split product's 3 D columns: one for D <= 5
__host__ __device__ constexpr int nys_steps(int D) { return (3 * D + 15) / 16; }
// 16-row tiles a warp holds: fewer where the sums are wide
__host__ __device__ constexpr int nys_row_tiles(int K) {
  return K == 2 ? 4 : 2;
}
__host__ __device__ constexpr int nys_rows(int K) {
  return NYS_THREADS / 32 * nys_row_tiles(K) * 16;
}
// floats of a key's row of s_val: its K values, c ||y||^2, zero padding
__host__ __device__ constexpr int nys_val_width(int K) { return round4(K + 1); }

// x = hi + lo + O(2^-22 |x|): hi = fp16(x), lo = fp16(x - hi), as floats
__device__ __forceinline__ void split_f16(float x, float& hi, float& lo) {
  hi = __half2float(__float2half_rn(x));
  lo = __half2float(__float2half_rn(x - hi));
}

// two fp16 values (exact in fp16) in one register, the first in the low half
__device__ __forceinline__ unsigned pack_f16(float first, float second) {
  const __half2 h = __floats2half2_rn(first, second);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Column c of the split operands: row side [hi(a), lo(a), hi(a)], key side
// [hi(y), hi(y), lo(y)], each D wide, zero past 3 D; so that row . key =
// hi(a) hi(y) + lo(a) hi(y) + hi(a) lo(y).  c may be known only at run time.
template <int D, bool ROW>
__device__ __forceinline__ float split_col(const float (&hi)[D],
                                           const float (&lo)[D], int c) {
  float r = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    r = c == d ? hi[d] : r;
    r = c == D + d ? (ROW ? lo[d] : hi[d]) : r;
    r = c == 2 * D + d ? (ROW ? hi[d] : lo[d]) : r;
  }
  return r;
}

// d += a b: one fp16 m16n8k16 product, fp32 accumulators
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// grid (ceil(NR / nys_rows), nsplit, B).  Block (x, s, b) sums, for its
// rows, the keys of slice s:
//   out[b, s, row, :] = sum over keys j of slice s of w(row, j) kv[b, j, :]
// rowf (B, NR, D), keyf (B, NK, D), kv (B, NK, K), out (B, nsplit, NR, K).
template <int D, int K>
__global__ void __launch_bounds__(NYS_THREADS, 5)
nystrom_kernel(const float* __restrict__ rowf, const float* __restrict__ keyf,
               const float* __restrict__ kv, float* __restrict__ out, int NR,
               int NK, int nsplit) {
  constexpr int S = nys_steps(D);
  constexpr int R = nys_row_tiles(K);
  constexpr int RAW = D + K;         // floats of one raw key
  constexpr int VW = nys_val_width(K);
  __shared__ __align__(16) float s_raw[2][NYS_KEYS * RAW];
  __shared__ __align__(16) unsigned s_op[NYS_KEYS * 8 * S];
  __shared__ __align__(16) float s_val[NYS_KEYS * VW];

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // rows g, g + 8; key g of a B tile
  const int t = lane & 3;   // columns 2t, 2t + 1 (+ 8); keys 2t, 2t + 1
  const int row0 = blockIdx.x * nys_rows(K) + (threadIdx.x >> 5) * R * 16;

  // A fragments of the warp's row tiles: register h + 2 j holds row
  // g + 8 h, columns 2t + 8 j and 2t + 8 j + 1 of each k = 16 step; qr its
  // rows' c ||x||^2
  unsigned afr[R][S][4];
  float qr[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(row0 + r * 16 + g + 8 * h, NR - 1);
      const float* x = rowf + (static_cast<size_t>(b) * NR + row) * D;
      float hi[D], lo[D];
      float sq = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float xd = x[d];
        sq = fmaf(xd, xd, sq);
        split_f16(-2.f * C_EXP2 * xd, hi[d], lo[d]);
      }
      qr[r][h] = C_EXP2 * sq;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * s + 2 * t + 8 * j;
          afr[r][s][h + 2 * j] = pack_f16(split_col<D, true>(hi, lo, c),
                                          split_col<D, true>(hi, lo, c + 1));
        }
      }
    }
  }

  float acc[R][2][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[r][h][k] = 0.f;

  const int chunk = (NK + nsplit - 1) / nsplit;
  const int kb = min(NK, split * chunk);
  const int ke = min(NK, kb + chunk);
  const int nrounds = (ke - kb + NYS_KEYS - 1) / NYS_KEYS;
  const float* kfb = keyf + static_cast<size_t>(b) * NK * D;
  const float* kvb = kv + static_cast<size_t>(b) * NK * K;

  // this thread's key of a round into ring stage buf (zeros past the slice)
  auto fetch = [&](int round, int buf) {
    const int key = kb + round * NYS_KEYS + static_cast<int>(threadIdx.x);
    const bool ok = key < ke;
    const size_t kc = static_cast<size_t>(ok ? key : kb);
    float* dst = &s_raw[buf][threadIdx.x * RAW];
#pragma unroll
    for (int d = 0; d < D; ++d) cp_async4(dst + d, kfb + kc * D + d, ok);
#pragma unroll
    for (int k = 0; k < K; ++k) cp_async4(dst + D + k, kvb + kc * K + k, ok);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  if (nrounds > 0) fetch(0, 0);
  for (int round = 0; round < nrounds; ++round) {
    const int buf = round & 1;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the last round's operands are no longer read
    if (round + 1 < nrounds) fetch(round + 1, buf ^ 1);
    {
      // split this thread's key into the B-fragment layout: for thread t
      // of a quad, columns {2t, 2t + 1, 2t + 8, 2t + 9} of a k = 16 step
      // are one 8-byte word; then its values and c ||y||^2
      const float* y = &s_raw[buf][threadIdx.x * RAW];
      float hi[D], lo[D];
      float sq = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float yd = y[d];
        sq = fmaf(yd, yd, sq);
        split_f16(yd, hi[d], lo[d]);
      }
      uint4* o = reinterpret_cast<uint4*>(s_op + threadIdx.x * 8 * S);
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          unsigned w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 16 * s + 2 * (2 * q + i / 2) + 8 * (i % 2);
            w[i] = pack_f16(split_col<D, false>(hi, lo, c),
                            split_col<D, false>(hi, lo, c + 1));
          }
          o[2 * s + q] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      float* sv = s_val + threadIdx.x * VW;
#pragma unroll
      for (int k = 0; k < K; ++k) sv[k] = y[D + k];
      sv[K] = C_EXP2 * sq;
    }
    __syncthreads();

    const int ntiles = (min(NYS_KEYS, ke - kb - round * NYS_KEYS) + 7) / 8;
    for (int kt = 0; kt < ntiles; ++kt) {
      unsigned bfr[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint2 q = *reinterpret_cast<const uint2*>(
            s_op + (kt * 8 + g) * 8 * S + 8 * s + 2 * t);
        bfr[s][0] = q.x;
        bfr[s][1] = q.y;
      }
      // values and c ||y||^2 of keys 2t and 2t + 1
      float v[2][VW];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < VW / 4; ++j) {
          const float4 q = reinterpret_cast<const float4*>(
              s_val + (kt * 8 + 2 * t + i) * VW)[j];
          v[i][4 * j] = q.x;
          v[i][4 * j + 1] = q.y;
          v[i][4 * j + 2] = q.z;
          v[i][4 * j + 3] = q.w;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // e[0], e[1]: row g, keys 2t, 2t + 1; e[2], e[3]: row g + 8
        float e[4] = {qr[r][0] + v[0][K], qr[r][0] + v[1][K],
                      qr[r][1] + v[0][K], qr[r][1] + v[1][K]};
#pragma unroll
        for (int s = 0; s < S; ++s) mma_f16(e, afr[r][s], bfr[s][0], bfr[s][1]);
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = ex2_approx(fminf(e[i], 0.f));
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[r][0][k] = fmaf(w[1], v[1][k], fmaf(w[0], v[0][k], acc[r][0][k]));
          acc[r][1][k] = fmaf(w[3], v[1][k], fmaf(w[2], v[0][k], acc[r][1][k]));
        }
      }
    }
  }

  // the quad's four threads hold the same rows over other keys
  float* ob = out + (static_cast<size_t>(b) * nsplit + split) * NR * K;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r * 16 + g + 8 * h;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float x = acc[r][h][k];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (row < NR && (h * K + k) % 4 == t)
          ob[static_cast<size_t>(row) * K + k] = x;
      }
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

// One Nystrom pass: rows (B, NR, D) against keys (B, NK, D) with values
// (B, NK, K) into out (B, nsplit, NR, K).  D in {3, 5, 8}, K in {2, 8}.
cudaError_t launch_nystrom(const float* rows, const float* keys,
                           const float* vals, float* out, int B, int NR,
                           int NK, int D, int K, int nsplit,
                           cudaStream_t s) {
#define TCAM_NYS_CASE(DD, KK)                                               \
  if (D == DD && K == KK) {                                                 \
    constexpr int rows_per_block = nys_rows(KK);                            \
    dim3 grid((NR + rows_per_block - 1) / rows_per_block, nsplit, B);       \
    nystrom_kernel<DD, KK><<<grid, NYS_THREADS, 0, s>>>(rows, keys, vals,   \
                                                        out, NR, NK,        \
                                                        nsplit);            \
    return cudaGetLastError();                                              \
  }
  TCAM_NYS_CASE(3, 2)
  TCAM_NYS_CASE(5, 2)
  TCAM_NYS_CASE(8, 2)
  TCAM_NYS_CASE(3, 8)
  TCAM_NYS_CASE(5, 8)
  TCAM_NYS_CASE(8, 8)
#undef TCAM_NYS_CASE
  return cudaErrorInvalidValue;
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
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_nystrom(
      static_cast<const float*>(fm), static_cast<const float*>(feats),
      static_cast<const float*>(vals), part, B, M, P, D, K, nsplit, s);
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
  return launch_nystrom(
      static_cast<const float*>(feats), static_cast<const float*>(fm),
      static_cast<const float*>(alpha), static_cast<float*>(out), B, P, M, D,
      K, 1, static_cast<cudaStream_t>(stream));
}
