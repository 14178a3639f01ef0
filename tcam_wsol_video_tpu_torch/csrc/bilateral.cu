// Exact dense bilateral (Gaussian-attention) filter for Hopper (sm_90a).
//
//   out[b, i, :] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) * v[b, j, :]
//
// Replaces the TPU kernel gaussian_filter_apply_pallas_batched
// (tcam_wsol_video_tpu/ops/pallas/bilateral.py:159, body
// _kernel_batched_sym) and, as its B = 1 case, gaussian_filter_apply_pallas
// (bilateral.py:210).
//
// Bound.  The weight is symmetric, so the function needs per unordered
// pair one MUFU ex2 (16 / clk / SM), D FMAs, an add and a min, and 2K FMAs
// (W v both ways): B P (P + 1) / 2 = 4.0e10 pairs at the recipe's shapes
// (B = 32, P = 224^2, D = 5, K = 2) give ~12 ms on the FP32 pipe and
// ~9.6 ms of ex2; bytes are ~58 MB (0.02 ms).  It is bound by operations.
// The inner loop issues about 12.75 instructions per pair (9 FFMA, an
// FADD, an FMNMX, the MUFU, and loads and loop control), so the kernel is
// bound by instruction issue rather than by one pipe.
//
// Design.
// 1. Each unordered tile pair once.  Pixels are cut into n = ceil(P / TILE)
//    tiles.  Row tile I owns the offsets o of a circulant schedule, pairing
//    it with J = (I + o) mod n: o = 0 (the diagonal tile, row direction
//    only), o = 1 .. (n - 1) / 2, and o = n / 2 when n is even and
//    I < n / 2.  For o > 0 a block computes W_IJ once and adds W v_J into
//    I's rows and W^T v_I into J's columns.  Every unordered pair is
//    covered once; every row tile does (n + 1) / 2 tile pairs or one fewer.
//    A row tile's offsets are split over `nsplit` blocks when B n alone
//    would not fill the card (B = 1); grid (n nsplit, B).
// 2. Register micro-tiles.  Each thread holds R query rows (features
//    pre-scaled by -2c, the c||f||^2 term, values, row sums) for the whole
//    strip, and takes the tile's key columns C at a time from shared memory
//    (broadcast float4 loads, NF / 4 per column for R pairs).  A warp owns
//    32 R rows by a slice of the columns; its lanes write each chunk's
//    column sums to a per-warp shared buffer, and after BATCH columns the
//    threads of the column group add them over the group's lanes in order.
//    At K = 2 (R = 8, C = 2) a thread needs 128 registers, so two blocks
//    (16 warps) share an SM, which hides latency better than one block of
//    8 warps.  The next key tile is loaded into registers while the
//    current one is computed (double-buffered shared memory, one barrier
//    per tile).
// 3. Deterministic, no atomics.  Block (I, s) writes its row sums to
//    scratch slot s and the column sums of pair (I, I + o) to slot
//    nsplit + o - 1, at the columns' pixels: every slot entry is written at
//    most once.  bilateral_reduce_kernel adds, per output, the nsplit row
//    slots and then the column slots in offset order.  Two launches on the
//    same inputs give bit-equal results.  Scratch: (B, nsplit + n / 2, P,
//    K) fp32, allocated by the wrapper (1.27 GB at the recipe's shapes).
//
// A call issues two launches (the pair kernel and the reduction) per batch
// chunk; the wrapper chunks B to keep the scratch under its cap.
//
// Numerics.  The wrapper centres the features per image.  The distance
// uses the centred norm expansion in full fp32 on CUDA cores (never TF32:
// the cancellation in ||f_i||^2 + ||f_j||^2 - 2 f_i.f_j needs fp32), folded
// into the base-2 exponent:
//   e = c ||f_i||^2 + c ||f_j||^2 + sum_d (-2 c f_i[d]) f_j[d],  c = -log2(e)/2
//   w = 2^min(e, 0)                       (min(e, 0) is max(d2, 0))
// Pixels past P get c ||f||^2 = -inf and zero values on both sides, so the
// ragged edge is masked in the kernel: w = 2^-inf = 0.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 256;     // pixels per tile (rows and columns)
constexpr int THREADS = 256;  // one key column of a tile staged per thread
constexpr int WARPS = THREADS / 32;
constexpr int RED_W = 64;     // column sums per lane per reduction round
constexpr int RED_STRIDE = RED_W + 4;  // padded: conflict-free float4 stores
constexpr float C_EXP2 = -0.72134752044448170368f;  // -log2(e) / 2

static_assert(TILE == THREADS, "staging takes one key column per thread");

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int round4(int n) { return ((n + 3) / 4) * 4; }

__host__ __device__ inline int n_tiles(int P) { return (P + TILE - 1) / TILE; }

// Offsets 0 .. row_offsets(I) - 1 belong to row tile I (see the design).
__device__ __forceinline__ int row_offsets(int I, int n) {
  return 1 + (n - 1) / 2 + ((n % 2 == 0 && I < n / 2) ? 1 : 0);
}

// Column slots that hold partial sums for column tile J: offsets
// 1 .. (n - 1) / 2, and n / 2 when n is even and J >= n / 2.
__device__ __forceinline__ int column_slots(int J, int n) {
  return (n - 1) / 2 + ((n % 2 == 0 && J >= n / 2) ? 1 : 0);
}

template <int D, int K>
struct Cfg {
  static constexpr int R = K <= 2 ? 8 : 4;  // query rows per thread
  static constexpr int C = 2;               // key columns per register chunk
  // K = 2 fits 128 registers: two blocks (16 warps) per SM
  static constexpr int MIN_BLOCKS = K <= 2 ? 2 : 1;
  // shared row of a key column: f (D), c||f||^2, v (K), padded to float4s
  static constexpr int NF = round4(D + 1 + K);
  static constexpr int ROW_WARPS = TILE / (32 * R);     // 1 or 2
  static constexpr int COL_GROUPS = WARPS / ROW_WARPS;  // 8 or 4
  static constexpr int WARP_COLS = TILE / COL_GROUPS;   // 32 or 64
  static constexpr int BATCH = RED_W / K;  // columns per reduction round
  // column sums each thread of a column group adds up per round
  static constexpr int PER_THREAD = RED_W / (32 * ROW_WARPS);
  static constexpr int SMEM_FLOATS = 2 * TILE * NF + WARPS * 32 * RED_STRIDE;
  static_assert(WARP_COLS % BATCH == 0 && BATCH % C == 0, "column split");
  static_assert((C * K) % 4 == 0, "column sums leave as float4s");
  static_assert(COL_GROUPS * TILE * K <= WARPS * 32 * RED_STRIDE,
                "row reduction fits the column buffer");
};

// Barrier of the warps that share a column group: the warp itself, or (two
// row warps) the whole block, every warp taking the same number of rounds.
template <int ROW_WARPS>
__device__ __forceinline__ void group_sync() {
  if constexpr (ROW_WARPS == 1)
    __syncwarp();
  else
    __syncthreads();
}

// Loads key pixel j's features and values (zeros past P); true if j < P.
template <int D, int K>
__device__ __forceinline__ bool fetch_column(const float* fb, const float* vb,
                                             int P, int j, float (&pf)[D],
                                             float (&pv)[K]) {
  const bool in = j < P;
#pragma unroll
  for (int d = 0; d < D; ++d)
    pf[d] = in ? fb[static_cast<size_t>(j) * D + d] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    pv[k] = in ? vb[static_cast<size_t>(j) * K + k] : 0.f;
  return in;
}

// Writes one key column's shared row: f, c||f||^2 (-inf past P), v, zeros.
template <int D, int K, int NF>
__device__ __forceinline__ void stage_column(float* sf, bool in,
                                             const float (&pf)[D],
                                             const float (&pv)[K]) {
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sq = fmaf(pf[d], pf[d], sq);
    sf[d] = pf[d];
  }
  sf[D] = in ? C_EXP2 * sq : -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k) sf[D + 1 + k] = pv[k];
#pragma unroll
  for (int d = D + 1 + K; d < NF; ++d) sf[d] = 0.f;
}

// C key columns' shared rows into registers (broadcast float4 loads).
template <int C, int NF>
__device__ __forceinline__ void load_keys(const float* cols,
                                          float (&kj)[C][NF]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int u = 0; u < NF / 4; ++u) {
      const float4 t = reinterpret_cast<const float4*>(cols + c * NF)[u];
      kj[c][4 * u] = t.x;
      kj[c][4 * u + 1] = t.y;
      kj[c][4 * u + 2] = t.z;
      kj[c][4 * u + 3] = t.w;
    }
}

// w = 2^min(e, 0), e = c||f_i||^2 + c||f_j||^2 + sum_d (-2 c f_i[d]) f_j[d]
template <int D, int NF>
__device__ __forceinline__ float weight(const float (&h)[D], float q,
                                        const float (&kj)[NF]) {
  float e = q + kj[D];
#pragma unroll
  for (int d = 0; d < D; ++d) e = fmaf(h[d], kj[d], e);
  return ex2_approx(fminf(e, 0.f));
}

template <int D, int K>
__global__ void __launch_bounds__(THREADS, Cfg<D, K>::MIN_BLOCKS)
bilateral_pairs_kernel(const float* __restrict__ feats,
                       const float* __restrict__ vals,
                       float* __restrict__ scratch, int P, int nsplit) {
  using G = Cfg<D, K>;
  constexpr int R = G::R;
  constexpr int C = G::C;
  constexpr int NF = G::NF;
  extern __shared__ __align__(16) float smem[];
  float* s_col = smem;                     // [2][TILE][NF]
  float* s_red = smem + 2 * TILE * NF;     // [WARPS][32][RED_STRIDE]

  const int n = n_tiles(P);
  const int I = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int b = blockIdx.y;
  const int len = (1 + n / 2 + nsplit - 1) / nsplit;
  const int o0 = s * len;
  const int o1 = min(row_offsets(I, n), o0 + len);
  const size_t PK = static_cast<size_t>(P) * K;
  const float* fb = feats + static_cast<size_t>(b) * P * D;
  const float* vb = vals + static_cast<size_t>(b) * PK;
  float* sb = scratch + static_cast<size_t>(b) * (nsplit + n / 2) * PK;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % G::ROW_WARPS;
  const int row_base = rw * 32 * R + lane;
  const int cg = warp / G::ROW_WARPS;
  const int col_base = cg * G::WARP_COLS;
  float* red = s_red + warp * 32 * RED_STRIDE;
  // the column group's warps cg ROW_WARPS .. + ROW_WARPS - 1, contiguous
  const float* group_red = s_red + cg * G::ROW_WARPS * 32 * RED_STRIDE;

  // this thread's rows: row_base + 32 r of tile I
  float h[R][D];  // -2 c f_i
  float q[R];     // c ||f_i||^2, -inf past P
  float vi[R][K];
  float acc[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = I * TILE + row_base + 32 * r;
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float f = i < P ? fb[static_cast<size_t>(i) * D + d] : 0.f;
      sq = fmaf(f, f, sq);
      h[r][d] = -2.f * C_EXP2 * f;
    }
    q[r] = i < P ? C_EXP2 * sq : -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      vi[r][k] = i < P ? vb[static_cast<size_t>(i) * K + k] : 0.f;
      acc[r][k] = 0.f;
    }
  }

  // key column threadIdx.x of a tile: fetched into registers, then staged
  float pf[D];
  float pv[K];
  bool pin = false;
  if (o0 < o1) {
    pin = fetch_column<D, K>(fb, vb, P, ((I + o0) % n) * TILE + threadIdx.x,
                             pf, pv);
    stage_column<D, K, NF>(s_col + threadIdx.x * NF, pin, pf, pv);
  }
  __syncthreads();

  for (int o = o0; o < o1; ++o) {
    const int buf = (o - o0) & 1;
    const int J = (I + o) % n;
    const bool more = o + 1 < o1;
    if (more)  // in flight during the tile's work
      pin = fetch_column<D, K>(fb, vb, P,
                               ((I + o + 1) % n) * TILE + threadIdx.x, pf, pv);
    const float* cols = s_col + (buf * TILE + col_base) * NF;

    if (o == 0) {
      // the diagonal tile: every ordered pair, row direction only
#pragma unroll 1
      for (int c0 = 0; c0 < G::WARP_COLS; c0 += C) {
        float kj[C][NF];
        load_keys(cols + c0 * NF, kj);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float w = weight(h[r], q[r], kj[c]);
#pragma unroll
            for (int k = 0; k < K; ++k)
              acc[r][k] = fmaf(w, kj[c][D + 1 + k], acc[r][k]);
          }
      }
    } else {
      float* slot = sb + (nsplit + o - 1) * PK;
#pragma unroll 1
      for (int b0 = 0; b0 < G::WARP_COLS; b0 += G::BATCH) {
#pragma unroll 1
        for (int c0 = 0; c0 < G::BATCH; c0 += C) {
          float kj[C][NF];
          load_keys(cols + (b0 + c0) * NF, kj);
          float cs[C][K];
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int k = 0; k < K; ++k) cs[c][k] = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float w = weight(h[r], q[r], kj[c]);
#pragma unroll
              for (int k = 0; k < K; ++k) {
                acc[r][k] = fmaf(w, kj[c][D + 1 + k], acc[r][k]);
                cs[c][k] = fmaf(w, vi[r][k], cs[c][k]);
              }
            }
          float4* dst = reinterpret_cast<float4*>(red + lane * RED_STRIDE +
                                                  c0 * K);
#pragma unroll
          for (int u = 0; u < C * K / 4; ++u)
            dst[u] = make_float4(cs[(4 * u) / K][(4 * u) % K],
                                 cs[(4 * u + 1) / K][(4 * u + 1) % K],
                                 cs[(4 * u + 2) / K][(4 * u + 2) % K],
                                 cs[(4 * u + 3) / K][(4 * u + 3) % K]);
        }
        group_sync<G::ROW_WARPS>();
        // the column group's 32 ROW_WARPS threads each add PER_THREAD
        // entries (one column's values) over the group's lanes, in order
        const int e0 = (rw * 32 + lane) * G::PER_THREAD;
        float sum[G::PER_THREAD];
#pragma unroll
        for (int u = 0; u < G::PER_THREAD; ++u) sum[u] = 0.f;
#pragma unroll 8
        for (int src = 0; src < 32 * G::ROW_WARPS; ++src) {
          const float* x = group_red + src * RED_STRIDE + e0;
          if constexpr (G::PER_THREAD == 2) {
            const float2 t = *reinterpret_cast<const float2*>(x);
            sum[0] += t.x;
            sum[1] += t.y;
          } else {
#pragma unroll
            for (int u = 0; u < G::PER_THREAD; ++u) sum[u] += x[u];
          }
        }
        const int j0 = J * TILE + col_base + b0;
        if (j0 + e0 / K < P) {
          float* dst = slot + static_cast<size_t>(j0) * K + e0;
          if constexpr (G::PER_THREAD == 2)
            *reinterpret_cast<float2*>(dst) = make_float2(sum[0], sum[1]);
          else
#pragma unroll
            for (int u = 0; u < G::PER_THREAD; ++u) dst[u] = sum[u];
        }
        group_sync<G::ROW_WARPS>();
      }
    }
    if (more)
      stage_column<D, K, NF>(s_col + ((buf ^ 1) * TILE + threadIdx.x) * NF,
                             pin, pf, pv);
    __syncthreads();
  }

  // row sums: over the column groups in order, into row slot s
  float* s_row = s_red;  // [COL_GROUPS][TILE][K]
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k)
      s_row[(cg * TILE + row_base + 32 * r) * K + k] = acc[r][k];
  __syncthreads();
  float* rows = sb + s * PK + static_cast<size_t>(I) * TILE * K;
  for (int e = threadIdx.x; e < TILE * K; e += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < G::COL_GROUPS; ++g) sum += s_row[g * TILE * K + e];
    if (I * TILE + e / K < P) rows[e] = sum;
  }
}

// out[b, p, k] = the nsplit row slots, then the column slots of p's tile in
// offset order.  One thread per (b, p, k).
__global__ void bilateral_reduce_kernel(const float* __restrict__ scratch,
                                        float* __restrict__ out, int B, int P,
                                        int K, int nsplit) {
  const size_t PK = static_cast<size_t>(P) * K;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * PK) return;
  const size_t b = i / PK;
  const size_t e = i - b * PK;
  const int n = n_tiles(P);
  const int J = static_cast<int>(e / K) / TILE;
  const int slots = nsplit + column_slots(J, n);
  const float* src = scratch + b * (nsplit + n / 2) * PK + e;
  float acc = 0.f;
  for (int t = 0; t < slots; ++t) acc += src[t * PK];
  out[i] = acc;
}

template <int D, int K>
cudaError_t launch(const float* feats, const float* vals, float* scratch,
                   float* out, int B, int P, int nsplit, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D, K>::SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bilateral_pairs_kernel<D, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles(P) * nsplit, B);
  bilateral_pairs_kernel<D, K><<<grid, THREADS, smem, stream>>>(
      feats, vals, scratch, P, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(B) * P * K;
  const int threads = 256;
  bilateral_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                  threads),
                            threads, 0, stream>>>(scratch, out, B, P, K,
                                                  nsplit);
  return cudaGetLastError();
}

}  // namespace

// The tile the wrapper's schedule must use.
extern "C" int bilateral_exact_tile() { return TILE; }

// feats (B, P, D) centred fp32, vals (B, P, K) fp32, scratch (B, nsplit +
// n / 2, P, K) fp32 with n = ceil(P / TILE), out (B, P, K) fp32, all
// contiguous on the current device.  D in {3, 5, 8}, K in {2, 8}: the
// wrapper zero-pads other widths up to these (zero columns change neither
// distances nor sums).  Launches the pair kernel and the reduction;
// returns cudaGetLastError() after each.
extern "C" int bilateral_exact_forward(const void* feats, const void* vals,
                                       void* scratch, void* out, int B, int P,
                                       int D, int K, int nsplit,
                                       void* stream) {
  if (B <= 0 || P <= 0 || B > 65535 || nsplit < 1 ||
      static_cast<long long>(n_tiles(P)) * nsplit > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const float* v = static_cast<const float*>(vals);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TCAM_BILATERAL_CASE(DD, KK) \
  if (D == DD && K == KK) return launch<DD, KK>(f, v, sc, o, B, P, nsplit, s);
  TCAM_BILATERAL_CASE(3, 2)
  TCAM_BILATERAL_CASE(5, 2)
  TCAM_BILATERAL_CASE(8, 2)
  TCAM_BILATERAL_CASE(3, 8)
  TCAM_BILATERAL_CASE(5, 8)
  TCAM_BILATERAL_CASE(8, 8)
#undef TCAM_BILATERAL_CASE
  return cudaErrorInvalidValue;
}
