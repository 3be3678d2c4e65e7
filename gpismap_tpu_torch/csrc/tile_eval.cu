// Cluster-GP tile evaluation of the map query (2D and 3D), for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpismap_tpu/ops/pallas_tile.py
// (tile_eval_pallas, body _make_kernel). For each tile of T queries that
// share one cluster cell s it computes, in fp32:
//   K*  [MP, T(1+D)]   masked Matern-3/2 cross-covariance with first and
//                      second derivatives (rows: f, g_0 .. g_{D-1} blocks
//                      of M support nodes; columns: the same blocks of
//                      queries)
//   f, g               = alpha_s^T K*
//   vf, vg             = const - colsum((L^-1_s K*)^2)
// with D = 2 or 3 and MP = M(1+D). Tiles whose segment is -1 (static
// padding of the plan) are skipped and their outputs are left unwritten.
//
// What bounds it on the H100: the variance product L^-1 K* is
// MP*MP*T(1+D) multiply-adds per tile (113 M at MP=384, T=256 in 2D;
// 839 M at MP=1280, T=128 in 3D), all fp32 outside the tensor cores, so
// the kernel is bound by fp32 FMA issue and by the shared-memory reads
// feeding it. Neither K* of a whole tile ([384, 768] = 1.18 MB in 2D,
// [1280, 512] = 2.6 MB in 3D) nor one cell's L^-1 (576 KiB, 6.55 MB) fits
// in the 227 KB a block may use; the Pallas kernel held both in VMEM and
// row-panelled L^-1 at MP > 512.
//
// Design: one block per (tile, chunk of QC queries). The block builds its
// NC = QC(1+D) columns of K* once into shared memory, then streams L^-1 in
// [BI x 32] stages from global memory. QC is chosen per D so that K*
// fits: 32 queries in 2D (147 KB at MP=384), 8 in 3D (164 KB at
// MP=1280). A cell's L^-1 is re-read by each chunk of each of its tiles;
// the chunks of one tile are consecutive blocks, so they run together and
// share it through the 50 MB L2 (its hit rate is not measured). L^-1 is
// lower triangular, so the stages right of the diagonal block are skipped.
// Each thread holds an RPT-row by CPT-column register tile of L^-1 K* and
// accumulates the squares of its finished rows in registers; a
// shared-memory reduction over the TY row groups gives the column sums.
// No TF32: the variance is a cancellation (const - sum), and its error
// would flip the var_thre blend (gpismap_tpu/models/cluster.py:1086-1109).
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;               // L^-1 columns per shared-memory stage
constexpr int NTHREADS = 256;
constexpr float SQRT3 = 1.7320508075688772f;

// Per-dimension blocking: QC queries per block, BI L^-1 rows per row
// block, TX threads across the NC columns (the other NTHREADS / TX across
// rows).
template <int D> struct Cfg;
template <> struct Cfg<2> {
  static constexpr int QC = 32, BI = 64, TX = 16;
};
template <> struct Cfg<3> {
  static constexpr int QC = 8, BI = 128, TX = 8;
};

template <int D> struct Blk {
  static constexpr int QC = Cfg<D>::QC;
  static constexpr int NC = QC * (1 + D);     // K* columns per block
  static constexpr int BI = Cfg<D>::BI;
  static constexpr int TX = Cfg<D>::TX;
  static constexpr int TY = NTHREADS / TX;
  static constexpr int RPT = BI / TY;         // rows per thread (4)
  static constexpr int CPT = NC / TX;         // columns per thread (6 / 4)
  static constexpr int G = NTHREADS / NC;     // row groups of the mean
  static_assert(RPT * TY == BI && CPT * TX == NC && G <= TY, "blocking");
};

template <int D>
__host__ __device__ inline int mp_padded(int mp) {
  return (mp + Blk<D>::BI - 1) / Blk<D>::BI * Blk<D>::BI;
}

template <int D>
__host__ inline size_t smem_bytes(int m) {
  using B = Blk<D>;
  return sizeof(float) * ((size_t)mp_padded<D>(m * (1 + D)) * B::NC +
                          B::BI * (BK + 1) + B::TY * B::NC);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
tile_eval_kernel(const int* __restrict__ tile_seg,
                 const float* __restrict__ linv,
                 const float* __restrict__ xt,
                 const float* __restrict__ alpha,
                 const float* __restrict__ gradflag,
                 const float* __restrict__ valid,
                 const float* __restrict__ qt,
                 float* __restrict__ f_out, float* __restrict__ g_out,
                 float* __restrict__ vf_out, float* __restrict__ vg_out,
                 int n_seg, int m, int t, float scale, float val_const,
                 float grad_const) {
  using B = Blk<D>;
  constexpr int QC = B::QC, NC = B::NC, BI = B::BI, TX = B::TX, TY = B::TY;
  constexpr int RPT = B::RPT, CPT = B::CPT, G = B::G;
  // the chunks of one tile are consecutive blocks (they share its L^-1)
  const int n_chunk = (t + QC - 1) / QC;
  const int tile = blockIdx.x / n_chunk;
  const int seg = tile_seg[tile];
  if (seg < 0 || seg >= n_seg) return;          // inactive tile
  const int q0 = (blockIdx.x % n_chunk) * QC;
  const int mp = m * (1 + D);
  const int mpp = mp_padded<D>(mp);

  extern __shared__ float smem[];
  float* ks = smem;                             // [mpp][NC]
  float* ls = ks + (size_t)mpp * NC;            // [BI][BK + 1]
  float* red = ls + BI * (BK + 1);              // [TY][NC]
  const int tid = threadIdx.x;

  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const float* xs = xt + (size_t)seg * D * m;
  const float* qs = qt + (size_t)tile * D * t;
  const float* gfs = gradflag + (size_t)seg * m;
  const float* vls = valid + (size_t)seg * m;
  const float* al = alpha + (size_t)seg * mp;
  const float* L = linv + (size_t)seg * mp * mp;

  // ---- 1. K* columns of this block's queries (pallas_tile.py:59-82) ----
  for (int p = tid; p < m * QC; p += NTHREADS) {
    const int k = p / QC, j = p % QC, qj = q0 + j;
    float vm = 0.f, gm = 0.f, dd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) dd[i] = 0.f;
    if (qj < t) {
      vm = vls[k];
      gm = gfs[k] * vm;
#pragma unroll
      for (int i = 0; i < D; ++i) dd[i] = xs[i * m + k] - qs[i * t + qj];
    }
    float r2 = dd[0] * dd[0];
#pragma unroll
    for (int i = 1; i < D; ++i) r2 += dd[i] * dd[i];
    const float r = sqrtf(r2);
    const float e = expf(-a * r);
    const float kf = (1.f + a * r) * e;
    const float inv_r = r > 0.f ? 1.f / r : 0.f;
    float* rf = ks + (size_t)k * NC;
    rf[j] = kf * vm;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float k1 = a2 * dd[i] * e;
      rf[QC * (1 + i) + j] = k1 * vm;
      float* rg = ks + (size_t)((1 + i) * m + k) * NC;
      rg[j] = -k1 * gm;
#pragma unroll
      for (int c = 0; c < D; ++c)
        rg[QC * (1 + c) + j] =
            a2 * ((i == c ? 1.f : 0.f) - a * dd[i] * dd[c] * inv_r) * e * gm;
    }
  }
  for (int p = mp * NC + tid; p < mpp * NC; p += NTHREADS) ks[p] = 0.f;
  __syncthreads();

  // ---- 2. mean and gradient: alpha^T K* (pallas_tile.py:85-91), the
  // rows split over G groups of NC threads ----
  if (tid < G * NC) {
    const int c = tid % NC;
    float acc = 0.f;
    for (int k = tid / NC; k < mp; k += G)
      acc = fmaf(al[k], ks[(size_t)k * NC + c], acc);
    red[tid] = acc;
  }
  __syncthreads();
  if (tid < NC) {
    float acc = 0.f;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) acc += red[gi * NC + tid];
    const int blk = tid / QC, qj = q0 + tid % QC;
    if (qj < t) {
      if (blk == 0) f_out[(size_t)tile * t + qj] = acc;
      else g_out[((size_t)tile * D + blk - 1) * t + qj] = acc;
    }
  }
  // red is next written after the stage loop below, whose first
  // __syncthreads() orders these reads before it

  // ---- 3. variance: colsum((L^-1 K*)^2) over the lower triangle ----
  const int tx = tid % TX, ty = tid / TX;
  float sq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) sq[c] = 0.f;
  for (int i0 = 0; i0 < mp; i0 += BI) {
    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
    const int kend = min(i0 + BI, mp);          // L^-1[i, k] = 0 for k > i
    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();                          // previous stage consumed
      for (int p = tid; p < BI * BK; p += NTHREADS) {
        const int r = p / BK, kk = p % BK, i = i0 + r, k = k0 + kk;
        ls[r * (BK + 1) + kk] =
            (i < mp && k < mp) ? L[(size_t)i * mp + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float b[CPT], av[RPT];
        const float* krow = ks + (size_t)(k0 + kk) * NC + tx;
#pragma unroll
        for (int c = 0; c < CPT; ++c) b[c] = krow[TX * c];
#pragma unroll
        for (int r = 0; r < RPT; ++r) av[r] = ls[(ty * RPT + r) * (BK + 1) + kk];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av[r], b[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sq[c] = fmaf(acc[r][c], acc[r][c], sq[c]);
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) red[ty * NC + tx + TX * c] = sq[c];
  __syncthreads();
  for (int c = tid; c < NC; c += NTHREADS) {
    float s = 0.f;
    for (int y = 0; y < TY; ++y) s += red[y * NC + c];
    const int blk = c / QC, qj = q0 + c % QC;
    if (qj < t) {
      if (blk == 0) vf_out[(size_t)tile * t + qj] = val_const - s;
      else vg_out[((size_t)tile * D + blk - 1) * t + qj] = grad_const - s;
    }
  }
}

template <int D>
int launch(const int* tile_seg, const float* linv, const float* xt,
           const float* alpha, const float* gradflag, const float* valid,
           const float* qt, float* f_out, float* g_out, float* vf_out,
           float* vg_out, int nt, int n_seg, int m, int t, float scale,
           float val_const, float grad_const, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(m);
  cudaError_t err = cudaFuncSetAttribute(
      tile_eval_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (long long)nt * ((t + Blk<D>::QC - 1) / Blk<D>::QC);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tile_eval_kernel<D><<<(unsigned)n_blocks, NTHREADS, smem, stream>>>(
      tile_seg, linv, xt, alpha, gradflag, valid, qt, f_out, g_out, vf_out,
      vg_out, n_seg, m, t, scale, val_const, grad_const);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs at dimension d and support size m (bytes;
// 0 for a d the kernel does not take).
long long tile_eval_smem_bytes(int d, int m) {
  if (d == 2) return (long long)smem_bytes<2>(m);
  if (d == 3) return (long long)smem_bytes<3>(m);
  return 0;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a d other than 2 or 3.
int tile_eval_launch(const int* tile_seg, const float* linv, const float* xt,
                     const float* alpha, const float* gradflag,
                     const float* valid, const float* qt, float* f_out,
                     float* g_out, float* vf_out, float* vg_out, int nt,
                     int n_seg, int d, int m, int t, float scale,
                     float val_const, float grad_const, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch<2>(tile_seg, linv, xt, alpha, gradflag, valid, qt, f_out,
                     g_out, vf_out, vg_out, nt, n_seg, m, t, scale, val_const,
                     grad_const, s);
  if (d == 3)
    return launch<3>(tile_seg, linv, xt, alpha, gradflag, valid, qt, f_out,
                     g_out, vf_out, vg_out, nt, n_seg, m, t, scale, val_const,
                     grad_const, s);
  return (int)cudaErrorInvalidValue;
}

const char* tile_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
