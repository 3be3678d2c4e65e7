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
// What bounds it on the H100: the variance product L^-1 K* over L^-1's
// lower triangle, all fp32 outside the tensor cores: the fp32 FMA rate (67
// TFLOP/s), with every FMA's operand fed from shared memory. The kernel
// runs MP(MP+1)/2 multiply-adds per K* column; the function needs fewer,
// n(n+1)/2 for the n support rows the masks keep (valid for the f rows,
// gradflag * valid for the gradient rows): a masked row of K* is zero and
// its row and column of L^-1 are the identity's. Neither K* of a tile
// (2.6 MB in 3D) nor a cell's L^-1 (6.55 MB) fits in the 227 KB a block
// may use, so L^-1 streams from global memory; read once per cell it is
// 0.20 GB in 3D, so it must come through the 50 MB L2 rather than from
// HBM once per block.
//
// Design: one block of 256 threads per (tile, column block of BN = 128 K*
// columns), the column blocks of a tile consecutive (blockIdx.x = tile *
// n_cb + cb), and the plan puts the tiles of a cell next to each other, so
// the blocks that read one cell's L^-1 run together and share it through
// L2 (4 blocks per tile in 3D, 6 in 2D). Column c of the tile is
// derivative block c / T and query c % T; a column block may straddle two
// derivative blocks.
//   - The block copies its cell's inputs (xt, valid, gradflag * valid,
//     alpha) and its columns' query coordinates into shared memory. K* is
//     never stored: each [BK = 16 x 128] stage is computed on chip from
//     its (support node, query) pairs, one sqrtf and one expf per entry.
//   - Variance: for each row panel of BM = 128 rows of L^-1, k-stages of
//     16 up to the panel's diagonal (L^-1 is lower triangular with exact
//     zeros above, csrc/chol.cu). A stage of L^-1 is loaded as float4
//     into registers one stage ahead and stored transposed into a
//     double-buffered [BK][BM + 4] array beside the K* stage: one
//     __syncthreads per stage. Each thread holds an 8x8 accumulator, two
//     4-wide strips of rows (4 ty, 64 + 4 ty) by two of columns (4 tx,
//     64 + 4 tx), so its shared-memory reads are float4 without bank
//     conflicts and each float read feeds 4 FMAs. At the end of a panel it
//     adds the squares into 8 column partials in registers.
//   - Mean: the last row panel's k-stages cover all MP rows, so while it
//     runs each thread also sums alpha[r] K*[r, c] over its 8 rows of a
//     stage and adds that into its own shared-memory slot: two partials
//     per column (the two 8-row halves of a stage), each a chain of
//     MP / 16 stage sums.
//   - The 16 thread rows' variance partials and the two mean partials are
//     summed through shared memory in a fixed order: each output has one
//     writer, no atomics, so a tile's outputs are bitwise the same in any
//     batch.
// Shared memory: 35.3 KB (2D) or 35.8 KB (3D) of stages, mean partials
// and queries plus the cell inputs, (2D + 3) M floats: 38.9 KB at M=128
// in 2D, 47.4 KB at M=320 in 3D. __launch_bounds__(256, 2) keeps a thread at 128
// registers or fewer, so two blocks share an SM.
// No TF32 and no wgmma: the variance is a cancellation (const - sum), and
// TF32 error would flip the var_thre blend
// (gpismap_tpu/models/cluster.py:1086-1109).
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BM = 128;              // L^-1 rows per row panel
constexpr int BN = 128;              // K* columns per block
constexpr int BK = 16;               // k per stage
constexpr int LDL = BM + 4;          // row of a transposed L^-1 stage
constexpr int STAGE_L = BK * LDL;    // floats of one L^-1 stage
constexpr int STAGE_K = BK * BN;     // floats of one K* stage
constexpr int KROWS = BK * BN / NTHREADS;   // K* entries per thread, stage
constexpr float SQRT3 = 1.7320508075688772f;
static_assert(NTHREADS == (BM / 8) * (BN / 8), "8x8 accumulator per thread");
static_assert(NTHREADS == 2 * BN && KROWS == 8, "K* stage: 8 rows x 1 column");
static_assert(BM * BK == 8 * NTHREADS, "L^-1 stage: two float4 per thread");
static_assert(16 * BN <= 2 * STAGE_L, "epilogue partials fit the L stages");

template <int D>
__host__ inline size_t smem_bytes(int m) {
  return sizeof(float) * (2 * (size_t)STAGE_L + 2 * STAGE_K + NTHREADS +
                          D * BN +
                          (size_t)(D + 2) * m + (size_t)(1 + D) * m);
}

// K*[r][c] for support row r < MP (row block rb = r / m, node k = r % m)
// and a column of derivative block cblk in 0..D whose query is q, as
// gpismap_tpu/ops/pallas_tile.py:59-82 builds it: row block 0 masked by
// valid, the gradient blocks by gradflag * valid.
template <int D>
__device__ __forceinline__ float kstar(int rb, int k, int cblk,
                                       const float (&q)[D], const float* xsm,
                                       const float* vms, const float* gms,
                                       int m, float a, float a2) {
  float dd[D];
#pragma unroll
  for (int i = 0; i < D; ++i) dd[i] = xsm[i * m + k] - q[i];
  float r2 = dd[0] * dd[0];
#pragma unroll
  for (int i = 1; i < D; ++i) r2 += dd[i] * dd[i];
  const float r = sqrtf(r2);
  const float e = expf(-a * r);
  float dr = 0.f, dc = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (rb == 1 + i) dr = dd[i];
    if (cblk == 1 + i) dc = dd[i];
  }
  if (rb == 0) {
    const float vm = vms[k];
    return cblk == 0 ? (1.f + a * r) * e * vm : a2 * dc * e * vm;
  }
  const float gm = gms[k];
  if (cblk == 0) return -(a2 * dr * e) * gm;
  const float inv_r = r > 0.f ? 1.f / r : 0.f;
  return a2 * ((rb == cblk ? 1.f : 0.f) - a * dr * dc * inv_r) * e * gm;
}

// This thread's 8 elements of the L^-1 stage (rows i0.., columns k0..):
// rows i0 + tid / 4 and i0 + 64 + tid / 4, columns k0 + 4 (tid % 4) + j.
// Rows and columns at or past mp read as zeros.
__device__ __forceinline__ void load_l(const float* __restrict__ L, int mp,
                                       bool vec, int i0, int k0,
                                       float (&pr)[8]) {
  const int kc = k0 + 4 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + (threadIdx.x >> 2) + 64 * h;
    const float* row = L + (size_t)i * mp + kc;
    if (vec) {                          // mp % 4 == 0: kc < mp covers kc + 3
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < mp && kc < mp) v = *reinterpret_cast<const float4*>(row);
      pr[4 * h] = v.x;
      pr[4 * h + 1] = v.y;
      pr[4 * h + 2] = v.z;
      pr[4 * h + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pr[4 * h + j] = i < mp && kc + j < mp ? row[j] : 0.f;
    }
  }
}

// ls [BK][LDL] <- the stage in pr, transposed: ls[k][row].
__device__ __forceinline__ void store_l(const float (&pr)[8], float* ls) {
  const int kc = 4 * (threadIdx.x & 3), r = threadIdx.x >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ls[(kc + j) * LDL + r + 64 * h] = pr[4 * h + j];
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
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
  const int nc = t * (1 + D);                   // K* columns of a tile
  const int n_cb = (nc + BN - 1) / BN;
  const int tile = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  const int seg = tile_seg[tile];
  if (seg < 0 || seg >= n_seg) return;          // inactive tile
  const int mp = m * (1 + D);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* ls = smem;                             // [2][BK][LDL]
  float* ks = ls + 2 * STAGE_L;                 // [2][BK][BN]
  float* msm = ks + 2 * STAGE_K;                // [NTHREADS] mean partials
  float* qsm = msm + NTHREADS;                  // [D][BN]
  float* xsm = qsm + D * BN;                    // [D][m]
  float* vms = xsm + D * m;                     // [m] valid
  float* gms = vms + m;                         // [m] gradflag * valid
  float* als = gms + m;                         // [mp] alpha

  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const float* L = linv + (size_t)seg * mp * mp;

  // ---- the cell's inputs and this block's queries ----
  {
    const float* xs = xt + (size_t)seg * D * m;
    const float* gfs = gradflag + (size_t)seg * m;
    const float* vls = valid + (size_t)seg * m;
    const float* al = alpha + (size_t)seg * mp;
    const float* qs = qt + (size_t)tile * D * t;
    for (int p = tid; p < D * m; p += NTHREADS) xsm[p] = xs[p];
    for (int p = tid; p < m; p += NTHREADS) {
      vms[p] = vls[p];
      gms[p] = gfs[p] * vls[p];
    }
    for (int p = tid; p < mp; p += NTHREADS) als[p] = al[p];
    msm[tid] = 0.f;
    for (int p = tid; p < D * BN; p += NTHREADS) {
      const int i = p / BN, gc = cb * BN + p % BN;
      qsm[p] = gc < nc ? qs[i * t + gc % t] : 0.f;
    }
  }
  // this thread's K* column: derivative block cblk (-1 past the tile's
  // columns); it computes rows kr0 .. kr0 + 7 of each K* stage
  const int col = tid & (BN - 1);
  const int gcol = cb * BN + col;
  const int cblk = gcol < nc ? gcol / t : -1;
  const int kr0 = (tid >> 7) * KROWS;
  __syncthreads();

  // ---- variance colsum((L^-1 K*)^2) over the lower triangle, and the
  // mean alpha^T K* (pallas_tile.py:85-91) from the last row panel's
  // stages, which cover every row ----
  // ks[buf] [BK][BN] <- rows k0 + kr0 .. + 7 of K* at this thread's column;
  // with `mean`, their alpha-weighted sum is added to msm[tid]
  auto compute_k = [&](int k0, float* kst, bool mean) {
    float q[D];
#pragma unroll
    for (int i = 0; i < D; ++i) q[i] = qsm[i * BN + col];
    const int r0 = k0 + kr0;
    int rb = r0 / m, k = r0 - rb * m;
    float ms = 0.f;
#pragma unroll
    for (int i = 0; i < KROWS; ++i) {
      float v = 0.f;
      if (cblk >= 0 && r0 + i < mp) {
        v = kstar<D>(rb, k, cblk, q, xsm, vms, gms, m, a, a2);
        if (mean) ms = fmaf(als[r0 + i], v, ms);
      }
      kst[(kr0 + i) * BN + col] = v;
      if (++k == m) {
        k = 0;
        ++rb;
      }
    }
    if (mean) msm[tid] += ms;
  };
  const int last_i0 = (mp - 1) / BM * BM;
  const bool vec = (mp & 3) == 0 && ((size_t)linv & 15) == 0;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8], sq[8], pr[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    sq[u] = 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  }
  int i0 = 0, k0 = 0, buf = 0;
  load_l(L, mp, vec, i0, k0, pr);
  store_l(pr, ls);
  compute_k(k0, ks, i0 == last_i0);
  for (;;) {
    // the next stage: k0 + BK in this panel, or the next panel's first
    int ni0 = i0, nk0 = k0 + BK;
    if (nk0 >= min(i0 + BM, mp)) {               // L^-1[i, k] = 0 for k > i
      ni0 += BM;
      nk0 = 0;
    }
    const bool more = ni0 < mp;
    __syncthreads();                             // stage buf is written
    if (more) load_l(L, mp, vec, ni0, nk0, pr);  // in flight over the FMAs
    const float* lsb = ls + buf * STAGE_L;
    const float* ksb = ks + buf * STAGE_K;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* la = lsb + kk * LDL + 4 * ty;
      const float* kb = ksb + kk * BN + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(la);
      const float4 a1 = *reinterpret_cast<const float4*>(la + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(kb);
      const float4 b1 = *reinterpret_cast<const float4*>(kb + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    if (nk0 == 0) {                              // the panel is finished
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          sq[v] = fmaf(acc[u][v], acc[u][v], sq[v]);
          acc[u][v] = 0.f;
        }
    }
    if (!more) break;
    // the other buffer was last read before this iteration's barrier
    store_l(pr, ls + (buf ^ 1) * STAGE_L);
    compute_k(nk0, ks + (buf ^ 1) * STAGE_K, ni0 == last_i0);
    buf ^= 1;
    i0 = ni0;
    k0 = nk0;
  }

  // ---- the 16 thread rows' column partials and the two mean halves,
  // summed in a fixed order ----
  __syncthreads();                               // the last stage is read
  float* red = ls;                               // [16][BN]
  *reinterpret_cast<float4*>(red + ty * BN + 4 * tx) =
      make_float4(sq[0], sq[1], sq[2], sq[3]);
  *reinterpret_cast<float4*>(red + ty * BN + 64 + 4 * tx) =
      make_float4(sq[4], sq[5], sq[6], sq[7]);
  __syncthreads();
  if (tid < BN && cblk >= 0) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < 16; ++y) s += red[y * BN + tid];
    const float mean = msm[tid] + msm[BN + tid];
    const int qj = gcol % t;
    if (cblk == 0) {
      f_out[(size_t)tile * t + qj] = mean;
      vf_out[(size_t)tile * t + qj] = val_const - s;
    } else {
      g_out[((size_t)tile * D + cblk - 1) * t + qj] = mean;
      vg_out[((size_t)tile * D + cblk - 1) * t + qj] = grad_const - s;
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
  const long long n_cb = ((long long)t * (1 + D) + BN - 1) / BN;
  const long long n_blocks = (long long)nt * n_cb;
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
