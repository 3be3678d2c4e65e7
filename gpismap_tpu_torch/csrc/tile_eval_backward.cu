// The gradient of the cluster-GP tile evaluation (2D and 3D), for NVIDIA
// Hopper (sm_90a).
//
// The JAX package has no kernel for it: its Pallas kernel
// (gpismap_tpu/ops/pallas_tile.py, tile_eval_pallas) has no VJP, and its
// render differentiates the XLA twin _ongpis_eval_tile
// (gpismap_tpu/models/cluster.py:329). These kernels compute that
// function's vector-Jacobian product on the forward kernel's blocking
// (tile_eval.cu). For an active tile t of cell s, C = T(1+D) K* columns,
// L = L^-1_s, V = L K*, gF [C] the cotangent of (f, g) and gV [C] that of
// (vf, vg), with Z = V diag(gV) and Y = L^T Z:
//   d alpha_s = sum_t K*_t gF_t,   dL_s = -2 sum_t Z_t K*_t^T,
//   dK*_t     = alpha_s gF_t^T - 2 Y_t   (on chip only, never stored),
// chained through each K* entry (kstar_grad, tile_kstar.cuh) into dq_t,
// dx_s and d a (the caller turns d a into d scale and sums the constants'
// cotangents). Three kernels, each over each cell's kept 16-row stages
// only (ops/tile_eval.py:kept_stages; packed row 16 j + i is row
// 16 stages[j] + i): a dropped stage's K* rows are zero and its rows and
// columns of L^-1 the identity's, so its rows of Z, Y and dL are exact
// zeros. In packed order L^-1 stays lower triangular.
//   tile_bwd_z_kernel      one block per (tile, 128 columns): V over
//     128-row panels of L^-1 and 16-row K* stages built on chip, as the
//     forward kernel runs it, then Z = V diag(gV) into a scratch [packed
//     rows][C] per tile. A block whose gV are all zero writes nothing.
//   tile_bwd_kstar_kernel  one block per (tile, 128 columns): for each
//     128-row panel R of Y, sum_{I >= R} (L^-1[I, R])^T Z[I] over 16-row
//     stages (skipped, Y = 0, where the block's gV are all zero), then in
//     registers dK* = alpha gF^T - 2 Y and each entry's derivatives:
//     dq of its columns written complete (one writer per column, its rows
//     summed in a fixed order), per-block partials of d alpha and dx per
//     row of MP and of d a.
//   tile_bwd_linv_kernel   one block per (cell, 128 x 128 tile of dL over
//     the packed rows): -2 sum over the cell's tiles, in the caller's
//     order, and their 16-column stages with some gV nonzero, of
//     Z[rows] K*[cols]^T, K* rebuilt on chip; one writer per entry.
// No float atomics: every output or partial has one writer and a fixed
// summation order, so the gradients are bitwise the same in two runs.
// At a coincident (node, query) pair (r = 0) the entry's derivatives in
// Delta are 0 and those in a finite (kstar_grad), where the plain
// version's sqrt backward gives NaN for xt and qt.
//
// What bounds it on the H100: fp32 FMAs (67 TFLOP/s; no TF32, no wgmma on
// fp32). Per active tile with n kept rows: V over the packed lower
// triangle (n(n+1)/2 C multiply-adds), Y the same, dL a full n x n x C
// product: 2 n^2 C, four times the forward's product, plus the entries'
// derivatives (a sqrt, an exp and a division each). L^-1 and the scratch Z
// stream through the 50 MB L2; the scratch is bounded by the caller's
// chunks of whole cells.
//
// Shared memory: kernels 2 and 4 as the forward kernel (two 16 x 128
// stages of each operand, the cell's inputs); kernel 3 also a 16 x 128 x
// (1 + D) array of row partials.
#include <cuda_runtime.h>

#include "tile_kstar.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int BM = 128;              // packed rows of a panel or dL tile
constexpr int BN = 128;              // K* columns of a block
constexpr int BK = 16;               // k per stage
constexpr int LDT = BM + 4;          // row of a transposed stage
constexpr int STAGE_T = BK * LDT;    // floats of a transposed stage
constexpr int STAGE_N = BK * BN;     // floats of a row-major stage
constexpr int SPB = BN / BK;         // 16-column stages of a column block
static_assert(BM == BN && NTHREADS == (BM / 8) * (BN / 8),
              "8x8 accumulator per thread");
static_assert(NTHREADS == 2 * BN, "K* stage: 8 entries a thread");

// row of MP of packed row p < 16 nk (it lies past MP in a ragged last
// stage)
__device__ __forceinline__ int unpack(const int* kst, int p) {
  return BK * kst[p >> 4] + (p & 15);
}

// the cell's support inputs and kept stages into shared memory
template <int D>
__device__ __forceinline__ void load_cell(int seg, int m, int ns, int nk,
                                          const float* xt,
                                          const float* gradflag,
                                          const float* valid,
                                          const int* stages, float* xsm,
                                          float* vms, float* gms, int* kst) {
  const int tid = threadIdx.x;
  const float* xs = xt + (size_t)seg * D * m;
  const float* gfs = gradflag + (size_t)seg * m;
  const float* vls = valid + (size_t)seg * m;
  for (int p = tid; p < D * m; p += NTHREADS) xsm[p] = xs[p];
  for (int p = tid; p < m; p += NTHREADS) {
    vms[p] = vls[p];
    gms[p] = gfs[p] * vls[p];
  }
  for (int p = tid; p < nk; p += NTHREADS)
    kst[p] = stages[(size_t)seg * ns + p];
}

// the block's columns cb * BN .. of tile `tile`: queries qsm [D][BN] and
// one cotangent row vsm [BN] of cot [NT][nc] (0 past the tile's columns)
template <int D>
__device__ __forceinline__ void load_cols(int tile, int cb, int t,
                                          const float* qt, const float* cot,
                                          float* qsm, float* vsm) {
  const int nc = t * (1 + D), tid = threadIdx.x;
  const float* qs = qt + (size_t)tile * D * t;
  for (int p = tid; p < D * BN; p += NTHREADS) {
    const int i = p / BN, gc = cb * BN + p % BN;
    qsm[p] = gc < nc ? qs[i * t + gc % t] : 0.f;
  }
  for (int p = tid; p < BN; p += NTHREADS) {
    const int gc = cb * BN + p;
    vsm[p] = gc < nc ? cot[(size_t)tile * nc + gc] : 0.f;
  }
}

// whether any 16-column stage of column block cb has a nonzero gV
__device__ __forceinline__ bool block_has_gv(const int* gv_nz, int tile,
                                             int cb, int nst) {
  bool any = false;
  for (int s = cb * SPB; s < min(nst, (cb + 1) * SPB); ++s)
    any |= gv_nz[(size_t)tile * nst + s] != 0;
  return any;
}

// Two float4 of a transposed-stage load: rows i0 + tid / 4 + 64 h of a
// row-major source (row p of it at src + row(p) * ld, p < np valid, and
// row(p) < lim), columns c0 + 4 (tid % 4) + j (valid below cl).
template <typename RowOf>
__device__ __forceinline__ void load_t(const float* src, size_t ld, int np,
                                       int lim, RowOf row_of, int c0,
                                       int cl, bool vec, float (&pr)[8]) {
  const int kc = c0 + 4 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = (threadIdx.x >> 2) + 64 * h;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int i = p < np ? row_of(p) : lim;
    if (i < lim) {
      const float* r = src + (size_t)i * ld + kc;
      if (vec) {                      // ld % 4 == 0: kc < cl covers kc + 3
        if (kc < cl) v = *reinterpret_cast<const float4*>(r);
      } else {
        v.x = kc < cl ? r[0] : 0.f;
        v.y = kc + 1 < cl ? r[1] : 0.f;
        v.z = kc + 2 < cl ? r[2] : 0.f;
        v.w = kc + 3 < cl ? r[3] : 0.f;
      }
    }
    pr[4 * h] = v.x;
    pr[4 * h + 1] = v.y;
    pr[4 * h + 2] = v.z;
    pr[4 * h + 3] = v.w;
  }
}

// ls [BK][LDT] <- the stage in pr, transposed: ls[k][row]
__device__ __forceinline__ void store_t(const float (&pr)[8], float* ls) {
  const int kc = 4 * (threadIdx.x & 3), r = threadIdx.x >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) ls[(kc + j) * LDT + r + 64 * h] = pr[4 * h + j];
}

// 8 floats of a row-major [BK][128] stage: row tid / 16 (valid if its
// source row is below lim), columns 8 (tid % 16) + j of a source row that
// starts at column c0 (valid below cl)
__device__ __forceinline__ void load_n(const float* row, int lim_ok, int c0,
                                       int cl, bool vec, float (&pr)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 4 * h;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lim_ok) {
      if (vec) {                      // the row's start and cl are 4-aligned
        if (c < cl) v = *reinterpret_cast<const float4*>(row + c);
      } else {
        v.x = c < cl ? row[c] : 0.f;
        v.y = c + 1 < cl ? row[c + 1] : 0.f;
        v.z = c + 2 < cl ? row[c + 2] : 0.f;
        v.w = c + 3 < cl ? row[c + 3] : 0.f;
      }
    }
    pr[4 * h] = v.x;
    pr[4 * h + 1] = v.y;
    pr[4 * h + 2] = v.z;
    pr[4 * h + 3] = v.w;
  }
}

__device__ __forceinline__ void store_n(const float (&pr)[8], float* st) {
  float* d = st + (threadIdx.x >> 4) * BN + 8 * (threadIdx.x & 15);
  *reinterpret_cast<float4*>(d) = make_float4(pr[0], pr[1], pr[2], pr[3]);
  *reinterpret_cast<float4*>(d + 4) = make_float4(pr[4], pr[5], pr[6], pr[7]);
}

// acc[u][v] += sum_k a[k][row u] b[k][col v] over one stage: a [BK][lda]
// at rows 4 ty.., 64 + 4 ty..; b [BK][ldb] at columns 4 tx.., 64 + 4 tx..
__device__ __forceinline__ void fma_stage(const float* as, int lda,
                                          const float* bs, int ldb,
                                          float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float* la = as + kk * lda + 4 * ty;
    const float* kb = bs + kk * ldb + 4 * tx;
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
}

// the accumulator's row (u) and column (v) within the 128 x 128 tile
__device__ __forceinline__ int acc_row(int u) {
  return 4 * (threadIdx.x >> 4) + (u & 3) + 64 * (u >> 2);
}
__device__ __forceinline__ int acc_col(int v) {
  return 4 * (threadIdx.x & 15) + (v & 3) + 64 * (v >> 2);
}

template <int D>
__host__ inline size_t smem_z(int m, int mp) {
  const int ns = (mp + BK - 1) / BK;
  return sizeof(float) * (2 * (size_t)STAGE_T + 2 * STAGE_N + D * BN + BN +
                          (size_t)(D + 2) * m) +
         sizeof(int) * (size_t)ns;
}

template <int D>
__host__ inline size_t smem_kstar(int m, int mp) {
  const int ns = (mp + BK - 1) / BK;
  return sizeof(float) * (4 * (size_t)STAGE_N + 16 * BM * (1 + D) +
                          NTHREADS + D * BN + BN + (size_t)(D + 2) * m + mp) +
         sizeof(int) * (size_t)ns;
}

template <int D>
__host__ inline size_t smem_linv(int m, int mp, int t) {
  const int ns = (mp + BK - 1) / BK;
  return sizeof(float) * (2 * (size_t)STAGE_T + 2 * STAGE_N + (size_t)D * t +
                          (size_t)(D + 2) * m) +
         sizeof(int) * (size_t)ns;
}

// ---- kernel 2: Z = (L^-1 K*) diag(gV) of the block's columns ----
template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
tile_bwd_z_kernel(const int* __restrict__ tiles,
                  const long long* __restrict__ z_off,
                  const int* __restrict__ tile_seg,
                  const float* __restrict__ linv,
                  const float* __restrict__ xt,
                  const float* __restrict__ gradflag,
                  const float* __restrict__ valid,
                  const float* __restrict__ qt,
                  const int* __restrict__ stages,
                  const int* __restrict__ counts,
                  const float* __restrict__ gvc,
                  const int* __restrict__ gv_nz, float* __restrict__ zbuf,
                  int m, int t, float scale) {
  const int nc = t * (1 + D), n_cb = (nc + BN - 1) / BN;
  const int nst = (nc + BK - 1) / BK;
  const int ci = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  const int tile = tiles[ci];
  if (!block_has_gv(gv_nz, tile, cb, nst)) return;   // Z is not needed
  const int seg = tile_seg[tile];
  const int mp = m * (1 + D), ns = (mp + BK - 1) / BK;
  const int nk = counts[seg], np = BK * nk;
  if (np == 0) return;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* ls = smem;                             // [2][BK][LDT]
  float* ks = ls + 2 * STAGE_T;                 // [2][BK][BN]
  float* qsm = ks + 2 * STAGE_N;                // [D][BN]
  float* gvs = qsm + D * BN;                    // [BN]
  float* xsm = gvs + BN;                        // [D][m]
  float* vms = xsm + D * m;                     // [m]
  float* gms = vms + m;                         // [m]
  int* kst = reinterpret_cast<int*>(gms + m);   // [ns]
  load_cell<D>(seg, m, ns, nk, xt, gradflag, valid, stages, xsm, vms, gms,
               kst);
  load_cols<D>(tile, cb, t, qt, gvc, qsm, gvs);
  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const float* L = linv + (size_t)seg * mp * mp;
  const int col = tid & (BN - 1);
  const int gcol = cb * BN + col;
  const int cblk = gcol < nc ? gcol / t : -1;
  const int kr0 = (tid >> 7) * 8;
  __syncthreads();

  // rows k0 + kr0 .. + 7 (packed; one kept stage) of K* at this column
  auto compute_k = [&](int k0, float* kb) {
    float q[D];
#pragma unroll
    for (int i = 0; i < D; ++i) q[i] = qsm[i * BN + col];
    const int r0 = unpack(kst, k0) + kr0;
    int rb = r0 / m, k = r0 - rb * m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = 0.f;
      if (cblk >= 0 && r0 + i < mp)
        v = kstar<D, FUSED_1AR>(rb, k, cblk, q, xsm, vms, gms, m, a, a2);
      kb[(kr0 + i) * BN + col] = v;
      if (++k == m) {
        k = 0;
        ++rb;
      }
    }
  };
  auto row_of = [&](int p) { return unpack(kst, p); };
  const bool vec = (mp & 3) == 0 && ((size_t)linv & 15) == 0;
  float* zt = zbuf + z_off[ci];
  float acc[8][8], pr[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  int i0 = 0, k0 = 0, buf = 0;
  load_t(L, mp, np - i0, mp, [&](int p) { return row_of(i0 + p); },
         unpack(kst, k0), mp, vec, pr);
  store_t(pr, ls);
  compute_k(k0, ks);
  for (;;) {
    // the next stage: k0 + BK in this panel, or the next panel's first
    int ni0 = i0, nk0 = k0 + BK;
    if (nk0 >= min(i0 + BM, np)) {              // lower triangular
      ni0 += BM;
      nk0 = 0;
    }
    const bool more = ni0 < np;
    __syncthreads();                            // stage buf is written
    if (more)
      load_t(L, mp, np - ni0, mp, [&](int p) { return row_of(ni0 + p); },
             unpack(kst, nk0), mp, vec, pr);
    fma_stage(ls + buf * STAGE_T, LDT, ks + buf * STAGE_N, BN, acc);
    if (nk0 == 0) {                             // the panel is finished
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = i0 + acc_row(u);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int c = acc_col(v), gc = cb * BN + c;
          if (p < np && gc < nc) zt[(size_t)p * nc + gc] = acc[u][v] * gvs[c];
          acc[u][v] = 0.f;
        }
      }
    }
    if (!more) break;
    // the other buffer was last read before this iteration's barrier
    store_t(pr, ls + (buf ^ 1) * STAGE_T);
    compute_k(nk0, ks + (buf ^ 1) * STAGE_N);
    buf ^= 1;
    i0 = ni0;
    k0 = nk0;
  }
}

// ---- kernel 3: Y = L^T Z, dK* = alpha gF^T - 2 Y, chained ----
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
tile_bwd_kstar_kernel(const int* __restrict__ tiles,
                      const long long* __restrict__ z_off,
                      const int* __restrict__ tile_seg,
                      const float* __restrict__ linv,
                      const float* __restrict__ xt,
                      const float* __restrict__ alpha,
                      const float* __restrict__ gradflag,
                      const float* __restrict__ valid,
                      const float* __restrict__ qt,
                      const int* __restrict__ stages,
                      const int* __restrict__ counts,
                      const float* __restrict__ gfc,
                      const int* __restrict__ gv_nz,
                      const float* __restrict__ zbuf, int has_z, int chain,
                      float* __restrict__ dqc, float* __restrict__ part,
                      float* __restrict__ da_part, int m, int t,
                      float scale) {
  const int nc = t * (1 + D), n_cb = (nc + BN - 1) / BN;
  const int nst = (nc + BK - 1) / BK;
  const int ci = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  const int tile = tiles[ci];
  const int seg = tile_seg[tile];
  const int mp = m * (1 + D), ns = (mp + BK - 1) / BK;
  const int nk = counts[seg], np = BK * nk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // Y is taken as zero where Z was not formed
  const bool has_y = has_z && chain && block_has_gv(gv_nz, tile, cb, nst);

  extern __shared__ __align__(16) float smem[];
  float* ls = smem;                             // [2][BK][BM]  L rows
  float* zs = ls + 2 * STAGE_N;                 // [2][BK][BN]  Z rows
  float* red = zs + 2 * STAGE_N;                // [16][BM][1 + D]
  float* dsm = red + 16 * BM * (1 + D);         // [NTHREADS]
  float* qsm = dsm + NTHREADS;                  // [D][BN]
  float* gfs = qsm + D * BN;                    // [BN]
  float* xsm = gfs + BN;                        // [D][m]
  float* vms = xsm + D * m;                     // [m]
  float* gms = vms + m;                         // [m]
  float* als = gms + m;                         // [mp]
  int* kst = reinterpret_cast<int*>(als + mp);  // [ns]
  load_cell<D>(seg, m, ns, nk, xt, gradflag, valid, stages, xsm, vms, gms,
               kst);
  load_cols<D>(tile, cb, t, qt, gfc, qsm, gfs);
  for (int p = tid; p < mp; p += NTHREADS) als[p] = alpha[(size_t)seg * mp + p];
  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const float* L = linv + (size_t)seg * mp * mp;
  const float* zt = has_y ? zbuf + z_off[ci] : nullptr;
  const bool vec_l = (mp & 3) == 0 && ((size_t)linv & 15) == 0;
  const bool vec_z = (nc & 3) == 0 && ((size_t)zbuf & 15) == 0;
  __syncthreads();

  float dq[8][D], da = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int l = 0; l < D; ++l) dq[v][l] = 0.f;
  // this thread's row of a [BK][128] stage and its columns 8 (tid % 16)..
  const int sr = tid >> 4, sc = 8 * (tid & 15);
  for (int r0 = 0; r0 < np; r0 += BM) {
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    if (has_y) {
      // Y[r0.., cols] = sum over stages I >= r0 of L[I, r0..]^T Z[I, cols]
      const int pc = r0 + sc;                   // 8 packed columns, one stage
      const int lc = pc < np ? unpack(kst, pc) : mp;
      float pl[8], pz[8];
      auto load = [&](int i0) {
        const int pi = i0 + sr;
        const int li = pi < np ? unpack(kst, pi) : mp;
        load_n(L + (size_t)li * mp, li < mp && lc < mp, lc, mp, vec_l, pl);
        load_n(zt + (size_t)pi * nc, pi < np, cb * BN + sc, nc, vec_z, pz);
      };
      int i0 = r0, buf = 0;
      load(i0);
      store_n(pl, ls);
      store_n(pz, zs);
      for (;;) {
        const int ni0 = i0 + BK;
        const bool more = ni0 < np;
        __syncthreads();                        // stage buf is written
        if (more) load(ni0);
        fma_stage(ls + buf * STAGE_N, BM, zs + buf * STAGE_N, BN, acc);
        if (!more) break;
        store_n(pl, ls + (buf ^ 1) * STAGE_N);
        store_n(pz, zs + (buf ^ 1) * STAGE_N);
        buf ^= 1;
        i0 = ni0;
      }
    }
    // each entry of the panel: dK*, its derivatives, the row sums of
    // d alpha and dx over this thread's 8 columns
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = r0 + acc_row(u);
      const int r = p < np ? unpack(kst, p) : mp;
      float rs[1 + D];
#pragma unroll
      for (int l = 0; l <= D; ++l) rs[l] = 0.f;
      if (r < mp) {
        const int rb = r / m, k = r - rb * m;
        const float al = als[r];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int c = acc_col(v), gc = cb * BN + c;
          if (gc < nc) {
            float q[D], gd[D], ga;
#pragma unroll
            for (int l = 0; l < D; ++l) q[l] = qsm[l * BN + c];
            const float val = kstar_grad<D>(rb, k, gc / t, q, xsm, vms, gms,
                                            m, a, a2, gd, ga);
            rs[0] = fmaf(val, gfs[c], rs[0]);
            if (chain) {
              const float g = al * gfs[c] - 2.f * acc[u][v];
#pragma unroll
              for (int l = 0; l < D; ++l) {
                rs[1 + l] = fmaf(g, gd[l], rs[1 + l]);
                dq[v][l] = fmaf(-g, gd[l], dq[v][l]);
              }
              da = fmaf(g, ga, da);
            }
          }
        }
      }
#pragma unroll
      for (int l = 0; l <= D; ++l)
        red[(tx * BM + acc_row(u)) * (1 + D) + l] = rs[l];
    }
    __syncthreads();
    // the 16 column threads' row sums, in order, into the block's partial
    if (tid < BM) {
      const int p = r0 + tid;
      const int r = p < np ? unpack(kst, p) : mp;
      if (r < mp) {
#pragma unroll
        for (int l = 0; l <= D; ++l) {
          float s = 0.f;
#pragma unroll
          for (int x = 0; x < 16; ++x) s += red[(x * BM + tid) * (1 + D) + l];
          part[((size_t)blockIdx.x * mp + r) * (1 + D) + l] = s;
        }
      }
    }
    __syncthreads();                            // red is read
  }

  // dq of each column: the 16 row threads' sums, in order
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int l = 0; l < D; ++l) red[(ty * BN + acc_col(v)) * D + l] = dq[v][l];
  dsm[tid] = da;
  __syncthreads();
  const int gc = cb * BN + tid;
  if (chain && tid < BN && gc < nc) {
    const int cblk = gc / t, qj = gc - cblk * t;
#pragma unroll
    for (int l = 0; l < D; ++l) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) s += red[(y * BN + tid) * D + l];
      dqc[(((size_t)tile * (1 + D) + cblk) * D + l) * t + qj] = s;
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int x = 0; x < NTHREADS; ++x) s += dsm[x];
    da_part[blockIdx.x] = s;
  }
}

// ---- kernel 4: dL_s = -2 sum_t Z_t K*_t^T over the packed rows ----
template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
tile_bwd_linv_kernel(const int* __restrict__ cells,
                     const int* __restrict__ cell_start,
                     const int* __restrict__ tiles,
                     const long long* __restrict__ z_off,
                     const float* __restrict__ xt,
                     const float* __restrict__ gradflag,
                     const float* __restrict__ valid,
                     const float* __restrict__ qt,
                     const int* __restrict__ stages,
                     const int* __restrict__ counts,
                     const int* __restrict__ gv_nz,
                     const float* __restrict__ zbuf, float* __restrict__ dl,
                     int n_ot, int m, int t, float scale) {
  const int nc = t * (1 + D), nst = (nc + BK - 1) / BK;
  const int cj = blockIdx.x / (n_ot * n_ot), o = blockIdx.x % (n_ot * n_ot);
  const int oi = o / n_ot, oj = o % n_ot;
  const int seg = cells[cj];
  const int mp = m * (1 + D), ns = (mp + BK - 1) / BK;
  const int nk = counts[seg], np = BK * nk;
  if (oi * BM >= np || oj * BM >= np) return;   // past the kept rows
  const int tb = cell_start[cj], te = cell_start[cj + 1];
  // the (tile, 16-column stage) items with some gV nonzero, in order
  auto advance = [&](int& ti, int& st) {
    for (;;) {
      if (++st >= nst) {
        st = 0;
        if (++ti >= te) return;
      }
      if (gv_nz[(size_t)tiles[ti] * nst + st]) return;
    }
  };
  int ti = tb, st = -1;
  advance(ti, st);
  if (ti >= te) return;                         // Z = 0: dL stays 0
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                             // [2][BK][LDT]  Z^T
  float* ks = zs + 2 * STAGE_T;                 // [2][BK][BM]   K*^T
  float* xsm = ks + 2 * STAGE_N;                // [D][m]
  float* vms = xsm + D * m;                     // [m]
  float* gms = vms + m;                         // [m]
  float* qsm = gms + m;                         // [D][t]
  int* kst = reinterpret_cast<int*>(qsm + D * t);   // [ns]
  load_cell<D>(seg, m, ns, nk, xt, gradflag, valid, stages, xsm, vms, gms,
               kst);
  auto load_q = [&](int i) {
    const float* qs = qt + (size_t)tiles[i] * D * t;
    for (int p = tid; p < D * t; p += NTHREADS) qsm[p] = qs[p];
  };
  load_q(ti);
  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const bool vec = (nc & 3) == 0 && ((size_t)zbuf & 15) == 0;
  __syncthreads();
  // this thread's K* row (packed oj * BM + tid % 128) and its 8 columns
  // 8 (tid / 128).. of a stage
  const int jp = oj * BM + (tid & (BM - 1));
  const int jr = jp < np ? unpack(kst, jp) : mp;
  const int rb = jr / m, k = jr - rb * m;
  const int kc0 = 8 * (tid >> 7);
  auto compute_k = [&](int s, float* kb) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = BK * s + kc0 + i;
      float v = 0.f;
      if (jr < mp && c < nc) {
        const int cblk = c / t, qj = c - cblk * t;
        float q[D];
#pragma unroll
        for (int l = 0; l < D; ++l) q[l] = qsm[l * t + qj];
        v = kstar<D, FUSED_1AR>(rb, k, cblk, q, xsm, vms, gms, m, a, a2);
      }
      kb[(kc0 + i) * BM + (tid & (BM - 1))] = v;
    }
  };
  const int i0 = oi * BM;
  auto load_z = [&](int i, int s, float (&pr)[8]) {
    load_t(zbuf + z_off[i] + (size_t)i0 * nc, nc, np - i0, np - i0,
           [](int p) { return p; }, BK * s, nc, vec, pr);
  };
  float acc[8][8], pr[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  int buf = 0;
  load_z(ti, st, pr);
  store_t(pr, zs);
  compute_k(st, ks);
  for (;;) {
    int nti = ti, nst_ = st;
    advance(nti, nst_);
    const bool more = nti < te;
    __syncthreads();                            // stage buf is written
    if (more) load_z(nti, nst_, pr);
    fma_stage(zs + buf * STAGE_T, LDT, ks + buf * STAGE_N, BM, acc);
    if (!more) break;
    if (nti != ti) {                            // the next tile's queries
      load_q(nti);
      __syncthreads();
    }
    store_t(pr, zs + (buf ^ 1) * STAGE_T);
    compute_k(nst_, ks + (buf ^ 1) * STAGE_N);
    buf ^= 1;
    ti = nti;
    st = nst_;
  }
  float* out = dl + (size_t)seg * mp * mp;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int pi = i0 + acc_row(u);
    const int ri = pi < np ? unpack(kst, pi) : mp;
    if (ri >= mp) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int pj = oj * BM + acc_col(v);
      const int rj = pj < np ? unpack(kst, pj) : mp;
      if (rj < mp) out[(size_t)ri * mp + rj] = -2.f * acc[u][v];
    }
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_z(const int* tiles, const long long* z_off, const int* tile_seg,
             const float* linv, const float* xt, const float* gradflag,
             const float* valid, const float* qt, const int* stages,
             const int* counts, const float* gvc, const int* gv_nz,
             float* zbuf, int n_tiles, int m, int t, float scale,
             cudaStream_t stream) {
  const size_t smem = smem_z<D>(m, m * (1 + D));
  if (int err = prepare(tile_bwd_z_kernel<D>, smem)) return err;
  const long long n_cb = ((long long)t * (1 + D) + BN - 1) / BN;
  const long long n_blocks = (long long)n_tiles * n_cb;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tile_bwd_z_kernel<D><<<(unsigned)n_blocks, NTHREADS, smem, stream>>>(
      tiles, z_off, tile_seg, linv, xt, gradflag, valid, qt, stages, counts,
      gvc, gv_nz, zbuf, m, t, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_kstar(const int* tiles, const long long* z_off,
                 const int* tile_seg, const float* linv, const float* xt,
                 const float* alpha, const float* gradflag,
                 const float* valid, const float* qt, const int* stages,
                 const int* counts, const float* gfc, const int* gv_nz,
                 const float* zbuf, int has_z, int chain, float* dqc,
                 float* part, float* da_part, int n_tiles, int m, int t,
                 float scale, cudaStream_t stream) {
  const size_t smem = smem_kstar<D>(m, m * (1 + D));
  if (int err = prepare(tile_bwd_kstar_kernel<D>, smem)) return err;
  const long long n_cb = ((long long)t * (1 + D) + BN - 1) / BN;
  const long long n_blocks = (long long)n_tiles * n_cb;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tile_bwd_kstar_kernel<D><<<(unsigned)n_blocks, NTHREADS, smem, stream>>>(
      tiles, z_off, tile_seg, linv, xt, alpha, gradflag, valid, qt, stages,
      counts, gfc, gv_nz, zbuf, has_z, chain, dqc, part, da_part, m, t,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_linv(const int* cells, const int* cell_start, const int* tiles,
                const long long* z_off, const float* xt,
                const float* gradflag, const float* valid, const float* qt,
                const int* stages, const int* counts, const int* gv_nz,
                const float* zbuf, float* dl, int n_cells, int n_ot, int m,
                int t, float scale, cudaStream_t stream) {
  const size_t smem = smem_linv<D>(m, m * (1 + D), t);
  if (int err = prepare(tile_bwd_linv_kernel<D>, smem)) return err;
  const long long n_blocks = (long long)n_cells * n_ot * n_ot;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tile_bwd_linv_kernel<D><<<(unsigned)n_blocks, NTHREADS, smem, stream>>>(
      cells, cell_start, tiles, z_off, xt, gradflag, valid, qt, stages,
      counts, gv_nz, zbuf, dl, n_ot, m, t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block of kernel 2 (z), 3 (kstar) or 4 (linv) at
// dimension d, support size m and tile size t (bytes; 0 for a d other
// than 2 or 3).
long long tile_bwd_smem_bytes(int kernel, int d, int m, int t) {
  if (d != 2 && d != 3) return 0;
  const int mp = m * (1 + d);
  if (kernel == 2) return d == 2 ? smem_z<2>(m, mp) : smem_z<3>(m, mp);
  if (kernel == 3) return d == 2 ? smem_kstar<2>(m, mp) : smem_kstar<3>(m, mp);
  return d == 2 ? smem_linv<2>(m, mp, t) : smem_linv<3>(m, mp, t);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a d other than 2 or 3. tiles [n]
// are the chunk's active tiles (grouped by cell), z_off [n] each one's
// float offset into zbuf; stages and counts are kept_stages'; gvc and gfc
// [NT][T(1+d)] the cotangents of (vf, vg) and (f, g) in K*'s column
// order; gv_nz [NT][ceil(T(1+d) / 16)] whether a 16-column stage of gvc
// has a nonzero entry.
int tile_bwd_z_launch(const int* tiles, const long long* z_off,
                      const int* tile_seg, const float* linv,
                      const float* xt, const float* gradflag,
                      const float* valid, const float* qt,
                      const int* stages, const int* counts, const float* gvc,
                      const int* gv_nz, float* zbuf, int n_tiles, int d,
                      int m, int t, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch_z<2>(tiles, z_off, tile_seg, linv, xt, gradflag, valid, qt,
                       stages, counts, gvc, gv_nz, zbuf, n_tiles, m, t,
                       scale, s);
  if (d == 3)
    return launch_z<3>(tiles, z_off, tile_seg, linv, xt, gradflag, valid, qt,
                       stages, counts, gvc, gv_nz, zbuf, n_tiles, m, t,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

// dqc [NT][1 + d][d][T]: d q of each K* column (the caller sums a query's
// 1 + d columns); part [n_tiles * n_cb][MP][1 + d]: each block's d alpha
// and dx per row of MP; da_part [n_tiles * n_cb]: each block's d a. With
// chain 0 only d alpha is computed; with has_z 0 Y is taken as zero.
int tile_bwd_kstar_launch(const int* tiles, const long long* z_off,
                          const int* tile_seg, const float* linv,
                          const float* xt, const float* alpha,
                          const float* gradflag, const float* valid,
                          const float* qt, const int* stages,
                          const int* counts, const float* gfc,
                          const int* gv_nz, const float* zbuf, int has_z,
                          int chain, float* dqc, float* part, float* da_part,
                          int n_tiles, int d, int m, int t, float scale,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch_kstar<2>(tiles, z_off, tile_seg, linv, xt, alpha, gradflag,
                           valid, qt, stages, counts, gfc, gv_nz, zbuf, has_z,
                           chain, dqc, part, da_part, n_tiles, m, t, scale,
                           s);
  if (d == 3)
    return launch_kstar<3>(tiles, z_off, tile_seg, linv, xt, alpha, gradflag,
                           valid, qt, stages, counts, gfc, gv_nz, zbuf, has_z,
                           chain, dqc, part, da_part, n_tiles, m, t, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

// cells [n_cells] and cell_start [n_cells + 1]: the chunk's cells and
// where each one's tiles start in tiles; dl [S][MP][MP] (its entries
// outside the kept rows and columns are left alone); n_ot = ceil(16 *
// (largest kept-stage count of the chunk's cells) / 128).
int tile_bwd_linv_launch(const int* cells, const int* cell_start,
                         const int* tiles, const long long* z_off,
                         const float* xt, const float* gradflag,
                         const float* valid, const float* qt,
                         const int* stages, const int* counts,
                         const int* gv_nz, const float* zbuf, float* dl,
                         int n_cells, int n_ot, int d, int m, int t,
                         float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch_linv<2>(cells, cell_start, tiles, z_off, xt, gradflag,
                          valid, qt, stages, counts, gv_nz, zbuf, dl, n_cells,
                          n_ot, m, t, scale, s);
  if (d == 3)
    return launch_linv<3>(cells, cell_start, tiles, z_off, xt, gradflag,
                          valid, qt, stages, counts, gv_nz, zbuf, dl, n_cells,
                          n_ot, m, t, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* tile_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
