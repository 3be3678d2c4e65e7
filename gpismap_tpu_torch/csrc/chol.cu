// Batched Cholesky factor and lower-triangular inverse of the cluster-GP
// systems, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gpismap_tpu/ops/pallas_chol.py:
//   chol_* kernels <- chol_pallas (_chol_kernel, _chol_base): lower L with
//                   L L^T = K for SPD K [B, n, n]; strict upper triangle
//                   written as exact zeros; a non-positive pivot is clamped
//                   to sqrt(1e-30) as at pallas_chol.py:72
//                   (torch.linalg.cholesky raises there instead);
//   linv_kernel  <- linv_pallas (_linv_kernel, _inv_lower_base): W = L^-1
//                   of lower-triangular L [B, n, n] by blocked forward
//                   substitution; strict upper triangle exact zeros (the
//                   tile kernel, csrc/tile_eval.cu, skips it and relies on
//                   them).
// n <= 1280 (2D: 96/192/384; 3D: 320/640/1280), fp32 FMAs only: no TF32,
// no tensor cores and no atomics (the map query's variance is a
// cancellation, const - ||L^-1 k*||^2), so a matrix's factor does not
// depend on the batch it is in.
//
// What bounds chol on the H100. n^3/6 multiply-adds per matrix: 1.2 GFLOP
// for B = 64 at n = 384 (0.018 ms at the 67 TFLOP/s fp32 rate; moving K in
// and L out once, 75.5 MB, takes 0.0225 ms) and 44.7 GFLOP at n = 1280
// (0.67 ms). At n = 384 neither is reached: the factorization is a chain
// of dependent steps, and the chain of kernel launches and of the pivots
// inside each diagonal block bounds it. At n = 1280 the FMA rate bounds
// it, and behind it the bytes of the trailing updates: a right-looking
// factorization reads and writes the trailing lower triangle once per
// panel, about 4/3 n^3 / NB bytes per matrix (44 MB at NB = 64, 2.8 GB
// for B = 64, 0.84 ms at 3.35 TB/s), since one 6.55 MB matrix, let alone a
// batch, does not stay in the 50 MB L2.
//
// chol design: blocked right-looking factorization over NB = 64 column
// panels, several blocks per matrix, issued from a host loop in C on the
// caller's stream (chol_launch): one chol_init_kernel, then for each panel
// that has rows below its diagonal block a chol_panel_kernel and a
// chol_update_kernel, 1 + 2 (ceil(n / NB) - 1) launches in all (39 at
// n = 1280, 11 at n = 384).
//   - chol_init_kernel, grid (row blocks of NB, B): L <- lower triangle of
//     K with exact zeros above; the block of the first rows also factors
//     the first diagonal block.
//   - chol_panel_kernel, grid (ceil(nr / RB), B), nr the rows below the
//     diagonal block: each block reads the factored diagonal block into
//     shared memory and solves RB = 256 panel rows against it, one row per
//     thread, the row in registers (X L_kk^T = P by columns: every FMA of
//     a column step is independent, so the row's chain is one division
//     and one FMA deep per column).
//   - chol_update_kernel, grid (tiles of the trailing lower triangle, B):
//     A[i][j] -= P_i . P_j in 64x64 output tiles; only the tiles with
//     tj <= ti are enumerated (linear index -> (ti, tj)). A block holds the
//     panel rows of its tile's row and column blocks in shared memory,
//     transposed (2 x 64 x 68 f32 = 34.8 KB, under the 48 KB that needs no
//     opt-in; rows of 68 keep the float4 reads aligned), and each of its
//     256 threads accumulates a 4x4 register tile, so each shared-memory
//     load feeds 4 FMAs, not 1. Diagonal tiles write only j <= i, so the
//     exact zeros above the diagonal survive.
// The diagonal block of the next panel is the trailing update's tile 0:
// the block that finishes it also factors it in shared memory (the
// right-looking 64-step loop with the pivot clamp, all 256 threads) and
// writes it. So each diagonal block is factored once, by one block, and
// no block of a panel kernel writes what another one reads. NB = 64, not
// 32: it halves the chain of launches and the trailing bytes, and a
// 64-wide row solve still fits in registers. Identity-masked rows stay
// exact: their products are zeros, and fmaf(-0, x, a) == a.
//
// linv: also n^3/6 multiply-adds per matrix. Each [n, n] matrix lives in
// device memory and the L2 (one [1280, 1280] matrix is 6.55 MB); a block
// keeps its W panel in shared memory, 177 KB at n = 1280, under the
// 227 KB a block may use; the launcher raises the limit to it.
// linv design: column panel k of W depends only on L and on W[., k]
// itself (pallas_chol.py:141-153), so one block per (matrix, 32-column
// panel): B * n/32 blocks, which fills the card even at B = 8. The block
// walks down its panel in 32-row blocks: S = L[I, k0:i0] W[k0:i0, k] from
// the panel rows already done (kept in shared memory), then a forward
// substitution with the diagonal block L[I, I] (one warp, lane = column).
#include <cuda_runtime.h>

namespace {

constexpr int PW = 32;               // linv: panel width and row-block height
constexpr int LD = PW + 1;           // padded shared row: conflict-free column reads
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RPW = PW / NWARPS;     // rows per warp in a 32x32 tile (4)
constexpr float PIVOT_FLOOR = 1e-30f;  // pallas_chol.py:72

constexpr int NB = 64;               // chol: panel width = update tile edge
constexpr int NBL = NB + 1;          // padded row of a diagonal block
constexpr int TLD = NB + 4;          // row of a transposed panel tile (float4)
constexpr int RB = NTHREADS;         // panel rows per block, one per thread
static_assert(NTHREADS == 4 * NB, "factor_diag: four threads per row");
static_assert(NTHREADS == 16 * 16 && NB == 4 * 16, "4x4 tile per thread");

__host__ inline size_t diag_smem_bytes() {
  return sizeof(float) * NB * NBL;                   // one diagonal block
}

__host__ inline size_t update_smem_bytes() {
  return sizeof(float) * 2 * NB * TLD;               // two panel tiles
}

__host__ inline size_t linv_smem_bytes(int n) {
  return sizeof(float) * ((size_t)n + 2 * PW) * LD;  // W panel + 2 blocks
}

// dg [NB][NBL] <- the w x w diagonal block of M at k0 (lower triangle),
// zeros above it and the identity past w.
__device__ void load_diag(const float* M, int n, int k0, int w, float* dg) {
  for (int p = threadIdx.x; p < NB * NB; p += NTHREADS) {
    const int r = p / NB, c = p % NB;
    float v = r == c ? 1.f : 0.f;
    if (r < w && c <= r) v = M[(size_t)(k0 + r) * n + k0 + c];
    dg[r * NBL + c] = v;
  }
}

// Factors dg in place, right-looking: step j takes the pivot (clamped),
// scales column j, then updates the lower triangle right of it; thread
// (r, c0) takes row r = tid / 4 and columns c0 + 4 q. Every thread of the
// block calls it; it synchronizes on entry and on return.
__device__ void factor_diag(float* dg) {
  const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
  __syncthreads();
  for (int j = 0; j < NB; ++j) {
    if (c0 == 0 && r > j)
      dg[r * NBL + j] /= sqrtf(fmaxf(dg[j * NBL + j], PIVOT_FLOOR));
    __syncthreads();
    if (threadIdx.x == 0)
      dg[j * NBL + j] = sqrtf(fmaxf(dg[j * NBL + j], PIVOT_FLOOR));
    if (r > j) {
      const float lr = dg[r * NBL + j];
      for (int c = j + 1 + c0; c <= r; c += 4)
        dg[r * NBL + c] = fmaf(-lr, dg[c * NBL + j], dg[r * NBL + c]);
    }
    __syncthreads();
  }
}

// L's w x w diagonal block at k0 <- dg, exact zeros above the diagonal.
__device__ void store_diag(float* L, int n, int k0, int w, const float* dg) {
  for (int p = threadIdx.x; p < w * w; p += NTHREADS) {
    const int r = p / w, c = p % w;
    L[(size_t)(k0 + r) * n + k0 + c] = c <= r ? dg[r * NBL + c] : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS)
chol_init_kernel(const float* __restrict__ k, float* __restrict__ l, int n) {
  const size_t off = (size_t)blockIdx.y * n * n;
  const float* A = k + off;
  float* L = l + off;
  const int i0 = blockIdx.x * NB, h = min(NB, n - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // block 0 writes its diagonal block once, factored, below
  const int j_first = blockIdx.x == 0 ? h : 0;
  for (int i = i0 + warp; i < i0 + h; i += NWARPS)
    for (int j = j_first + lane; j < n; j += 32)
      L[(size_t)i * n + j] = j <= i ? A[(size_t)i * n + j] : 0.f;
  if (blockIdx.x != 0) return;
  extern __shared__ __align__(16) float dsm[];
  load_diag(A, n, 0, h, dsm);
  factor_diag(dsm);
  store_diag(L, n, 0, h, dsm);
}

// Panel k0 has rows below its diagonal block, so it is NB wide.
__global__ void __launch_bounds__(NTHREADS)
chol_panel_kernel(float* __restrict__ l, int n, int k0) {
  float* L = l + (size_t)blockIdx.y * n * n;
  const int r0 = k0 + NB;
  extern __shared__ __align__(16) float dsm[];
  float* dg = dsm;
  load_diag(L, n, k0, NB, dg);         // factored by the previous launch
  __syncthreads();
  const int r = r0 + blockIdx.x * RB + threadIdx.x;
  if (r >= n) return;
  float* row = L + (size_t)r * n + k0;
  float x[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) x[c] = row[c];
  // X L_kk^T = P: x[c] -= x[j] L[c][j] in the order j = 0, 1, ..., as a
  // row-by-row forward substitution sums them
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    x[j] /= dg[j * NBL + j];
#pragma unroll
    for (int c = j + 1; c < NB; ++c) x[c] = fmaf(-x[j], dg[c * NBL + j], x[c]);
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) row[c] = x[c];
}

__global__ void __launch_bounds__(NTHREADS)
chol_update_kernel(float* __restrict__ l, int n, int k0) {
  float* L = l + (size_t)blockIdx.y * n * n;
  const int r0 = k0 + NB, nr = n - r0;
  // tile (ti, tj), tj <= ti, of the linear index t = ti (ti + 1) / 2 + tj
  const int t = blockIdx.x;
  int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * NB, j0 = tj * NB;  // offsets in the trailing block
  const int hi = min(NB, nr - i0), hj = min(NB, nr - j0);
  extern __shared__ __align__(16) float dsm[];
  float* pi = dsm;                     // [NB][TLD]: pi[q][a] = P[i0 + a][q]
  float* pj = dsm + NB * TLD;          // [NB][TLD]: pj[q][b] = P[j0 + b][q]
  const int tid = threadIdx.x;
  for (int p = tid; p < NB * NB; p += NTHREADS) {
    const int a = p / NB, q = p % NB;
    pi[q * TLD + a] = a < hi ? L[(size_t)(r0 + i0 + a) * n + k0 + q] : 0.f;
    pj[q * TLD + a] = a < hj ? L[(size_t)(r0 + j0 + a) * n + k0 + q] : 0.f;
  }
  __syncthreads();
  // thread (ty, tx): rows 4 ty + u, columns 4 tx + v of the tile
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const float4 a4 = *reinterpret_cast<const float4*>(pi + q * TLD + 4 * ty);
    const float4 b4 = *reinterpret_cast<const float4*>(pj + q * TLD + 4 * tx);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
  float* tile = L + (size_t)(r0 + i0) * n + r0 + j0;
  if (t != 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int a = 4 * ty + u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int b = 4 * tx + v;
        if (a < hi && b < hj && (ti != tj || b <= a))
          tile[(size_t)a * n + b] -= acc[u][v];
      }
    }
    return;
  }
  // tile 0 is the next panel's diagonal block: finish it in shared
  // memory, factor it and write it
  __syncthreads();                     // pi and pj are read
  float* dg = dsm;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int a = 4 * ty + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int b = 4 * tx + v;
      float x = a == b ? 1.f : 0.f;
      if (a < hi && b <= a) x = tile[(size_t)a * n + b] - acc[u][v];
      dg[a * NBL + b] = x;
    }
  }
  factor_diag(dg);
  store_diag(L, n, r0, hi, dg);
}

__global__ void __launch_bounds__(NTHREADS)
linv_kernel(const float* __restrict__ l, float* __restrict__ w, int n) {
  const size_t off = (size_t)blockIdx.x * n * n;
  const float* L = l + off;
  float* W = w + off;
  const int k0 = blockIdx.y * PW;      // this block's column panel
  const int wk = min(PW, n - k0);
  extern __shared__ float smem[];
  float* wp = smem;                    // [n - k0][LD] W[k0:, k0:k0+PW]
  float* lc = wp + (size_t)n * LD;     // [PW][LD] block of L
  float* t = lc + PW * LD;             // [PW][LD] right-hand side / solution
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // rows above the panel: exact zeros
  for (int i = warp; i < k0; i += NWARPS)
    if (lane < wk) W[(size_t)i * n + k0 + lane] = 0.f;

  for (int i0 = k0; i0 < n; i0 += PW) {
    const int h = min(PW, n - i0);     // rows in this row block
    // S = L[i0:i0+h, k0:i0] @ W[k0:i0, panel]; column lane, rows
    // warp + NWARPS q
    float acc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) acc[rr] = 0.f;
    for (int j0 = k0; j0 < i0; j0 += PW) {
      __syncthreads();                 // lc free
      for (int p = tid; p < PW * PW; p += NTHREADS) {
        const int r = p / PW, c = p % PW;
        lc[r * LD + c] = r < h ? L[(size_t)(i0 + r) * n + j0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < PW; ++jj) {
        const float wv = wp[(j0 - k0 + jj) * LD + lane];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          acc[rr] = fmaf(lc[(warp + NWARPS * rr) * LD + jj], wv, acc[rr]);
      }
    }
    __syncthreads();                   // lc and t free
    // T = E - S, E = I on the panel's own diagonal block
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      t[r * LD + lane] = (i0 == k0 && r == lane ? 1.f : 0.f) - acc[rr];
    }
    for (int p = tid; p < PW * PW; p += NTHREADS) {
      const int r = p / PW, c = p % PW;
      float v = r == c ? 1.f : 0.f;
      if (r < h && c <= r) v = L[(size_t)(i0 + r) * n + i0 + c];
      lc[r * LD + c] = v;
    }
    __syncthreads();
    // X = L[I, I]^-1 T: one warp, lane = column
    if (warp == 0) {
      for (int r = 0; r < PW; ++r) {
        float s = t[r * LD + lane];
        for (int q = 0; q < r; ++q) s = fmaf(-lc[r * LD + q], t[q * LD + lane], s);
        t[r * LD + lane] = s / lc[r * LD + r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + NWARPS * rr;
      if (r < h) {
        // strict upper triangle of the diagonal block: exact zeros
        const float v = i0 == k0 && r < lane ? 0.f : t[r * LD + lane];
        wp[(i0 - k0 + r) * LD + lane] = v;
        if (lane < wk) W[(size_t)(i0 + r) * n + k0 + lane] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at size n (bytes): for chol the
// largest of its kernels' (the trailing update's), whatever n.
long long chol_smem(int n) {
  (void)n;
  return (long long)(diag_smem_bytes() > update_smem_bytes()
                         ? diag_smem_bytes() : update_smem_bytes());
}
long long linv_smem(int n) { return (long long)linv_smem_bytes(n); }

// CUDA kernel launches of one chol_launch at size n.
int chol_launch_count(int n) { return n <= 0 ? 0 : 1 + 2 * ((n - 1) / NB); }

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// chol: the whole blocked factorization, chol_launch_count(n) kernels in
// stream order; it stops at the first launch that fails.
int chol_launch(const float* k, float* l, int b, int n, void* stream) {
  if (b > 65535) return (int)cudaErrorInvalidValue;  // grid.y holds the batch
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t sd = diag_smem_bytes(), su = update_smem_bytes();
  chol_init_kernel<<<dim3((n + NB - 1) / NB, b), NTHREADS, sd, s>>>(k, l, n);
  cudaError_t err = cudaGetLastError();
  for (int k0 = 0; err == cudaSuccess && k0 + NB < n; k0 += NB) {
    const int nr = n - k0 - NB, nt = (nr + NB - 1) / NB;
    chol_panel_kernel<<<dim3((nr + RB - 1) / RB, b), NTHREADS, sd, s>>>(l, n,
                                                                       k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    chol_update_kernel<<<dim3(nt * (nt + 1) / 2, b), NTHREADS, su, s>>>(l, n,
                                                                       k0);
    err = cudaGetLastError();
  }
  return (int)err;
}

int linv_launch(const float* l, float* w, int b, int n, void* stream) {
  const size_t smem = linv_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      linv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, (n + PW - 1) / PW);
  linv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(l, w, n);
  return (int)cudaGetLastError();
}

const char* chol_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
