// Batched Cholesky factor and lower-triangular inverse of the cluster-GP
// systems, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gpismap_tpu/ops/pallas_chol.py:
//   chol_* kernels <- chol_pallas (_chol_kernel, _chol_base): lower L with
//                   L L^T = K for SPD K [B, n, n]; strict upper triangle
//                   written as exact zeros; a non-positive pivot is clamped
//                   to sqrt(1e-30) as at pallas_chol.py:72
//                   (torch.linalg.cholesky raises there instead);
//   linv_* kernels <- linv_pallas (_linv_kernel, _inv_lower_base): W = L^-1
//                   of lower-triangular L [B, n, n] by recursive merging of
//                   inverted diagonal blocks; strict upper triangle exact
//                   zeros (the tile kernel, csrc/tile_eval.cu, skips it and
//                   relies on them).
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
// What bounds linv. Also n^3/6 multiply-adds per matrix: 44.7 GFLOP for
// B = 64 at n = 1280 (0.668 ms at 67 TFLOP/s) and 1.2 GFLOP at n = 384
// (0.0225 ms, bound by the 75.5 MB of L in and W out). Of the work at
// n = 1280, 48 % is the last merge level (s = 1024: |A| = 1024,
// |D| = 256) and 38 % the one before (s = 512); each has 4,096 output
// tiles of 64x64 per launch at B = 64, so the card is full and the FMA
// rate bounds them. At n = 384 the chain of 7 launches bounds it.
//
// linv design: the blocked column order of the Pallas kernel
// (pallas_chol.py:128-153) suits one sequential core, not 132 SMs, so
// the inverse is built by merging instead, from a host loop in C on the
// caller's stream (linv_launch), 1 + 2 ceil(log2(ceil(n / NB))) launches
// (11 at n = 1280, 7 at n = 384):
//   - linv_diag_kernel, grid (ceil(n / NB), B): inverts one NB x NB
//     diagonal block L_kk in shared memory (a forward substitution, the
//     columns in parallel, four threads per column splitting each row's
//     sum, the rows in order) and writes W_kk and the exact zeros of W's
//     strict upper triangle in its block row. A ragged last block is
//     padded with the identity.
//   - merge levels s = NB, 2 NB, ... while s < n: the inverted diagonal
//     blocks of size s pair up, A = [2 p s, (2 p + 1) s) and
//     D = [(2 p + 1) s, min((2 p + 2) s, n)), and the merged inverse's
//     off-diagonal block is X = W[D, A] = -D^-1 (C A^-1), C = L[D, A].
//     linv_merge_ca_kernel computes T = C A^-1 into scratch (at most
//     ceil(n^2 / 4) floats per matrix, since the sum of |D| |A| over a
//     level's pairs is at most n^2 / 4), then linv_merge_x_kernel computes
//     X = -D^-1 T into W. Both are 64x64 output tiles over all pairs of
//     the level and the batch, with the 4x4 register tile and transposed
//     shared operands of chol_update_kernel, the next k-tile loaded into
//     registers while the current one is multiplied, and both skip the
//     k-tiles in which the triangular factor (A^-1 or D^-1) is zero.
// Every element of W is written by one block of one launch, no launch
// reads what it writes, and nothing depends on the batch. Identity-masked
// rows stay exact: their products are zeros.
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float PIVOT_FLOOR = 1e-30f;  // pallas_chol.py:72

constexpr int NB = 64;               // panel width = product tile edge
constexpr int NBL = NB + 1;          // padded row of a diagonal block
constexpr int TLD = NB + 4;          // row of a transposed panel tile (float4)
constexpr int RB = NTHREADS;         // panel rows per block, one per thread
static_assert(NTHREADS == 4 * NB,
              "four threads per row (factor_diag) or column (linv_diag)");
static_assert(NTHREADS == 16 * 16 && NB == 4 * 16, "4x4 tile per thread");

__host__ inline size_t diag_smem_bytes() {
  return sizeof(float) * NB * NBL;                   // one diagonal block
}

__host__ inline size_t update_smem_bytes() {
  return sizeof(float) * 2 * NB * TLD;               // two panel tiles
}

// floats of merge scratch per matrix: T of every pair of one level
__host__ __device__ inline size_t linv_scratch_floats(int n) {
  return ((size_t)n * n + 3) / 4;
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

// W's w x w diagonal block at k0 <- L_kk^-1 (exact zeros above the
// diagonal), and the rest of its block row right of it <- exact zeros.
__global__ void __launch_bounds__(NTHREADS)
linv_diag_kernel(const float* __restrict__ l, float* __restrict__ w, int n) {
  const size_t off = (size_t)blockIdx.y * n * n;
  float* W = w + off;
  const int k0 = blockIdx.x * NB, wk = min(NB, n - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = k0 + warp; i < k0 + wk; i += NWARPS)
    for (int j = k0 + wk + lane; j < n; j += 32) W[(size_t)i * n + j] = 0.f;
  extern __shared__ __align__(16) float dsm[];
  load_diag(l + off, n, k0, wk, dsm);
  __syncthreads();
  // L_kk X = I by columns: thread (c, p) solves column c and holds its rows
  // 4 i + p in x[i]; row r's sum over the rows before it is split over
  // the column's four threads (adjacent lanes) and summed by shuffles.
  // Rows not yet solved are still 0 in x, and L_kk is 0 above the
  // diagonal, so each thread may run its sum over every row it holds
  // below 4 ceil(r / 4).
  const int c = threadIdx.x >> 2, p = threadIdx.x & 3;
  float x[NB / 4];
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) x[i] = 0.f;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const float* row = dsm + r * NBL;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < (r + 3) / 4; ++i)
      sum = fmaf(row[4 * i + p], x[i], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float v = ((r == c ? 1.f : 0.f) - sum) / row[r];
    if ((r & 3) == p) x[r >> 2] = v;
  }
  if (c >= wk) return;
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) {
    const int r = 4 * i + p;
    if (r < wk) W[(size_t)(k0 + r) * n + k0 + c] = r >= c ? x[i] : 0.f;
  }
}

// acc[u][v] += sum over q < NB of sa[q][4 ty + u] sb[q][4 tx + v] for
// thread (ty, tx) = (tid / 16, tid % 16): rows 4 ty + u and columns
// 4 tx + v of a 64x64 tile; sa and sb are [NB][TLD] in shared memory.
// chol_update_kernel keeps its own copy of this loop: calling this one
// there made ptxas spill 8 bytes and chol 3 % slower at n = 1280 on an
// H100.
__device__ __forceinline__ void tile_fma(const float* sa, const float* sb,
                                         float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const float4 a4 = *reinterpret_cast<const float4*>(sa + q * TLD + 4 * ty);
    const float4 b4 = *reinterpret_cast<const float4*>(sb + q * TLD + 4 * tx);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
}

// One output tile of a merge product: acc[u][v] = sum over k in
// [k_lo, k_hi) of P[4 ty + u][k] Q[k][4 tx + v], k_lo and k_hi multiples
// of NB. Rows of P at or past hp and k at or past hk read as zeros (they
// may lie outside the matrix). sp and sq hold one k-tile of each operand,
// [NB][TLD]: sp[q][a] = P[a][k0 + q] (transposed), sq[q][b] = Q[k0 + q][b].
// Each thread loads its PER elements of the next k-tile into registers
// while the block multiplies the current one.
__device__ void merge_tile(const float* __restrict__ P, int ldp, int hp,
                           const float* __restrict__ Q, int ldq, int k_lo,
                           int k_hi, int hk, float* sp, float* sq,
                           float (&acc)[4][4]) {
  constexpr int PER = NB * NB / NTHREADS, RSTEP = NTHREADS / NB;
  // element i of this thread: row row0 + RSTEP i, column q of a k-tile
  const int q = threadIdx.x % NB, row0 = threadIdx.x / NB;
  float pr[PER], qr[PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int a = row0 + RSTEP * i;
      pr[i] = a < hp && k0 + q < hk ? P[(size_t)a * ldp + k0 + q] : 0.f;
      qr[i] = k0 + a < hk ? Q[(size_t)(k0 + a) * ldq + q] : 0.f;
    }
  };
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  load(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += NB) {
    __syncthreads();                   // the previous k-tile is read
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int a = row0 + RSTEP * i;
      sp[q * TLD + a] = pr[i];
      sq[a * TLD + q] = qr[i];
    }
    __syncthreads();
    if (k0 + NB < k_hi) load(k0 + NB);
    tile_fma(sp, sq, acc);
  }
}

// Pair p and output tile (rows i0, columns j0 of the |D| x s block) of a
// merge level s from blockIdx.x: the pairs' tiles in order,
// ceil(|D| / NB) x s / NB tiles each (only the last pair's D can be
// shorter than s).
struct MergeTile {
  int p, a0, d0, hd, i0, j0;
};

__device__ MergeTile merge_tile_of_block(int n, int s) {
  const int ta = s / NB, t = blockIdx.x;
  MergeTile m;
  m.p = t / (ta * ta);
  const int rem = t % (ta * ta);
  m.a0 = 2 * m.p * s;
  m.d0 = m.a0 + s;
  m.hd = min(s, n - m.d0);
  m.i0 = rem / ta * NB;
  m.j0 = rem % ta * NB;
  return m;
}

// T = C A^-1 for every pair of level s: T [|D|][s] at scratch offset
// p s^2 of the matrix's linv_scratch_floats(n). A^-1 is lower triangular,
// so output column tile tj needs only the k-tiles from tj on.
__global__ void __launch_bounds__(NTHREADS)
linv_merge_ca_kernel(const float* __restrict__ l, const float* __restrict__ w,
                     float* __restrict__ scratch, int n, int s) {
  const size_t off = (size_t)blockIdx.y * n * n;
  const MergeTile m = merge_tile_of_block(n, s);
  const int hi = min(NB, m.hd - m.i0);
  extern __shared__ __align__(16) float dsm[];
  float acc[4][4];
  merge_tile(l + off + (size_t)(m.d0 + m.i0) * n + m.a0, n, hi,
             w + off + (size_t)m.a0 * n + m.a0 + m.j0, n, m.j0, s, s, dsm,
             dsm + NB * TLD, acc);
  float* T = scratch + (size_t)blockIdx.y * linv_scratch_floats(n)
             + (size_t)m.p * s * s + (size_t)m.i0 * s + m.j0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (4 * ty + u < hi)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        T[(size_t)(4 * ty + u) * s + 4 * tx + v] = acc[u][v];
}

// W[D, A] = X = -D^-1 T for every pair of level s. D^-1 is lower
// triangular, so output row tile ti needs only the k-tiles up to ti.
__global__ void __launch_bounds__(NTHREADS)
linv_merge_x_kernel(const float* __restrict__ scratch, float* __restrict__ w,
                    int n, int s) {
  const size_t off = (size_t)blockIdx.y * n * n;
  const MergeTile m = merge_tile_of_block(n, s);
  const int hi = min(NB, m.hd - m.i0);
  const float* T = scratch + (size_t)blockIdx.y * linv_scratch_floats(n)
                   + (size_t)m.p * s * s;
  extern __shared__ __align__(16) float dsm[];
  float acc[4][4];
  merge_tile(w + off + (size_t)(m.d0 + m.i0) * n + m.d0, n, hi, T + m.j0, s,
             0, m.i0 + NB, m.hd, dsm, dsm + NB * TLD, acc);
  float* X = w + off + (size_t)(m.d0 + m.i0) * n + m.a0 + m.j0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (4 * ty + u < hi)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        X[(size_t)(4 * ty + u) * n + 4 * tx + v] = -acc[u][v];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at size n (bytes): the largest
// of chol's kernels' or of linv's (the product tiles'), whatever n.
long long chol_smem(int n) {
  (void)n;
  return (long long)(diag_smem_bytes() > update_smem_bytes()
                         ? diag_smem_bytes() : update_smem_bytes());
}
long long linv_smem(int n) { return chol_smem(n); }

// Floats of scratch per matrix that linv_launch needs at size n.
long long linv_scratch(int n) { return (long long)linv_scratch_floats(n); }

// CUDA kernel launches of one chol_launch at size n.
int chol_launch_count(int n) { return n <= 0 ? 0 : 1 + 2 * ((n - 1) / NB); }

// CUDA kernel launches of one linv_launch at size n: the diagonal
// inverses, then two per merge level.
int linv_launch_count(int n) {
  if (n <= 0) return 0;
  int count = 1;
  for (int s = NB; s < n; s *= 2) count += 2;
  return count;
}

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

// linv: the diagonal inverses and the merge levels, linv_launch_count(n)
// kernels in stream order; scratch holds b * linv_scratch(n) floats. It
// stops at the first launch that fails.
int linv_launch(const float* l, float* w, float* scratch, int b, int n,
                void* stream) {
  if (b > 65535) return (int)cudaErrorInvalidValue;  // grid.y holds the batch
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t sd = diag_smem_bytes(), su = update_smem_bytes();
  linv_diag_kernel<<<dim3((n + NB - 1) / NB, b), NTHREADS, sd, st>>>(l, w, n);
  cudaError_t err = cudaGetLastError();
  for (int s = NB; err == cudaSuccess && s < n; s *= 2) {
    // pairs with a non-empty D; only the last one's D can be short
    const int ta = s / NB, pairs = (n + s - 1) / s / 2;
    const int hd_last = min(s, n - (2 * pairs - 1) * s);
    const dim3 grid(((pairs - 1) * ta + (hd_last + NB - 1) / NB) * ta, b);
    linv_merge_ca_kernel<<<grid, NTHREADS, su, st>>>(l, w, scratch, n, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    linv_merge_x_kernel<<<grid, NTHREADS, su, st>>>(scratch, w, n, s);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* chol_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
