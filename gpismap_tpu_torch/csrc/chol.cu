// Batched Cholesky factor and lower-triangular inverse of the cluster-GP
// systems, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of gpismap_tpu/ops/pallas_chol.py:
//   chol_kernel  <- chol_pallas (_chol_kernel, _chol_base): lower L with
//                   L L^T = K for SPD K [B, n, n]; strict upper triangle
//                   written as exact zeros; a non-positive pivot is clamped
//                   to sqrt(1e-30) as at pallas_chol.py:72
//                   (torch.linalg.cholesky raises there instead);
//   linv_kernel  <- linv_pallas (_linv_kernel, _inv_lower_base): W = L^-1
//                   of lower-triangular L [B, n, n] by blocked forward
//                   substitution; strict upper triangle exact zeros (the
//                   tile kernel, csrc/tile_eval.cu, skips it and relies on
//                   them).
// n <= 512, fp32 FMAs only: no TF32 and no tensor cores (the map query's
// variance is a cancellation, const - ||L^-1 k*||^2).
//
// What bounds them on the H100. Both are n^3/6 multiply-adds per matrix
// (9.4 M at n = 384) on dependent 32-wide steps, so latency along the
// chain of panels bounds a small batch and the fp32 FMA rate fed from
// shared memory a large one (measured: B = 8 costs about what B = 64
// does at n = 384, so one block's chain of panels is the bound there). One [384, 384] f32 matrix is 576 KB, above the
// 227 KB of shared memory a block may use, where the Pallas kernels held
// whole chunks of matrices in VMEM (pallas_chol.py:156-163). Here each
// matrix lives in device memory and the L2: the retrain batch (at most
// 64 x 576 KB = 37.7 MB) fits the 50 MB L2; the factor-cache fill (up to
// 512 matrices, 302 MB) streams from HBM.
//
// chol design: one block per matrix, right-looking over 32-wide column
// panels. The diagonal 32x32 block is factored in shared memory by one
// warp (lane = row); the panel below it is solved against that block in
// shared memory (thread = row) and kept there; the trailing lower triangle
// is updated in place in global memory, tile by tile, from the panel in
// shared memory. One block per matrix leaves SMs idle when B < 132 (the
// retrain's B is 8 to 64); splitting a matrix over several blocks, or
// fusing chol and linv, is left to a later change.
//
// linv design: column panel k of W depends only on L and on W[., k]
// itself (pallas_chol.py:141-153), so one block per (matrix, 32-column
// panel): B * n/32 blocks, which fills the card even at B = 8. The block
// walks down its panel in 32-row blocks: S = L[I, k0:i0] W[k0:i0, k] from
// the panel rows already done (kept in shared memory), then a forward
// substitution with the diagonal block L[I, I] (one warp, lane = column).
#include <cuda_runtime.h>

namespace {

constexpr int PW = 32;               // panel width and row-block height
constexpr int LD = PW + 1;           // padded shared row: conflict-free column reads
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RPW = PW / NWARPS;     // rows per warp in a 32x32 tile (4)
constexpr float PIVOT_FLOOR = 1e-30f;  // pallas_chol.py:72

__host__ inline size_t chol_smem_bytes(int n) {
  return sizeof(float) * (size_t)(n + PW) * LD;      // diagonal block + panel
}

__host__ inline size_t linv_smem_bytes(int n) {
  return sizeof(float) * ((size_t)n + 2 * PW) * LD;  // W panel + 2 blocks
}

__global__ void __launch_bounds__(NTHREADS)
chol_kernel(const float* __restrict__ k, float* __restrict__ l, int n) {
  const size_t off = (size_t)blockIdx.x * n * n;
  const float* A = k + off;
  float* L = l + off;                  // working matrix, factored in place
  extern __shared__ float smem[];
  float* dg = smem;                    // [PW][LD] diagonal block
  float* pn = smem + PW * LD;          // [n - PW][LD] panel rows below it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. L <- lower triangle of K, exact zeros above the diagonal
  for (int i = warp; i < n; i += NWARPS)
    for (int j = lane; j < n; j += 32)
      L[(size_t)i * n + j] = j <= i ? A[(size_t)i * n + j] : 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += PW) {
    const int w = min(PW, n - k0);     // panel width
    const int r0 = k0 + w;             // first row below the panel
    const int nr = n - r0;             // rows below the panel

    // 1. diagonal block into shared memory (identity outside the matrix)
    for (int p = tid; p < PW * PW; p += NTHREADS) {
      const int r = p / PW, c = p % PW;
      float v = r == c ? 1.f : 0.f;
      if (r < w && c <= r) v = L[(size_t)(k0 + r) * n + k0 + c];
      dg[r * LD + c] = v;
    }
    __syncthreads();

    // 2. factor it: one warp, lane = row, right-looking
    if (warp == 0) {
      for (int j = 0; j < PW; ++j) {
        if (lane == j)
          dg[j * LD + j] = sqrtf(fmaxf(dg[j * LD + j], PIVOT_FLOOR));
        __syncwarp();
        if (lane > j) dg[lane * LD + j] /= dg[j * LD + j];
        __syncwarp();
        if (lane > j) {
          const float lj = dg[lane * LD + j];
          for (int c = j + 1; c <= lane; ++c)
            dg[lane * LD + c] = fmaf(-lj, dg[c * LD + j], dg[lane * LD + c]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int p = tid; p < w * w; p += NTHREADS) {
      const int r = p / w, c = p % w;
      if (c <= r) L[(size_t)(k0 + r) * n + k0 + c] = dg[r * LD + c];
    }
    if (nr <= 0) break;

    // 3. panel below: X Lkk^T = P, solved row by row in shared memory
    for (int p = tid; p < nr * PW; p += NTHREADS) {
      const int r = p / PW, c = p % PW;
      pn[r * LD + c] = c < w ? L[(size_t)(r0 + r) * n + k0 + c] : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < nr; r += NTHREADS) {
      float* x = pn + r * LD;
      for (int j = 0; j < w; ++j) {
        float s = x[j];
        for (int q = 0; q < j; ++q) s = fmaf(-x[q], dg[j * LD + q], s);
        x[j] = s / dg[j * LD + j];
      }
    }
    __syncthreads();
    for (int p = tid; p < nr * w; p += NTHREADS) {
      const int r = p / w, c = p % w;
      L[(size_t)(r0 + r) * n + k0 + c] = pn[r * LD + c];
    }

    // 4. trailing lower triangle: A[i][j] -= X[i] . X[j], r0 <= j <= i,
    // in 32x32 tiles; thread (warp, lane) takes column lane and rows
    // warp + NWARPS q of each tile
    const int nt = (nr + PW - 1) / PW;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj <= ti; ++tj) {
        const int j = tj * PW + lane;
        float xj[PW];
#pragma unroll
        for (int q = 0; q < PW; ++q) xj[q] = j < nr ? pn[j * LD + q] : 0.f;
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const int i = ti * PW + warp + NWARPS * rr;
          if (i < nr && j <= i) {
            const float* xi = pn + i * LD;
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < PW; ++q) acc = fmaf(xi[q], xj[q], acc);
            float* a = L + (size_t)(r0 + i) * n + r0 + j;
            *a -= acc;
          }
        }
      }
    }
    __syncthreads();
  }
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

// Shared memory one block needs at size n (bytes).
long long chol_smem(int n) { return (long long)chol_smem_bytes(n); }
long long linv_smem(int n) { return (long long)linv_smem_bytes(n); }

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
int chol_launch(const float* k, float* l, int b, int n, void* stream) {
  const size_t smem = chol_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chol_kernel<<<b, NTHREADS, smem, (cudaStream_t)stream>>>(k, l, n);
  return (int)cudaGetLastError();
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
