// The bf16 variance variant of the cluster-GP tile evaluation (2D and 3D),
// for NVIDIA Hopper (sm_90a).
//
// Replaces the bf16=True branch of the Pallas TPU kernel
// gpismap_tpu/ops/pallas_tile.py (tile_eval_pallas, :118; the branch at
// :95-104), the JAX package's opt-in GPISMAP_PALLAS_BF16 query path. It
// computes the function of the f32 kernel (tile_eval.cu) with the variance
// product in bf16: for each tile of T queries of one cluster cell
//   K*      [MP, T(1+D)] in f32 (kstar, tile_kstar.cuh),
//   f, g    = alpha^T K* in f32, bitwise the f32 kernel's,
//   V       = bf16(L^-1) bf16(K*) (round to nearest even), f32 sums,
//   vf, vg  = const - colsum(V^2) in f32.
// Tiles whose segment is -1 are skipped and their outputs left unwritten.
//
// What bounds it on the H100. The product leaves the fp32 pipe for the
// tensor cores (989 TFLOP/s dense bf16), so what is left is the K* entries
// (one sqrtf and one expf each, fp32) and the stream of L^-1 (f32, up to
// 6.55 MB a cell in 3D, read by every block of the cell's tiles through
// the 50 MB L2). Most of both is masked: a masked row of K* is zero and
// its row and column of L^-1 are the identity's, and the support lies in
// a prefix of each slot's node blocks, so whole 16-row stages are masked
// (PERF.md: 78 % of the product's multiply-adds at d=3, 96.5 % at d=2).
//
// Design: one block per (tile, BN K* columns), blockIdx.x = tile * n_cb +
// cb: BN = 128 and two warpgroups (256 threads) at d=2, BN = 64 and four
// warpgroups (512 threads) at d=3, where a full cell's resident K* leaves
// room for one block per SM and the K* build is bound by latency.
//   - Kept stages only. ops/tile_eval.py:kept_stages lists each slot's
//     16-row stages that hold a kept row (an f row of a valid node, a
//     gradient row of a node with gradflag * valid); the kernel packs them
//     (packed row 16 j + i is row 16 stages[j] + i) and skips the rest:
//     their K* rows, and their rows and columns of L^-1, add exact zeros.
//     In packed order L^-1 stays lower triangular.
//   - K* built once per block, held in shared memory. Each thread computes
//     8 rows (one half of a stage) of one column of each kept stage, in f32
//     with kstar, sums alpha K* over them with the f32 kernel's fmaf
//     chain and adds that into its half's partial in stage order (so the
//     two partials of a column are the f32 kernel's two chains, less
//     stages that add +0: f and g are bitwise the f32 kernel's). kstar
//     spells out its every rounding; the f32 kernel rounds the value
//     entry's 1 + a r split in its copy of stage 0 before its stage loop
//     and fused in the loop, so for a cell of one row panel (MP <= 128),
//     whose mean sums the pre-loop stage 0, this kernel names the split
//     rounding for stage 0 and the fused one elsewhere. Then it rounds the 8
//     entries to bf16 into one 16-byte row of the B operand's 8x8 core
//     matrices (K-major, no swizzle; ldmatrix reads them). At d=3 the
//     lanes l % 8 + 8 u (u < 4) take four stages at once and pass their
//     partials by shuffle. 160 KiB for a full 3D cell (80 stages of 16 x
//     64), 96 KiB in 2D.
//   - The product: a panel of 64 packed L^-1 rows per warpgroup (128 rows
//     at d=2, 256 at d=3), 16 per warp, one kept stage. Each warp streams
//     its own rows: the 16 x 16 f32 blocks of L^-1 (its rows x one kept
//     stage's columns) arrive by cp.async.cg 16-byte copies into its own
//     ring of NRING stages (1 KiB each, chunks swizzled for conflict-free
//     reads), issued by its lanes NRING - 1 stages ahead, from the first
//     one on, while K* is built, and released by __syncwarp: the k-loop
//     has no block or warpgroup barrier, and each warp's runs over the
//     kept stages up to its own rows'. Each k-step a warp reads its A
//     fragment from the ring, rounds it to bf16 (__floats2bfloat162_rn,
//     the plain version's rounding) and runs BN / 8 mma.sync.m16n8k16
//     with B by ldmatrix from the resident K* stage. One wgmma.m64nBNk16
//     a warpgroup in their place measured 2 % slower at d=2 and 20 % at
//     d=3 (PERF.md): with A in registers ptxas waits for each one, and
//     its warpgroup runs to its last warp's stage.
//   - At the end of a panel each thread adds the squares of its
//     accumulators into BN / 4 column partials; the epilogue sums the 8
//     row lanes of a column with fixed __shfl_xor_sync steps and the
//     warps through shared memory in a fixed order, so the kernel is free
//     of atomics and a tile's outputs are bitwise the same in any batch.
// What is left on the card (PERF.md): the K* entries (a sqrtf and an
// expf each, which a (node, query) pair could share across its 1 + D row
// blocks) and the k-steps' L^-1 copies, every block of a tile streaming
// the cell's L^-1 through L2 (8 blocks a tile at d=3).
// Shared memory: nk_cap stages of resident K* (nk_cap = the plan's largest
// kept-stage count, so small cells share an SM), the rings (48 KiB) and the
// cell's inputs: at most 226.1 KB (d=3, M=320) and 153.2 KB (d=2, M=128).
// At d=2 a thread keeps to 128 registers, so two blocks can share an SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_kstar.cuh"

namespace {

constexpr int SK = 16;               // rows of a stage
// the f32 kernel's row panel (tile_eval.cu BM)
constexpr int F32_PANEL = 128;
// a core matrix of the K* operand: 8 columns x 8 rows of K (16 B a column)
constexpr int CORE_K_BYTES = 128;    // to the next 8 rows of K
constexpr int CORE_N_BYTES = 256;    // to the next 8 columns

// The block at dimension D: BN K* columns, NTHREADS threads in
// warpgroups of 64 packed L^-1 rows each (a panel of PM rows, SPP kept
// stages), each with a ring of NRING L^-1 stages of 64 x 16 floats (rows
// of four 16-byte chunks); the K* build takes PAR stages at once, CPW
// columns a warp.
template <int D>
struct Shape {
  static constexpr int BN = D == 2 ? 128 : 64;
  static constexpr int NTHREADS = D == 2 ? 256 : 512;
  static constexpr int NWARPS = NTHREADS / 32;
  static constexpr int PM = NTHREADS / 2;
  static constexpr int SPP = PM / SK;
  static constexpr int NRING = D == 2 ? 6 : 3;
  // blocks an SM is to hold: at d=2 two (a thread keeps to 128
  // registers), if the resident K* leaves the shared memory for them
  static constexpr int MIN_BLOCKS = D == 2 ? 2 : 1;
  static constexpr int W_RING_FLOATS = SK * SK;
  static constexpr int PAR = NTHREADS / (2 * BN);
  static constexpr int CPW = 32 / PAR;
  static_assert(BN <= NRING * W_RING_FLOATS,
                "the epilogue's partials fit the rings");
};

template <int D>
size_t smem_bytes(int m, int nk_cap) {
  using S = Shape<D>;
  const size_t mp = (size_t)m * (1 + D), ns = (mp + SK - 1) / SK;
  return (size_t)nk_cap * S::BN * SK * 2 +
         (size_t)S::NWARPS * S::NRING * S::W_RING_FLOATS * 4 +
         4 * ((D + 2) * (size_t)m + mp + D * S::BN + 2 * S::BN + ns);
}

// float offset of chunk q (4 floats) of ring row r: the chunks of rows
// with bit 1 set are swapped in pairs (q ^ 2), so that the A-fragment
// reads of 8 rows (float2 at columns 2 tq, 2 tq + 8) hit 32 banks
__device__ __forceinline__ int ring_at(int r, int q) {
  return r * SK + 4 * (q ^ (r & 2));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fill the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes global -> shared (a row of L^-1 that is not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c += a b on one m16n8k16 tile: bf16 multiplicands, f32 accumulators
// (c0, c1: row lane / 4, columns 2 (lane % 4) + 0, 1; c2, c3: row + 8)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same k-step of one warp on mma.sync: BN / 8 m16n8k16 tiles, B
// fragments by ldmatrix from the K* stage's core matrices.
template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2],
                                         const uint32_t (&af)[4],
                                         const __nv_bfloat16* kb, int lane) {
  const uint32_t base = smem_addr(kb) + (lane >> 4) * CORE_N_BYTES +
                        ((lane >> 3) & 1) * CORE_K_BYTES + (lane & 7) * 16;
#pragma unroll
  for (int np = 0; np < BN / 16; ++np) {
    uint32_t r[4];
    ldsm_x4(r, base + 2 * np * CORE_N_BYTES);
    mma_bf16(acc + 8 * np, af, r[0], r[1]);
    mma_bf16(acc + 8 * np + 4, af, r[2], r[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::NTHREADS, Shape<D>::MIN_BLOCKS)
tile_eval_bf16_kernel(const int* __restrict__ tile_seg,
                      const float* __restrict__ linv,
                      const float* __restrict__ xt,
                      const float* __restrict__ alpha,
                      const float* __restrict__ gradflag,
                      const float* __restrict__ valid,
                      const float* __restrict__ qt,
                      const int* __restrict__ stages,
                      const int* __restrict__ counts,
                      float* __restrict__ f_out, float* __restrict__ g_out,
                      float* __restrict__ vf_out, float* __restrict__ vg_out,
                      int n_seg, int m, int t, int nk_cap, float scale,
                      float val_const, float grad_const) {
  using S = Shape<D>;
  constexpr int BN = S::BN, NTHREADS = S::NTHREADS, PAR = S::PAR;
  constexpr int CPW = S::CPW, SPP = S::SPP, NRING = S::NRING;
  constexpr int W_RING_FLOATS = S::W_RING_FLOATS;
  constexpr int NACC = BN / 2;                  // accumulators a thread
  const int nc = t * (1 + D);
  const int n_cb = (nc + BN - 1) / BN;
  const int tile = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  const int seg = tile_seg[tile];
  if (seg < 0 || seg >= n_seg) return;          // inactive tile
  const int mp = m * (1 + D), ns = (mp + SK - 1) / SK;
  const int nk = counts[seg];
  if (nk > nk_cap) __trap();                    // the wrapper sizes nk_cap
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  // [nk_cap][BN / 8][2][8][8] bf16: resident K*, one stage a B operand
  __nv_bfloat16* kres = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ring = reinterpret_cast<float*>(smem + (size_t)nk_cap * BN * SK * 2);
  float* xsm = ring + S::NWARPS * NRING * W_RING_FLOATS;  // [D][m]
  float* vms = xsm + D * m;                     // [m] valid
  float* gms = vms + m;                         // [m] gradflag * valid
  float* als = gms + m;                         // [mp] alpha
  float* qsm = als + mp;                        // [D][BN]
  float* msm = qsm + D * BN;                    // [2][BN] mean halves
  int* kst = reinterpret_cast<int*>(msm + 2 * BN);   // [ns] kept stages

  const float a = SQRT3 / scale;
  const float a2 = a * a;
  const float* L = linv + (size_t)seg * mp * mp;

  // ---- the cell's inputs, its kept stages and this block's queries ----
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
    for (int p = tid; p < nk; p += NTHREADS)
      kst[p] = stages[(size_t)seg * ns + p];
    for (int p = tid; p < D * BN; p += NTHREADS) {
      const int i = p / BN, gc = cb * BN + p % BN;
      qsm[p] = gc < nc ? qs[i * t + gc % t] : 0.f;
    }
  }
  __syncthreads();

  // ---- the L^-1 rings, one per warp: its item (panel p, kept stage j)
  // is the 16 x 16 f32 block of its packed rows (kept stage
  // w_stage(p)) and the columns of stage j, for the stages up to its
  // own rows'; the warp takes part in panel p if w_stage(p) < nk. Rows
  // and columns past mp are zero-filled ----
  const int n_panels = (nk + SPP - 1) / SPP;
  auto w_stage = [&](int p) { return SPP * p + warp; };
  float* wring = ring + warp * NRING * W_RING_FLOATS;
  const bool vec = (mp & 3) == 0 && ((size_t)linv & 15) == 0;
  int ip = 0, ij = 0, islot = 0;                // the next item to copy
  auto issue_next = [&]() {
    if (w_stage(ip) < nk) {
      float* dst = wring + islot * W_RING_FLOATS;
      const int c0 = SK * kst[ij], sr = w_stage(ip);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, r = c >> 2, col = c0 + 4 * (c & 3);
        const int row = SK * kst[sr] + r;
        float* d = dst + ring_at(r, c & 3);
        const float* src = L + (size_t)row * mp + col;
        if (vec) {
          const bool ok = row < mp && col < mp;
          cp_async16(d, ok ? src : L, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row < mp && col + e < mp;
            cp_async4(d + e, ok ? src + e : L, ok ? 4 : 0);
          }
        }
      }
      if (++ij > w_stage(ip)) {
        ++ip;
        ij = 0;
      }
      islot = islot == NRING - 1 ? 0 : islot + 1;
    }
    cp_async_commit();                          // one group per call
  };
#pragma unroll
  for (int s = 0; s < NRING - 1; ++s) issue_next();

  // ---- K*: this thread's column, half (rows 8 half .. of a stage) and
  // stage parity (d=3: lanes l % 8 + 8 q take stages PAR i + q) ----
  const int col = CPW * (warp % (BN / CPW)) + lane % CPW;
  const int half = warp / (BN / CPW);
  const int parity = lane / CPW;
  const int gcol = cb * BN + col;
  const int cblk = gcol < nc ? gcol / t : -1;
  // each kept stage of K* into kres, its alpha-weighted 8-row sum added
  // to this half's mean chain in stage order
  float mean_h = 0.f;
  {
    float q[D];
#pragma unroll
    for (int i = 0; i < D; ++i) q[i] = qsm[i * BN + col];
    for (int j0 = 0; j0 < nk; j0 += PAR) {
      const int j = j0 + parity;
      float ms = 0.f;
      if (j < nk) {
        const int r0 = SK * kst[j] + 8 * half;
        int rb = r0 / m, k = r0 - rb * m;
        // the f32 kernel's stage 0 before its stage loop (the one its
        // mean sums in a cell of one row panel)
        const bool split = mp <= F32_PANEL && kst[j] == 0;
        float kv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = 0.f;
          if (cblk >= 0 && r0 + i < mp) {
            v = split ? kstar<D, SPLIT_1AR>(rb, k, cblk, q, xsm, vms, gms, m,
                                            a, a2)
                      : kstar<D, FUSED_1AR>(rb, k, cblk, q, xsm, vms, gms, m,
                                            a, a2);
            ms = fmaf(als[r0 + i], v, ms);
          }
          kv[i] = v;
          if (++k == m) {
            k = 0;
            ++rb;
          }
        }
        uint4 u;
        u.x = bf16x2(kv[0], kv[1]);
        u.y = bf16x2(kv[2], kv[3]);
        u.z = bf16x2(kv[4], kv[5]);
        u.w = bf16x2(kv[6], kv[7]);
        *reinterpret_cast<uint4*>(
            reinterpret_cast<unsigned char*>(kres) + (size_t)j * BN * SK * 2 +
            (col >> 3) * CORE_N_BYTES + half * CORE_K_BYTES +
            (col & 7) * 16) = u;
      }
      if constexpr (PAR == 1) {
        mean_h += ms;
      } else {
#pragma unroll
        for (int u = 0; u < PAR; ++u) {
          const float s_u =
              __shfl_sync(0xffffffffu, ms, lane % CPW + CPW * u);
          if (j0 + u < nk) mean_h += s_u;
        }
      }
    }
  }
  __syncthreads();                               // K* is resident

  // ---- the product over the packed rows, panel by panel, each
  // warp on its own rows and ring ----
  const int g = lane >> 2, tq = lane & 3;
  float sq[BN / 4];
#pragma unroll
  for (int v = 0; v < BN / 4; ++v) sq[v] = 0.f;
  int slot = 0;
  for (int p = 0; p < n_panels; ++p) {
    const int jm = w_stage(p);
    if (jm >= nk) continue;                      // nothing of this warp's
    float acc[NACC];
#pragma unroll
    for (int v = 0; v < NACC; ++v) acc[v] = 0.f;
    for (int j = 0; j <= jm; ++j) {
      // this item's copies, and the whole warp's (which has read the slot
      // that issue_next refills)
      cp_async_wait<NRING - 2>();
      __syncwarp();
      issue_next();
      const float* sl = wring + slot * W_RING_FLOATS;
      slot = slot == NRING - 1 ? 0 : slot + 1;
      const float2 x0 = *reinterpret_cast<const float2*>(
          sl + ring_at(g, tq >> 1) + 2 * (tq & 1));
      const float2 x1 = *reinterpret_cast<const float2*>(
          sl + ring_at(g + 8, tq >> 1) + 2 * (tq & 1));
      const float2 x2 = *reinterpret_cast<const float2*>(
          sl + ring_at(g, 2 + (tq >> 1)) + 2 * (tq & 1));
      const float2 x3 = *reinterpret_cast<const float2*>(
          sl + ring_at(g + 8, 2 + (tq >> 1)) + 2 * (tq & 1));
      uint32_t af[4];
      af[0] = bf16x2(x0.x, x0.y);
      af[1] = bf16x2(x1.x, x1.y);
      af[2] = bf16x2(x2.x, x2.y);
      af[3] = bf16x2(x3.x, x3.y);
      const __nv_bfloat16* kb = kres + (size_t)j * BN * SK;
      mma_step<BN>(acc, af, kb, lane);
    }
    // acc[4 i + b] is row g, column 8 i + 2 tq + b; acc[4 i + 2 + b] row
    // g + 8 of the same column
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        sq[2 * i + b] = fmaf(acc[4 * i + b], acc[4 * i + b], sq[2 * i + b]);
        sq[2 * i + b] =
            fmaf(acc[4 * i + 2 + b], acc[4 * i + 2 + b], sq[2 * i + b]);
      }
  }

  // ---- column sums: the 8 row lanes by shuffles, then the warps and
  // the two mean halves through shared memory, in a fixed order ----
  cp_async_wait<0>();
  __syncthreads();                               // the ring is free
  float* red = ring;                             // [NWARPS][BN]
#pragma unroll
  for (int v = 0; v < BN / 4; ++v) {
    sq[v] += __shfl_xor_sync(0xffffffffu, sq[v], 4);
    sq[v] += __shfl_xor_sync(0xffffffffu, sq[v], 8);
    sq[v] += __shfl_xor_sync(0xffffffffu, sq[v], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      red[warp * BN + 8 * i + 2 * lane] = sq[2 * i];
      red[warp * BN + 8 * i + 2 * lane + 1] = sq[2 * i + 1];
    }
  }
  if (parity == 0) msm[half * BN + col] = mean_h;
  __syncthreads();
  if (tid < BN && cb * BN + tid < nc) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < S::NWARPS; ++w) s += red[w * BN + tid];
    const float mean = msm[tid] + msm[BN + tid];
    const int gc = cb * BN + tid, blk = gc / t, qj = gc % t;
    if (blk == 0) {
      f_out[(size_t)tile * t + qj] = mean;
      vf_out[(size_t)tile * t + qj] = val_const - s;
    } else {
      g_out[((size_t)tile * D + blk - 1) * t + qj] = mean;
      vg_out[((size_t)tile * D + blk - 1) * t + qj] = grad_const - s;
    }
  }
}

template <int D>
int launch(const int* tile_seg, const float* linv, const float* xt,
           const float* alpha, const float* gradflag, const float* valid,
           const float* qt, const int* stages, const int* counts,
           float* f_out, float* g_out, float* vf_out, float* vg_out, int nt,
           int n_seg, int m, int t, int nk_cap, float scale, float val_const,
           float grad_const, cudaStream_t stream) {
  constexpr int BN = Shape<D>::BN;
  auto kernel = tile_eval_bf16_kernel<D>;
  const size_t smem = smem_bytes<D>(m, nk_cap);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_cb = ((long long)t * (1 + D) + BN - 1) / BN;
  const long long n_blocks = (long long)nt * n_cb;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)n_blocks, Shape<D>::NTHREADS, smem, stream>>>(
      tile_seg, linv, xt, alpha, gradflag, valid, qt, stages, counts, f_out,
      g_out, vf_out, vg_out, n_seg, m, t, nk_cap, scale, val_const,
      grad_const);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs at dimension d, support size m and at
// most nk_cap kept stages a slot (bytes; 0 for a d the kernel does not
// take).
long long tile_eval_bf16_smem_bytes(int d, int m, int nk_cap) {
  if (d == 2) return (long long)smem_bytes<2>(m, nk_cap);
  if (d == 3) return (long long)smem_bytes<3>(m, nk_cap);
  return 0;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a d other than 2 or 3. stages [S, ceil(MP /
// 16)] and counts [S] are ops/tile_eval.py:kept_stages'; nk_cap is at
// least every count of a slot that an active tile reads.
int tile_eval_bf16_launch(const int* tile_seg, const float* linv,
                          const float* xt, const float* alpha,
                          const float* gradflag, const float* valid,
                          const float* qt, const int* stages,
                          const int* counts, float* f_out, float* g_out,
                          float* vf_out, float* vg_out, int nt, int n_seg,
                          int d, int m, int t, int nk_cap, float scale,
                          float val_const, float grad_const, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch<2>(tile_seg, linv, xt, alpha, gradflag, valid, qt, stages,
                     counts, f_out, g_out, vf_out, vg_out, nt, n_seg, m, t,
                     nk_cap, scale, val_const, grad_const, s);
  if (d == 3)
    return launch<3>(tile_seg, linv, xt, alpha, gradflag, valid, qt, stages,
                     counts, f_out, g_out, vf_out, vg_out, nt, n_seg, m, t,
                     nk_cap, scale, val_const, grad_const, s);
  return (int)cudaErrorInvalidValue;
}

const char* tile_eval_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
