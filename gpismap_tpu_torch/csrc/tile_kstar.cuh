// The K* entry of the cluster-GP tile evaluation, shared by the f32 tile
// kernel (tile_eval.cu), its bf16 instance (tile_eval_bf16.cu) and the
// backward kernels (tile_eval_backward.cu); with its derivatives for the
// backward. Every sum of a product is spelled out as rounded intrinsics
// (__fmaf_rn, or __fmul_rn and __fadd_rn), so nvcc contracts nothing on
// its own and an entry rounds the same wherever it is inlined, under any
// nvcc. The roundings are those nvcc 12.9 chose for the f32 kernel
// before they were spelled out, so its outputs kept every bit. Only the
// value entry's 1 + a r rounds two ways there (fused in the stage loop,
// split in the copy before it): each call site names its way (ONE_AR),
// and the bf16 kernel names the f32 kernel's stage by stage, so that its
// f and g stay bitwise the f32 kernel's.
#pragma once

namespace {

constexpr float SQRT3 = 1.7320508075688772f;
// how kstar rounds the value entry's 1 + a r: one fused multiply-add, or
// the rounded product a r plus 1
constexpr int FUSED_1AR = 1, SPLIT_1AR = 2;

// Delta = x_k - q and r = |Delta|, rounded as kstar rounds them: r^2 as
// fma(Delta_0, Delta_0, Delta_1^2), then + Delta_2^2 fused (D = 3)
template <int D>
__device__ __forceinline__ float kstar_delta(int k, const float (&q)[D],
                                             const float* xsm, int m,
                                             float (&dd)[D]) {
  static_assert(D == 2 || D == 3, "D");
#pragma unroll
  for (int i = 0; i < D; ++i) dd[i] = xsm[i * m + k] - q[i];
  float r2 = __fmaf_rn(dd[0], dd[0], __fmul_rn(dd[1], dd[1]));
  if constexpr (D == 3) r2 = __fmaf_rn(dd[2], dd[2], r2);
  return __fsqrt_rn(r2);
}

// K*[r][c] for support row r < MP (row block rb = r / m, node k = r % m)
// and a column of derivative block cblk in 0..D whose query is q, as
// gpismap_tpu/ops/pallas_tile.py:59-82 builds it: row block 0 masked by
// valid, the gradient blocks by gradflag * valid.
template <int D, int ONE_AR>
__device__ __forceinline__ float kstar(int rb, int k, int cblk,
                                       const float (&q)[D], const float* xsm,
                                       const float* vms, const float* gms,
                                       int m, float a, float a2) {
  float dd[D];
  const float r = kstar_delta<D>(k, q, xsm, m, dd);
  const float e = expf(-a * r);
  float dr = 0.f, dc = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (rb == 1 + i) dr = dd[i];
    if (cblk == 1 + i) dc = dd[i];
  }
  static_assert(ONE_AR == FUSED_1AR || ONE_AR == SPLIT_1AR, "ONE_AR");
  if (rb == 0) {
    const float vm = vms[k];
    const float one_ar = ONE_AR == FUSED_1AR
                             ? __fmaf_rn(a, r, 1.f)
                             : __fadd_rn(1.f, __fmul_rn(a, r));
    return cblk == 0 ? one_ar * e * vm : a2 * dc * e * vm;
  }
  const float gm = gms[k];
  if (cblk == 0) return -(a2 * dr * e) * gm;
  const float inv_r = r > 0.f ? 1.f / r : 0.f;
  return a2 * __fmaf_rn(-(a * dr * dc), inv_r, rb == cblk ? 1.f : 0.f) * e *
         gm;
}

// kstar's entry with its derivatives: returns kstar<D, FUSED_1AR>'s
// K*[r][c] and sets gd[l] = dK*/dDelta_l (Delta = x_k - q, so d/dx_k = gd and d/dq
// = -gd) and ga = dK*/da, a = sqrt(3) / scale (d/dscale = -(a / scale)
// ga). With P = Delta_i Delta_j / r and w = delta_ij - a P:
//   f,f:   (1 + a r) e        gd_l = -a^2 e Delta_l
//                             ga   = -a r^2 e
//   f,g_i: a^2 Delta_i e      gd_l = a^2 e (delta_il - a Delta_i Delta_l / r)
//                             ga   = a Delta_i e (2 - a r)
//   g_i,f: the negative of f,g_i
//   g_i,g_j: a^2 w e          gd_l = -a^3 e ((delta_il Delta_j +
//                                     delta_jl Delta_i) / r
//                                     - P Delta_l / r^2 + w Delta_l / r)
//                             ga   = a e ((2 - a r) w - a P)
// times the row's mask. 1 / r is taken as 0 at r = 0, as the plain
// version's inv_r is: at a coincident (node, query) pair every gd is 0
// (the plain version's sqrt backward gives NaN there) and ga is finite
// (2 a e delta_ij on the gradient-by-gradient entries, 0 elsewhere), as
// the plain version's scale gradient is.
template <int D>
__device__ __forceinline__ float kstar_grad(int rb, int k, int cblk,
                                            const float (&q)[D],
                                            const float* xsm,
                                            const float* vms,
                                            const float* gms, int m, float a,
                                            float a2, float (&gd)[D],
                                            float& ga) {
  const float val =
      kstar<D, FUSED_1AR>(rb, k, cblk, q, xsm, vms, gms, m, a, a2);
  float dd[D];
  const float r = kstar_delta<D>(k, q, xsm, m, dd);
  const float e = expf(-a * r);
  const float msk = rb == 0 ? vms[k] : gms[k];
  float dr = 0.f, dc = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (rb == 1 + i) dr = dd[i];
    if (cblk == 1 + i) dc = dd[i];
  }
  const float inv_r = r > 0.f ? 1.f / r : 0.f;
  const float a2e = a2 * e * msk;
  if (rb == 0 && cblk == 0) {
#pragma unroll
    for (int l = 0; l < D; ++l) gd[l] = -a2e * dd[l];
    ga = -a * r * r * e * msk;
    return val;
  }
  if (rb == 0 || cblk == 0) {
    // f,g_i (rb == 0) or g_i,f: i = the gradient block's axis
    const float di = rb == 0 ? dc : dr;
    const float sgn = rb == 0 ? 1.f : -1.f;
#pragma unroll
    for (int l = 0; l < D; ++l)
      gd[l] = sgn * a2e *
              ((rb + cblk == 1 + l ? 1.f : 0.f) - a * di * dd[l] * inv_r);
    ga = sgn * a * di * e * (2.f - a * r) * msk;
    return val;
  }
  const float p = dr * dc * inv_r;
  const float w = (rb == cblk ? 1.f : 0.f) - a * p;
  const float a3e = a * a2e;
#pragma unroll
  for (int l = 0; l < D; ++l)
    gd[l] = -a3e * (((rb == 1 + l ? dc : 0.f) + (cblk == 1 + l ? dr : 0.f)) *
                        inv_r -
                    p * dd[l] * inv_r * inv_r + w * dd[l] * inv_r);
  ga = a * e * ((2.f - a * r) * w - a * p) * msk;
  return val;
}

}  // namespace
