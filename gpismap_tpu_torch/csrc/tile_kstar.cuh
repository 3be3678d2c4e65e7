// The K* entry of the cluster-GP tile evaluation, shared by the f32 tile
// kernel (tile_eval.cu) and its bf16 instance (tile_eval_bf16.cu): the
// bf16 kernel's f and g are bitwise the f32 kernel's only while both
// compute K* with this same code.
#pragma once

namespace {

constexpr float SQRT3 = 1.7320508075688772f;

// K*[r][c] for support row r < MP (row block rb = r / m, node k = r % m)
// and a column of derivative block cblk in 0..D whose query is q, as
// gpismap_tpu/ops/pallas_tile.py:59-82 builds it: row block 0 masked by
// valid, the gradient blocks by gradflag * valid.
// ONE_AR says how the value entry's 1 + a r is rounded: 0 as nvcc
// contracts it where kstar is inlined (the f32 kernel's instance), 1 as
// one fused multiply-add, 2 as the rounded product a r plus 1. nvcc
// fuses it in some of the f32 kernel's inlined copies and not in others
// (tile_eval_bf16.cu says which); the bf16 kernel names the rounding of
// each copy so that its f is bitwise the f32 kernel's.
template <int D, int ONE_AR = 0>
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
    if constexpr (ONE_AR == 1)
      return cblk == 0 ? fmaf(a, r, 1.f) * e * vm : a2 * dc * e * vm;
    else if constexpr (ONE_AR == 2)
      return cblk == 0 ? __fadd_rn(1.f, __fmul_rn(a, r)) * e * vm
                       : a2 * dc * e * vm;
    else
      return cblk == 0 ? (1.f + a * r) * e * vm : a2 * dc * e * vm;
  }
  const float gm = gms[k];
  if (cblk == 0) return -(a2 * dr * e) * gm;
  const float inv_r = r > 0.f ? 1.f / r : 0.f;
  return a2 * ((rb == cblk ? 1.f : 0.f) - a * dr * dc * inv_r) * e * gm;
}

}  // namespace
