// The 2D frame's observation-GP stages, re-evaluation of the map's nodes
// and evaluation of the new measurements, as one kernel for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these stages in XLA
// (gpismap_tpu/models/mapper2d.py: reeval_2d, newmeas_2d). Their plain
// PyTorch versions are mapper2d.reeval_2d_reference and
// newmeas_2d_reference in the port, which issue about 1,370 small torch
// operations a frame (10 masked re-localization steps, each a chunked
// obsgp1d_test gather and its elementwise tail, then four probes, the
// noise model and the fusion): host dispatch, not arithmetic, bounded
// the stage. This kernel computes the same outputs in one launch.
//
// What bounds it on the H100. The arithmetic is tiny: at most 15
// obs-GP posteriors a node (1 + 10 steps + 4 probes) and 5 a beam, each
// ~26 exps and a 26 x 26 matrix-vector product (~1,400 flops): about 0.07
// GFLOP for 1,024 nodes and 2,048 beams, microseconds at the fp32 rate.
// The factors it reads (x, alpha, L^-1 of <= 104 groups, ~0.3 MB) stay in
// L2. A node's 15 posteriors are a chain (each step's query depends on
// the last posterior), so latency bounds it: the length of that chain,
// each link a group lookup, a shuffle-fed product and two warp sums.
//
// Design: one warp per item, nodes first ([0, k)), then beams
// ([k, k + n)), 8 warps a block. Every lane of a warp holds the same
// scalar state, so every branch is warp-uniform:
//   - obs_test: one obs-GP posterior (models/obsgp.py: obsgp1d_test) at
//     angle q. The owning group is the count of bounds[1:] < q, by ballot
//     and popcount 32 bounds at a time; the margin, strict-bound and
//     trained checks give the sentinel (mean 0, variance 1e6). Lane i < m
//     computes K*_i and row i of L^-1 K*, K* broadcast by shuffle; the
//     mean and ||L^-1 K*||^2 are butterfly sums (xor shuffles), which
//     leave the same bits on every lane. x, alpha and L^-1 are read in
//     place; L^-1 by its strides (torch.linalg.solve_triangular may leave
//     it column-major on the card).
//   - node_item: reeval_2d_reference (GPisMap.cpp:235-455): the 10-step
//     re-localization in registers, leaving the loop when the node stops
//     (a masked step of the plain loop changes nothing), then the four
//     probes, the noise model, the fusion and the action.
//   - beam_item: newmeas_2d_reference (GPisMap.cpp:466-572).
// Every output goes to one packed float32 buffer (mapper2d's layout:
// NODE_WORDS per node, then BEAM_WORDS per beam; the int32 fields as
// their bits), so the host reads a frame back in one copy.
//
// Numerics: fp32 throughout, as the plain versions on the card compute
// it, step by step: the library builds with -fmad=false so that nvcc
// fuses no product into a sum that the plain version rounds twice (the
// explicit fmaf calls stand for cuBLAS's products: the 2 x 2 rotations
// and L^-1 K*), a division by a Python number is PyTorch's CUDA
// multiplication by its float reciprocal (passed in), and expf, sqrtf,
// atan2f, sinf, cosf are the accurate CUDA functions (no fast math).
// The sums over the four probes take torch.sum's order on the card
// (sum4); the posterior's sums over a group's 26 samples do not, so
// outputs agree to rounding, and a decision within rounding of its
// threshold may go the other way.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;             // warps a block, one item each
constexpr int NODE_WORDS = 10;       // mapper2d.NODE_WORDS
constexpr int BEAM_WORDS = 7;        // mapper2d.BEAM_WORDS
constexpr float PAD_INVALID = 1e6f;  // obsgp._PAD_INVALID

// The frame's observation GP (models/obsgp.py: ObsGP1DState).
struct Obs {
  const float* x;          // [g, m] group angles
  const bool* valid;       // [g, m]
  const float* alpha;      // [g, m]
  const float* linv;       // [g, m, m] at strides ls0, ls1, ls2
  long long ls0, ls1, ls2;
  const bool* trained;     // [g]
  const float* bounds;     // [g + 1]
  const float* liml;       // scalar
  const float* limr;       // scalar
  const bool* any_trained; // scalar
  int g, m;
  float inv_scale;         // 1 / scale, in float
  float var0;              // 1 + noise, rounded from double
};

// The frame's pose and the mapper's parameters.
struct Frame {
  const float* tr;         // [2]
  const float* rot;        // [2, 2] at strides rs0, rs1
  long long rs0, rs1;
  float delx, inv_delx, inv_three;
  float obs_var_thre, min_pos_noise, min_grad_noise, map_noise;
  float off_x, off_y, occ_stop;
  int iters;
};

struct Nodes {
  const float* pos;        // [k, 2]
  const float* grad;       // [k, 2]
  const float* pos_sig;    // [k]
  const float* grad_sig;   // [k]
  const bool* valid;       // [k]
  int k;
};

struct Beams {
  const bool* valid;       // [n]
  const float* theta;      // [n]
  const float* rng;        // [n]
  const float* xy_local;   // [n, 2]
  const float* xy_global;  // [n, 2]
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float rot_at(const Frame& f, int i, int j) {
  return f.rot[i * f.rs0 + j * f.rs1];
}

// v @ rot (by column j) and v @ rot^T (by row j), as cuBLAS sums a
// 2-term product
__device__ __forceinline__ float times_rot(const Frame& f, float v0,
                                           float v1, int j) {
  return fmaf(v1, rot_at(f, 1, j), v0 * rot_at(f, 0, j));
}
__device__ __forceinline__ float times_rot_t(const Frame& f, float v0,
                                             float v1, int j) {
  return fmaf(v1, rot_at(f, j, 1), v0 * rot_at(f, j, 0));
}

// Posterior (mean, var) of the observation GP at angle q
// (models/obsgp.py: obsgp1d_test; ObsGP.cpp:145-187).
__device__ void obs_test(const Obs& o, float q, float& mean, float& var) {
  const int lane = threadIdx.x & 31;
  int below = 0;   // interior bounds strictly below q
  for (int b = 0; b < o.g; b += 32) {
    const int i = b + lane;
    below += __popc(__ballot_sync(FULL, i < o.g && o.bounds[1 + i] < q));
  }
  const int gi = min(below, o.g - 1);
  mean = 0.f;
  var = PAD_INVALID;
  if (!(q >= *o.liml && q <= *o.limr && q > o.bounds[gi] &&
        q < o.bounds[gi + 1] && *o.any_trained && o.trained[gi]))
    return;
  float ks = 0.f, a = 0.f;
  if (lane < o.m) {
    const long long e = (long long)gi * o.m + lane;
    const float d = o.x[e] - q;
    if (o.valid[e]) ks = expf(-sqrtf(d * d) * o.inv_scale);
    a = o.alpha[e];
  }
  mean = warp_sum(ks * a);
  const float* row = o.linv + gi * o.ls0 + (long long)lane * o.ls1;
  float v = 0.f;
  for (int j = 0; j < o.m; ++j) {
    const float kj = __shfl_sync(FULL, ks, j);
    if (lane < o.m) v = fmaf(row[j * o.ls2], kj, v);
  }
  var = o.var0 - warp_sum(v * v);
}

// mapper2d.occ_test at range r (mapper2d._occ_at): 2 (sigmoid(a (1/sqrt r
// - rinv0)) - 0.5) with a = 30 r (GPisMap.cpp:39-42)
__device__ __forceinline__ float occ_at(float r, float rinv0) {
  const float rinv = 1.f / sqrtf(fmaxf(r, 1e-12f));
  const float z = (r * 30.f) * (rinv - rinv0);
  return 2.f * (1.f / (1.f + expf(-z)) - 0.5f);
}

// obs_at of reeval_2d_reference: the posterior at the point's bearing,
// and its range
__device__ __forceinline__ void obs_at(const Obs& o, float x, float y,
                                       float& rinv0, float& var, float& r) {
  r = sqrtf(x * x + y * y);
  obs_test(o, atan2f(y, x), rinv0, var);
}

// The four probes at delx around (x, y) (mapper2d._PROBES: +x, -x, +y,
// -y): their occupancies, and whether every variance passes the gate.
__device__ __forceinline__ bool probes(const Obs& o, const Frame& f, float x,
                                       float y, float pocc[4],
                                       float rinv0[4]) {
  const float px[4] = {x + f.delx, x + -f.delx, x + 0.f, x + 0.f};
  const float py[4] = {y + 0.f, y + 0.f, y + f.delx, y + -f.delx};
  bool ok = true;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float var, r;
    obs_at(o, px[p], py[p], rinv0[p], var, r);
    ok = ok && var <= f.obs_var_thre;
    pocc[p] = occ_at(r, rinv0[p]);
  }
  return ok;
}

// torch.sum over a last axis of 4 on the card: (a0 + a2) + (a1 + a3)
__device__ __forceinline__ float sum4(float a0, float a1, float a2,
                                      float a3) {
  return (a0 + a2) + (a1 + a3);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// min_pos_noise (1 - va^2) / va^2 at the view angle va = max(-<x, g> /
// |x|, 0.1) (GPisMap.cpp:366-371, :547-551)
__device__ __forceinline__ float view_noise(const Frame& f, float x, float y,
                                            float gx, float gy) {
  const float dist = sqrtf(x * x + y * y);
  const float va = fmaxf(-(x * gx + y * gy) / fmaxf(dist, 1e-12f), 0.1f);
  const float va2 = va * va;
  return f.min_pos_noise * (1.f - va2) / va2;
}

// One node of reeval_2d_reference (GPisMap.cpp:235-455).
__device__ void node_item(const Obs& o, const Frame& f, const Nodes& nd,
                          int i, float* out) {
  const float p0 = nd.pos[2 * i], p1 = nd.pos[2 * i + 1];
  const float g0 = nd.grad[2 * i], g1 = nd.grad[2 * i + 1];
  const float psig = nd.pos_sig[i], gsig = nd.grad_sig[i];
  const float d0 = p0 - f.tr[0], d1 = p1 - f.tr[1];
  // world -> sensor frame
  float xn = times_rot(f, d0, d1, 0) - f.off_x;
  float yn = times_rot(f, d0, d1, 1) - f.off_y;
  float rinv0, var, r;
  obs_at(o, xn, yn, rinv0, var, r);
  const bool gate = nd.valid[i] && var <= f.obs_var_thre;
  float oc = occ_at(r, rinv0);
  const bool active = gate && oc >= -0.1f;          // GPisMap.cpp:258-265
  const float glx = times_rot(f, g0, g1, 0), gly = times_rot(f, g0, g1, 1);

  // iterative re-localization (GPisMap.cpp:273-315)
  float dx = f.delx, abs_oc = fabsf(oc), r_new = r;
  bool cont = active && abs_oc > f.occ_stop;
  int steps = 0;
  for (int it = 0; it < f.iters && cont; ++it) {
    ++steps;
    const float sgn = oc < 0.f ? 1.f : -1.f;
    xn = xn + sgn * glx * dx;
    yn = yn + sgn * gly * dx;
    float rinv0_n, var_n, r_t;
    obs_at(o, xn, yn, rinv0_n, var_n, r_t);
    r_new = r_t;
    const float oc_n = occ_at(r_t, rinv0_n);
    const bool upd = !(var_n > f.obs_var_thre) &&
                     !(fabsf(oc_n) < f.occ_stop || oc < -0.1f);
    if (upd) {
      dx = oc * oc_n < 0.f ? 0.5f * dx : 1.1f * dx;
      oc = oc_n;
      abs_oc = fabsf(oc_n);
    }
    cont = upd && fabsf(oc_n) > f.occ_stop;
  }

  // 4-probe normal + noise model (GPisMap.cpp:317-380)
  float pocc[4], prinv0[4];
  const bool probe_ok = probes(o, f, xn, yn, pocc, prinv0);
  const float occ_mean = 0.25f * sum4(pocc[0], pocc[1], pocc[2], pocc[3]);
  float r0[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    r0[p] = 1.f / fmaxf(prinv0[p] * prinv0[p], 1e-12f);
  const float r0_sqr_sum = sum4(r0[0] * r0[0], r0[1] * r0[1], r0[2] * r0[2],
                                r0[3] * r0[3]);
  const float r0_mean = 0.25f * sum4(r0[0], r0[1], r0[2], r0[3]);

  const bool act2 = active && probe_ok;
  const float gnx = (pocc[0] - pocc[1]) * f.inv_delx;
  const float gny = (pocc[2] - pocc[3]) * f.inv_delx;
  const float norm_g = sqrtf(gnx * gnx + gny * gny);
  const bool dbl = act2 && norm_g < 1e-3f;          // GPisMap.cpp:354-357
  const bool act3 = act2 && norm_g >= 1e-3f;

  const float r_var =
      (r0_sqr_sum * f.inv_three - r0_mean * r0_mean * 4.f * f.inv_three) *
      f.inv_delx;
  const float nn = fmaxf(norm_g, 1e-12f);
  const float gx = gnx / nn, gy = gny / nn;
  float noise = f.min_pos_noise * clampf(r_new * r_new, 1.f, 100.f);
  float grad_noise =
      clampf(fabsf(occ_mean) + r_var, f.min_grad_noise, 1.f);
  const float vn = view_noise(f, xn, yn, gx, gy);
  noise = noise + vn + abs_oc;
  grad_noise = grad_noise + 0.1f * vn;

  const float v0 = xn + f.off_x, v1 = yn + f.off_y;
  const float pn0 = times_rot_t(f, v0, v1, 0) + f.tr[0];
  const float pn1 = times_rot_t(f, v0, v1, 1) + f.tr[1];
  const float gn0 = times_rot_t(f, gx, gy, 0);
  const float gn1 = times_rot_t(f, gx, gy, 1);

  // fusion with the old estimate (GPisMap.cpp:391-421)
  float po0 = pn0, po1 = pn1, go0 = gn0, go1 = gn1;
  float noise_out = noise, gnoise_out = grad_noise;
  if (gsig <= 0.5f) {
    const float psum = psig + noise;
    const float pf0 = (noise * p0 + psig * pn0) / psum;
    const float pf1 = (noise * p1 + psig * pn1) / psum;
    const float e0 = p0 - pf0, e1 = p1 - pf1;
    const float dist_f = 0.5f * sqrtf(e0 * e0 + e1 * e1);
    const float tv_x = g0 * gn0 + g1 * gn1;
    const float tv_y = -g1 * gn0 + g0 * gn1;
    const float angd = atan2f(tv_y, tv_x) * noise / psum;
    const float ca = cosf(angd), sa = sinf(angd);
    const float gsum = gsig + grad_noise;
    po0 = pf0;
    po1 = pf1;
    go0 = ca * g0 - sa * g1;
    go1 = sa * g0 + ca * g1;
    gnoise_out = fminf(
        fmaxf(grad_noise * gsig / gsum + dist_f, f.map_noise), 1.f);
    noise_out = fmaxf(noise * psig / psum + dist_f, f.map_noise);
  }
  const bool discard = noise_out > 1.f && gnoise_out > 0.61f;  // :425
  const int action = dbl ? 1 : (act3 && discard ? 2 : (act3 ? 3 : 0));

  if ((threadIdx.x & 31) == 0) {
    out[0] = __int_as_float(action);
    out[1] = po0;
    out[2] = po1;
    out[3] = go0;
    out[4] = go1;
    out[5] = noise_out;
    out[6] = gnoise_out;
    out[7] = 2.f * psig;
    out[8] = 2.f * gsig;
    out[9] = __int_as_float(steps);
  }
}

// One beam of newmeas_2d_reference (GPisMap.cpp:466-572).
__device__ void beam_item(const Obs& o, const Frame& f, const Beams& bm,
                          int i, float* out) {
  const float xl = bm.xy_local[2 * i], yl = bm.xy_local[2 * i + 1];
  float mean0, var0;
  obs_test(o, bm.theta[i], mean0, var0);
  const bool gate = bm.valid[i] && var0 <= f.obs_var_thre;
  float pocc[4], prinv0[4];
  const bool probe_ok = probes(o, f, xl, yl, pocc, prinv0);
  const float occ_mean = 0.25f * sum4(pocc[0], pocc[1], pocc[2], pocc[3]);

  const float gx = (pocc[0] - pocc[1]) * f.inv_delx;
  const float gy = (pocc[2] - pocc[3]) * f.inv_delx;
  const float norm2 = gx * gx + gy * gy;
  const bool hasg = norm2 > 1e-6f;                  // GPisMap.cpp:544-545
  const float norm = sqrtf(fmaxf(norm2, 1e-24f));
  const float lx = gx / norm, ly = gy / norm;

  const float rg = bm.rng[i];
  float noise = f.min_pos_noise * clampf(rg * rg, 1.f, 100.f);
  const float gnoise = clampf(fabsf(occ_mean), f.min_grad_noise, 1.f);
  noise = noise + view_noise(f, xl, yl, lx, ly);

  if ((threadIdx.x & 31) == 0) {
    // gradient-free candidates keep the raw local occupancy difference
    // with noise 100 / 1 (the reference quirk, GPisMap.cpp:538-560)
    out[0] = __int_as_float(gate && probe_ok ? 1 : 0);
    out[1] = bm.xy_global[2 * i];
    out[2] = bm.xy_global[2 * i + 1];
    out[3] = hasg ? times_rot_t(f, lx, ly, 0) : gx;
    out[4] = hasg ? times_rot_t(f, lx, ly, 1) : gy;
    out[5] = hasg ? noise : 100.f;
    out[6] = hasg ? gnoise : 1.f;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    obsgp1d_frame_kernel(Obs o, Frame f, Nodes nd, Beams bm, float* out) {
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item < nd.k)
    node_item(o, f, nd, item, out + (long long)item * NODE_WORDS);
  else if (item < nd.k + bm.n)
    beam_item(o, f, bm, item - nd.k,
              out + (long long)nd.k * NODE_WORDS +
                  (long long)(item - nd.k) * BEAM_WORDS);
}

}  // namespace

extern "C" {

// Words of the packed output per node and per beam.
int obsgp1d_frame_node_words() { return NODE_WORDS; }
int obsgp1d_frame_beam_words() { return BEAM_WORDS; }

// Launches the kernel on `stream` over k nodes and n beams (either may be
// 0), writing k NODE_WORDS + n BEAM_WORDS floats to out. Returns
// cudaGetLastError() (0 on success).
int obsgp1d_frame_launch(
    const float* x, const bool* valid, const float* alpha, const float* linv,
    long long ls0, long long ls1, long long ls2, const bool* trained,
    const float* bounds, const float* liml, const float* limr,
    const bool* any_trained, int g, int m, float inv_scale, float var0,
    const float* tr, const float* rot, long long rs0, long long rs1,
    float delx, float inv_delx, float inv_three, float obs_var_thre,
    float min_pos_noise, float min_grad_noise, float map_noise, float off_x,
    float off_y, float occ_stop, int iters, const float* pos,
    const float* grad, const float* pos_sig, const float* grad_sig,
    const bool* node_valid, int k, const bool* beam_valid,
    const float* theta, const float* rng, const float* xy_local,
    const float* xy_global, int n, float* out, void* stream) {
  if (m > 32 || g < 1 || k < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)k + n;
  if (items == 0) return 0;
  Obs o{x, valid, alpha, linv, ls0, ls1, ls2, trained, bounds, liml, limr,
        any_trained, g, m, inv_scale, var0};
  Frame f{tr, rot, rs0, rs1, delx, inv_delx, inv_three, obs_var_thre,
          min_pos_noise, min_grad_noise, map_noise, off_x, off_y, occ_stop,
          iters};
  Nodes nd{pos, grad, pos_sig, grad_sig, node_valid, k};
  Beams bm{beam_valid, theta, rng, xy_local, xy_global, n};
  const long long blocks = (items + WARPS - 1) / WARPS;
  obsgp1d_frame_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(o, f, nd, bm, out);
  return (int)cudaGetLastError();
}

const char* obsgp1d_frame_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
