// The screen footprint of a 2D gaussian surfel, shared by the surfel
// projection (surfel_project.cu), which culls by it and writes it for the
// build, and the surfel forward (surfel_fwd.cu), whose per-tile gate
// recomputes it from the packed row: the same operations on the same
// floats, so the gate and the build's membership agree bit for bit. The
// plain version is splat_one_tpu_torch/ops/surfels.py `surfel_footprint`,
// operation by operation in its order (with --fmad=false).
//
// A surfel's ray transform T = K [s_u R t_u, s_v R t_v, R p + t] has rows
// u = (t[0], t[1], t[2]), v = (t[3], t[4], t[5]), w = (t[6], t[7], t[8]); a
// splat point (a, b) lands at the homogeneous pixel T (a, b, 1). Its alpha
// at a pixel is o exp(-min(a^2 + b^2, 2 |pixel - mean2d|^2) / 2), so it is
// at least 1/255 only inside the union of the disc a^2 + b^2 <= r2 =
// 2 ln(255 o) seen through T and the circle of radius sqrt(r2 / 2) about
// mean2d. mean2d is the centre of the unit disc's bounding box (the dual
// conic T diag(1, 1, -1) T^T, gsplat's); the r2-disc's box comes from the
// dual conic T diag(r2, r2, -1) T^T. Both are bounded only where the disc
// lies wholly in front of the camera plane (the conic's w-w entry < 0).
// The footprint is the box that holds both, as its centre and half widths
// (the disc's image need not lie about mean2d: one near the camera plane
// stretches far to one side).

#pragma once

#include <cuda_runtime.h>

namespace surfel {

// The extents' margin: a factor, and pixels (Python's 1.001 and 0.05 as
// PyTorch rounds them against a float32 tensor).
constexpr float EXT_SCALE = static_cast<float>(1.001);
constexpr float EXT_ABS = static_cast<float>(0.05);

struct Footprint {
  float mx, my;  // mean2d
  float bx, by;  // the centre of the box holding every pixel with alpha >= 1/255
  float rx, ry;  // its half widths
  float dist;    // the unit disc's w-w entry: < 0 where it lies in front
  float dr;      // the r2-disc's w-w entry: < 0 where it lies in front
  float r2;      // 2 ln(255 o)
};

// torch.clamp(min=lo)'s NaN rule: a NaN input passes through.
__device__ __forceinline__ float fp_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// torch.maximum and torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float fp_maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float fp_minimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ Footprint footprint(const float* t, float op) {
  const float u0 = t[0], u1 = t[1], u2 = t[2];
  const float v0 = t[3], v1 = t[4], v2 = t[5];
  const float w0 = t[6], w1 = t[7], w2 = t[8];
  Footprint f;
  f.dist = (w0 * w0 + w1 * w1) - w2 * w2;
  const float inv = 1.0f / (f.dist == 0.0f ? 1.0f : f.dist);
  f.mx = ((u0 * w0 + u1 * w1) - u2 * w2) * inv;
  f.my = ((v0 * w0 + v1 * w1) - v2 * w2) * inv;
  f.r2 = 2.0f * logf(fp_clamp_min(op, static_cast<float>(1e-12)) * 255.0f);
  const float rc = fp_clamp_min(f.r2, 0.0f);
  f.dr = rc * (w0 * w0 + w1 * w1) - w2 * w2;
  const float invr = 1.0f / (f.dr == 0.0f ? 1.0f : f.dr);
  const float cx = (rc * (u0 * w0 + u1 * w1) - u2 * w2) * invr;
  const float cy = (rc * (v0 * w0 + v1 * w1) - v2 * w2) * invr;
  const float hx = sqrtf(fp_clamp_min(cx * cx - (rc * (u0 * u0 + u1 * u1) - u2 * u2) * invr,
                                      0.0f));
  const float hy = sqrtf(fp_clamp_min(cy * cy - (rc * (v0 * v0 + v1 * v1) - v2 * v2) * invr,
                                      0.0f));
  const float rf = sqrtf(fp_clamp_min(0.5f * f.r2, 0.0f));
  const float x0 = fp_minimum(cx - hx, f.mx - rf), x1 = fp_maximum(cx + hx, f.mx + rf);
  const float y0 = fp_minimum(cy - hy, f.my - rf), y1 = fp_maximum(cy + hy, f.my + rf);
  f.bx = 0.5f * (x0 + x1);
  f.by = 0.5f * (y0 + y1);
  f.rx = 0.5f * (x1 - x0) * EXT_SCALE + EXT_ABS;
  f.ry = 0.5f * (y1 - y0) * EXT_SCALE + EXT_ABS;
  return f;
}

}  // namespace surfel
