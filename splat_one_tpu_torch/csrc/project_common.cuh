// What the two projection kernels (project_fwd.cu: 3D gaussians;
// surfel_project.cu: 2D gaussian surfels) share: the tile of rows a block
// stages, its cp.async staging of the rows' parameters and SH coefficients,
// torch.clamp's NaN rules and the SH colour of one row. Each kernel's
// Params names the same input fields (means, quats, scales, opac, sh, k,
// sh_chunks, sh_stride).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int R = 128;       // rows a tile, threads a block
constexpr int MAX_K = 25;    // SH coefficients a row, degree 4

// A Python float constant against a float32 tensor: the double, cast.
#define F32(x) static_cast<float>(x)

// torch.clamp's NaN rule: a NaN input passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.clamp with tensor bounds: a NaN bound passes through too.
__device__ __forceinline__ float clamp_tensor(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// `floats` floats from global `src` (16-byte aligned) to shared `dst`:
// whole 16-byte chunks by cp.async, the few left over by plain loads.
__device__ __forceinline__ void copy_slab(float* dst, const float* src, int floats) {
  const int chunks = floats >> 2;
  for (int i = threadIdx.x; i < chunks; i += R) cp_async::copy16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * chunks + threadIdx.x; i < floats; i += R) dst[i] = src[i];
}

// A tile's rows [r0, r0 + nr) into stage `st`: means, quats, scales,
// opacities, SH rows (an odd chunk stride when rows are whole chunks).
template <class Params>
__device__ void stage_tile(float* st, const Params& p, int r0, int nr) {
  copy_slab(st, p.means + 3 * static_cast<int64_t>(r0), 3 * nr);
  copy_slab(st + 3 * R, p.quats + 4 * static_cast<int64_t>(r0), 4 * nr);
  copy_slab(st + 7 * R, p.scales + 3 * static_cast<int64_t>(r0), 3 * nr);
  copy_slab(st + 10 * R, p.opac + r0, nr);
  if (p.sh == nullptr) return;
  const float* src = p.sh + 3 * static_cast<int64_t>(p.k) * r0;
  float* dst = st + 11 * R;
  if (p.sh_chunks == 0) {
    copy_slab(dst, src, 3 * p.k * nr);
    return;
  }
  const int q = p.sh_chunks;
  for (int i = threadIdx.x; i < q * nr; i += R) {
    const int row = i / q;
    cp_async::copy16(dst + row * p.sh_stride + 4 * (i - row * q), src + 4 * i);
  }
}

// The raw SH colour of one row: sum over k of basis_k(dir) * coeff[k],
// k = 0, 1, ..., in three channels (sh.eval_sh_bases' terms).
template <bool ROWS16>
__device__ __forceinline__ void sh_colour(const float* row, int nb, float x, float y,
                                          float z, float acc[3]) {
  float b[MAX_K];
  b[0] = F32(0.28209479177387814);
  if (nb > 1) {
    b[1] = F32(-0.4886025119029199) * y;
    b[2] = F32(0.4886025119029199) * z;
    b[3] = F32(-0.4886025119029199) * x;
  }
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  if (nb > 4) {
    b[4] = F32(1.0925484305920792) * xy;
    b[5] = F32(-1.0925484305920792) * yz;
    b[6] = F32(0.31539156525252005) * ((2.0f * zz - xx) - yy);
    b[7] = F32(-1.0925484305920792) * xz;
    b[8] = F32(0.5462742152960396) * (xx - yy);
  }
  if (nb > 9) {
    b[9] = (F32(-0.5900435899266435) * y) * (3.0f * xx - yy);
    b[10] = (F32(2.890611442640554) * xy) * z;
    b[11] = (F32(-0.4570457994644658) * y) * ((4.0f * zz - xx) - yy);
    b[12] = (F32(0.3731763325901154) * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
    b[13] = (F32(-0.4570457994644658) * x) * ((4.0f * zz - xx) - yy);
    b[14] = (F32(1.445305721320277) * z) * (xx - yy);
    b[15] = (F32(-0.5900435899266435) * x) * (xx - 3.0f * yy);
  }
  if (nb > 16) {
    b[16] = (F32(2.5033429417967046) * xy) * (xx - yy);
    b[17] = (F32(-1.7701307697799304) * yz) * (3.0f * xx - yy);
    b[18] = (F32(0.9461746957575601) * xy) * (7.0f * zz - 1.0f);
    b[19] = (F32(-0.6690465435572892) * yz) * (7.0f * zz - 3.0f);
    b[20] = F32(0.10578554691520431) * (zz * (35.0f * zz - 30.0f) + 3.0f);
    b[21] = (F32(-0.6690465435572892) * xz) * (7.0f * zz - 3.0f);
    b[22] = (F32(0.47308734787878004) * (xx - yy)) * (7.0f * zz - 1.0f);
    b[23] = (F32(-1.7701307697799304) * xz) * (xx - 3.0f * yy);
    b[24] = F32(0.6258357354491761) * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
  }
  // the row's words in 16-byte groups: one shared load a group where the
  // rows are staged by chunks, four otherwise
  const int words = 3 * nb;
#pragma unroll
  for (int qi = 0; qi < (3 * MAX_K + 3) / 4; ++qi) {
    if (4 * qi >= words) break;
    float e[4];
    if (ROWS16) {
      const float4 v = reinterpret_cast<const float4*>(row)[qi];
      e[0] = v.x;
      e[1] = v.y;
      e[2] = v.z;
      e[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = 4 * qi + j < words ? row[4 * qi + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = 4 * qi + j;
      if (w < 3 * MAX_K && w < words) acc[w % 3] = acc[w % 3] + b[w / 3] * e[j];
    }
  }
}

}  // namespace
