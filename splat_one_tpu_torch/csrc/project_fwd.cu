// EWA projection of 3D gaussians into C cameras, with culling and SH
// colour, in one pass over the rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package projects in plain jnp
// (splat_one_tpu/ops/projection.py `project_gaussians`), and so does the
// port's plain version (splat_one_tpu_torch/ops/projection.py
// `project_gaussians_plain`), which the training path keeps for its
// autograd. This kernel computes what the plain version returns without
// autograd (the viewer and every evaluation): means2d, conics, depths,
// radii, opacities, valid and, given SH coefficients, colours; every
// camera model, antialiased compensation, near/far, radius and bbox
// culling and the `alive` mask. The plain version runs ~370 launches over
// [C, N] temporaries for the same result.
//
// What bounds it on the H100: bytes. Each row reads 236 B at SH degree 3
// (means 12, quats 16, scales 12, opacity 4, 16 x 3 coefficients 192) and
// writes 45 B a camera (means2d 8, conic 12, depth 4, radius 4, colour 12,
// opacity 4, valid 1): 281 B a row at C = 1, ~400 f32 operations, so the
// arithmetic is far below the card's rate.
//
// Design. A block of 128 threads takes a tile of 128 consecutive rows,
// one thread a row, and walks the tiles in a grid-stride loop: a ring of
// two shared-memory stages, filled by 16-byte cp.async copies of each
// input's contiguous slab, so the next tile's loads fly while this one
// computes. SH rows of a multiple of four coefficients are whole 16-byte
// chunks; they are staged with an odd chunk stride, so a warp's 16-byte
// reads of its 32 rows meet no bank conflict. Each thread works every
// camera from the one staged copy, so rows are read once whatever C is.
// The AoS outputs of 12 B a row (conic, colour) go back through shared
// memory for coalesced stores; the others are one coalesced store each.
//
// Arithmetic. Term for term the plain version's, in its order, under the
// build's --fmad=false, so that valid, radii, means2d, conics, depths and
// opacities equal it bit for bit on the card: each Python float constant
// rounded to float as PyTorch rounds a scalar against a float32 tensor;
// `s / t` with a Python numerator is PyTorch's reciprocal then product,
// and `t / s` by a Python scalar is a product by the float reciprocal;
// clamps propagate NaN as torch.clamp does; the squared quaternion norm is
// summed in the order of PyTorch's 4-lane block reduction (lane l + 2 onto
// lane l, then lane 1 onto lane 0). Only the SH sum (k = 0, 1, ... here;
// cuBLAS's order in the plain einsum) and the camera position (a product
// here, a batched matmul there) may differ, by a few ulp of the colours.
//
// The launcher returns the CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project_common.cuh"

namespace {

constexpr double PI = 3.141592653589793;  // math.pi

enum Model { PINHOLE = 0, ORTHO = 1, FISHEYE = 2, SPHERICAL = 3 };

struct Params {
  const float* means;
  const float* quats;
  const float* scales;
  const float* opac;
  const float* sh;        // [N, K, 3] or null
  const uint8_t* alive;   // [N] or null
  const float* viewmats;  // [C, 4, 4]
  const float* ks;        // [C, 3, 3]
  float2* means2d;
  float* conics;
  float* depths;
  float* radii;
  float* colors;  // [C, N, 3] or null (with sh)
  float* opac_out;
  uint8_t* valid;
  int n, c, k, nb, model, antialiased;
  int sh_stride;     // floats a staged SH row
  int sh_chunks;     // 16-byte chunks an SH row, when staged by rows (else 0)
  int stage_floats;  // floats a stage
  float width, height;
  float lim_num_x, lim_num_y;  // 1.3 * 0.5 * width, height
  float cu, ncu, cv;           // width / 2pi, -(width / 2pi), -height / pi
  float inv_2pi, inv_pi;       // float reciprocals of float(2pi), float(pi)
  float near_plane, far_plane, radius_clip, eps2d, inv_alpha_cut;
};

template <bool ROWS16>
__global__ void __launch_bounds__(R, 3) project_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_out = smem + 2 * p.stage_floats;  // [2][3R]: conics, colours
  const int tiles = (p.n + R - 1) / R;
  const int r = threadIdx.x;

  int t = blockIdx.x;
  if (t < tiles) stage_tile(smem, p, t * R, min(R, p.n - t * R));
  cp_async::commit();
  for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
    const int tn = t + gridDim.x;
    if (tn < tiles)
      stage_tile(smem + (s ^ 1) * p.stage_floats, p, tn * R, min(R, p.n - tn * R));
    cp_async::commit();
    cp_async::wait_pending<1>();
    __syncthreads();

    const float* st = smem + s * p.stage_floats;
    const int r0 = t * R;
    const int nr = min(R, p.n - r0);
    const bool live = r < nr;
    const int row = r0 + r;

    // camera-independent: the rotation-scale matrix M = R(q) diag(s)
    float mx = 0.f, my = 0.f, mz = 0.f, op = 0.f;
    float m00 = 0.f, m01 = 0.f, m02 = 0.f, m10 = 0.f, m11 = 0.f, m12 = 0.f;
    float m20 = 0.f, m21 = 0.f, m22 = 0.f;
    bool alive = false;
    if (live) {
      mx = st[3 * r];
      my = st[3 * r + 1];
      mz = st[3 * r + 2];
      const float4 qv = reinterpret_cast<const float4*>(st + 3 * R)[r];
      const float sx = st[7 * R + 3 * r], sy = st[7 * R + 3 * r + 1];
      const float sz = st[7 * R + 3 * r + 2];
      op = st[10 * R + r];
      alive = p.alive == nullptr || p.alive[row] != 0;
      const float nrm = sqrtf((qv.x * qv.x + qv.z * qv.z) + (qv.y * qv.y + qv.w * qv.w) +
                              F32(1e-24));
      const float w = qv.x / nrm, x = qv.y / nrm, y = qv.z / nrm, z = qv.w / nrm;
      m00 = (1.0f - 2.0f * (y * y + z * z)) * sx;
      m01 = (2.0f * (x * y - w * z)) * sy;
      m02 = (2.0f * (x * z + w * y)) * sz;
      m10 = (2.0f * (x * y + w * z)) * sx;
      m11 = (1.0f - 2.0f * (x * x + z * z)) * sy;
      m12 = (2.0f * (y * z - w * x)) * sz;
      m20 = (2.0f * (x * z - w * y)) * sx;
      m21 = (2.0f * (y * z + w * x)) * sy;
      m22 = (1.0f - 2.0f * (x * x + y * y)) * sz;
    }

    for (int ci = 0; ci < p.c; ++ci) {
      const int64_t o = static_cast<int64_t>(ci) * p.n + row;
      if (live) {
        const float* vm = p.viewmats + 16 * ci;
        const float R00 = __ldg(vm + 0), R01 = __ldg(vm + 1), R02 = __ldg(vm + 2);
        const float t0 = __ldg(vm + 3);
        const float R10 = __ldg(vm + 4), R11 = __ldg(vm + 5), R12 = __ldg(vm + 6);
        const float t1 = __ldg(vm + 7);
        const float R20 = __ldg(vm + 8), R21 = __ldg(vm + 9), R22 = __ldg(vm + 10);
        const float t2 = __ldg(vm + 11);
        const float* kk = p.ks + 9 * ci;
        const float fx = __ldg(kk + 0), cx = __ldg(kk + 2);
        const float fy = __ldg(kk + 4), cy = __ldg(kk + 5);

        const float px = ((R00 * mx + R01 * my) + R02 * mz) + t0;
        const float py = ((R10 * mx + R11 * my) + R12 * mz) + t1;
        const float pz = ((R20 * mx + R21 * my) + R22 * mz) + t2;
        const float depth = p.model == SPHERICAL
                                ? sqrtf(((px * px + py * py) + pz * pz) + F32(1e-24))
                                : pz;
        // B = R_cam M, row by row
        const float b00 = (R00 * m00 + R01 * m10) + R02 * m20;
        const float b01 = (R00 * m01 + R01 * m11) + R02 * m21;
        const float b02 = (R00 * m02 + R01 * m12) + R02 * m22;
        const float b10 = (R10 * m00 + R11 * m10) + R12 * m20;
        const float b11 = (R10 * m01 + R11 * m11) + R12 * m21;
        const float b12 = (R10 * m02 + R11 * m12) + R12 * m22;
        const float b20 = (R20 * m00 + R21 * m10) + R22 * m20;
        const float b21 = (R20 * m01 + R21 * m11) + R22 * m21;
        const float b22 = (R20 * m02 + R21 * m12) + R22 * m22;

        float j00, j01, j02, j10, j11, j12;
        float u, v;
        if (p.model == PINHOLE) {
          const float zs = clamp_min(pz, F32(1e-6));
          const float lim_x = (1.0f / fx) * p.lim_num_x;
          const float lim_y = (1.0f / fy) * p.lim_num_y;
          const float xc = zs * clamp_tensor(px / zs, -lim_x, lim_x);
          const float yc = zs * clamp_tensor(py / zs, -lim_y, lim_y);
          const float zn = fabsf(pz) < F32(1e-8) ? F32(1e-8) : pz;
          const float inv_z = 1.0f / zn;
          j00 = fx * inv_z;
          j01 = 0.0f;
          j02 = (((-fx) * xc) * inv_z) * inv_z;
          j10 = 0.0f;
          j11 = fy * inv_z;
          j12 = (((-fy) * yc) * inv_z) * inv_z;
          u = ((fx * px) / zn) + cx;
          v = ((fy * py) / zn) + cy;
        } else if (p.model == ORTHO) {
          j00 = fx * 1.0f;
          j01 = 0.0f * 1.0f;
          j02 = 0.0f * 1.0f;
          j10 = 0.0f * 1.0f;
          j11 = fy * 1.0f;
          j12 = 0.0f * 1.0f;
          u = fx * px + cx;
          v = fy * py + cy;
        } else if (p.model == SPHERICAL) {
          const float rxz2 = clamp_min(px * px + pz * pz, F32(1e-8));
          const float r2 = clamp_min((px * px + py * py) + pz * pz, F32(1e-8));
          const float rxz = sqrtf(rxz2);
          j00 = (p.cu * pz) / rxz2;
          j01 = 0.0f;
          j02 = (p.ncu * px) / rxz2;
          j10 = ((p.cv * px) * py) / (r2 * rxz);
          j11 = (p.cv * (-rxz)) / r2;
          j12 = ((p.cv * pz) * py) / (r2 * rxz);
          const float rr = sqrtf((px * px + py * py) + pz * pz);
          const float lon = atan2f(px, pz);
          const float lat = asinf(clamp_both((-py) / clamp_min(rr, F32(1e-8)), -1.0f, 1.0f));
          u = (lon * p.inv_2pi + 0.5f) * p.width;
          v = (0.5f - lat * p.inv_pi) * p.height;
        } else {  // equidistant fisheye, closed form
          const float x2 = px * px, y2 = py * py, xy = px * py;
          const float r2 = clamp_min(x2 + y2, F32(1e-7));
          const float L2 = r2 + pz * pz;
          const float inv_L2 = 1.0f / clamp_min(L2, F32(1e-7));
          const float theta = atan2f(sqrtf(r2), pz);
          const float b_f = theta / (r2 * sqrtf(r2));
          const float a_f = (pz * inv_L2) / r2;
          j00 = fx * (x2 * a_f + y2 * b_f);
          j01 = (fx * xy) * (a_f - b_f);
          j02 = ((-fx) * px) * inv_L2;
          j10 = (fy * xy) * (a_f - b_f);
          j11 = fy * (y2 * a_f + x2 * b_f);
          j12 = ((-fy) * py) * inv_L2;
          const float rr = sqrtf(px * px + py * py);
          const float th = atan2f(rr, pz);
          const float scale = th / clamp_min(rr, F32(1e-8));
          u = ((fx * px) * scale) + cx;
          v = ((fy * py) * scale) + cy;
        }

        // A = J B (2x3), cov2d = A A^T
        const float a00 = (j00 * b00 + j01 * b10) + j02 * b20;
        const float a01 = (j00 * b01 + j01 * b11) + j02 * b21;
        const float a02 = (j00 * b02 + j01 * b12) + j02 * b22;
        const float a10 = (j10 * b00 + j11 * b10) + j12 * b20;
        const float a11 = (j10 * b01 + j11 * b11) + j12 * b21;
        const float a12 = (j10 * b02 + j11 * b12) + j12 * b22;
        float ca = (a00 * a00 + a01 * a01) + a02 * a02;
        const float cb = (a00 * a10 + a01 * a11) + a02 * a12;
        float cc = (a10 * a10 + a11 * a11) + a12 * a12;
        const float det_raw = ca * cc - cb * cb;
        ca = ca + p.eps2d;
        cc = cc + p.eps2d;
        const float det = ca * cc - cb * cb;
        const float inv_det = 1.0f / (det <= 0.0f ? 1.0f : det);
        const float comp = p.antialiased ? sqrtf(clamp_min(det_raw, 0.0f) * inv_det) : 1.0f;
        const float opac = op * comp;
        const float mid = 0.5f * (ca + cc);
        const float disc = sqrtf(clamp_min(mid * mid - det, F32(0.01)));
        const float radius = 3.0f * sqrtf(clamp_min(mid + disc, 0.0f));

        // projection.opacity_extent, then the cov-diagonal bbox cull
        const float s2 = 2.0f * logf(clamp_min(opac, F32(1e-12)) * p.inv_alpha_cut);
        const float ext = clamp_max(sqrtf(clamp_min(s2, 0.0f)) + F32(1e-3), 3.0f);
        const float rx = ext * sqrtf(clamp_min(ca, 0.0f));
        const float ry = ext * sqrtf(clamp_min(cc, 0.0f));
        bool ok = (depth > p.near_plane) & (depth < p.far_plane) & (det > 0.0f);
        ok &= radius > p.radius_clip;
        ok &= (v + ry > 0.0f) & (v - ry < p.height);
        if (p.model != SPHERICAL) ok &= (u + rx > 0.0f) & (u - rx < p.width);
        ok &= alive;

        p.means2d[o] = make_float2(u, v);
        p.depths[o] = depth;
        p.radii[o] = ok ? radius : 0.0f;
        p.opac_out[o] = opac;
        p.valid[o] = ok;
        s_out[3 * r] = cc * inv_det;
        s_out[3 * r + 1] = (-cb) * inv_det;
        s_out[3 * r + 2] = ca * inv_det;

        if (p.colors != nullptr) {
          const float cpx = -((R00 * t0 + R10 * t1) + R20 * t2);
          const float cpy = -((R01 * t0 + R11 * t1) + R21 * t2);
          const float cpz = -((R02 * t0 + R12 * t1) + R22 * t2);
          const float dx = mx - cpx, dy = my - cpy, dz = mz - cpz;
          const float dn = sqrtf(((dx * dx + dy * dy) + dz * dz) + F32(1e-20));
          float acc[3] = {0.0f, 0.0f, 0.0f};
          sh_colour<ROWS16>(st + 11 * R + r * p.sh_stride, p.nb, dx / dn, dy / dn, dz / dn,
                            acc);
          s_out[3 * R + 3 * r] = clamp_min(acc[0] + 0.5f, 0.0f);
          s_out[3 * R + 3 * r + 1] = clamp_min(acc[1] + 0.5f, 0.0f);
          s_out[3 * R + 3 * r + 2] = clamp_min(acc[2] + 0.5f, 0.0f);
        }
      }
      __syncthreads();
      const int64_t base = 3 * (static_cast<int64_t>(ci) * p.n + r0);
      for (int i = r; i < 3 * nr; i += R) p.conics[base + i] = s_out[i];
      if (p.colors != nullptr)
        for (int i = r; i < 3 * nr; i += R) p.colors[base + i] = s_out[3 * R + i];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int project_fwd(const float* means, const float* quats, const float* scales,
                           const float* opac, const float* sh, const uint8_t* alive,
                           const float* viewmats, const float* ks, float* means2d,
                           float* conics, float* depths, float* radii, float* colors,
                           float* opac_out, uint8_t* valid, int n, int c, int k, int nb,
                           int model, int antialiased, int width, int height,
                           float near_plane, float far_plane, float radius_clip, float eps2d,
                           void* stream) {
  if (n <= 0 || c <= 0) return 0;
  Params p;
  p.means = means;
  p.quats = quats;
  p.scales = scales;
  p.opac = opac;
  p.sh = sh;
  p.alive = alive;
  p.viewmats = viewmats;
  p.ks = ks;
  p.means2d = reinterpret_cast<float2*>(means2d);
  p.conics = conics;
  p.depths = depths;
  p.radii = radii;
  p.colors = colors;
  p.opac_out = opac_out;
  p.valid = valid;
  p.n = n;
  p.c = c;
  p.k = k;
  p.nb = nb;
  p.model = model;
  p.antialiased = antialiased;
  const bool rows16 = sh != nullptr && k % 4 == 0;
  p.sh_chunks = rows16 ? 3 * k / 4 : 0;
  p.sh_stride = sh == nullptr ? 0 : rows16 ? 4 * (p.sh_chunks | 1) : 3 * k;
  p.stage_floats = 11 * R + R * p.sh_stride;
  // the plain version's scalars, rounded where PyTorch rounds them
  p.width = static_cast<float>(width);
  p.height = static_cast<float>(height);
  p.lim_num_x = static_cast<float>(1.3 * 0.5 * width);
  p.lim_num_y = static_cast<float>(1.3 * 0.5 * height);
  p.cu = static_cast<float>(width / (2.0 * PI));
  p.ncu = static_cast<float>(-(width / (2.0 * PI)));
  p.cv = static_cast<float>(-height / PI);
  p.inv_2pi = 1.0f / static_cast<float>(2.0 * PI);
  p.inv_pi = 1.0f / static_cast<float>(PI);
  p.near_plane = near_plane;
  p.far_plane = far_plane;
  p.radius_clip = radius_clip;
  p.eps2d = eps2d;
  p.inv_alpha_cut = static_cast<float>(1.0 / (1.0 / 255.0));

  const int bytes = static_cast<int>(sizeof(float)) * (2 * p.stage_floats + 6 * R);
  auto kernel = rows16 ? project_fwd_kernel<true> : project_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, R, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + R - 1) / R;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, R, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
