// Projection of 2D gaussian surfels (2D Gaussian Splatting, Huang et al.,
// SIGGRAPH 2024; gsplat's rasterization_2dgs) into C pinhole cameras, with
// culling and SH colour, in one pass over the rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no surfel model. The plain
// version is splat_one_tpu_torch/ops/surfels.py `project_surfels_plain`;
// this kernel computes what it returns without autograd: each surfel's ray
// transform T = K [s_u R t_u, s_v R t_v, R p + t] (9 floats, rows u, v,
// w), mean2d, its footprint's box (surfel_common.cuh), its depth (the
// camera-frame z of its centre), valid and its SH colour.
//
// What bounds it on the H100: bytes. Each row reads 236 B at SH degree 3
// (means 12, quats 16, scales 12 (the third column unused), opacity 4,
// 16 x 3 coefficients 192) and writes 77 B a camera (T 36, mean2d 8,
// box 16, depth 4, colour 12, valid 1); ~360 f32 operations a row.
//
// Design: project_fwd.cu's (project_common.cuh): a block of 128 threads a
// tile of 128 rows, grid-stride over the tiles, two cp.async stages of the
// rows' inputs; T and the colours (AoS, 36 and 12 B a row) go back through
// shared memory for coalesced stores.
//
// Arithmetic: the plain version's, term for term in its order, under the
// build's --fmad=false (the constants rounded as PyTorch rounds a Python
// float against a float32 tensor), so that everything but the colours
// equals it bit for bit; the colours as project_fwd.cu's.
//
// The launcher returns the CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "project_common.cuh"
#include "surfel_common.cuh"

namespace {

struct Params {
  const float* means;
  const float* quats;
  const float* scales;
  const float* opac;
  const float* sh;        // [N, K, 3]
  const float* viewmats;  // [C, 4, 4]
  const float* ks;        // [C, 3, 3]
  float2* means2d;        // [C, N]
  float* transforms;      // [C, N, 9]
  float* depths;          // [C, N]
  float4* boxes;          // [C, N]: centre x, y, half widths x, y
  float* colors;          // [C, N, 3]
  uint8_t* valid;         // [C, N]
  int n, c, k, nb;
  int sh_stride;     // floats a staged SH row
  int sh_chunks;     // 16-byte chunks an SH row, when staged by rows (else 0)
  int stage_floats;  // floats a stage
  float width, height, near_plane, far_plane;
};

template <bool ROWS16>
__global__ void __launch_bounds__(R, 3) surfel_project_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_out = smem + 2 * p.stage_floats;  // [9R] transforms, [3R] colours
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

    // camera-independent: the tangent axes scaled, s_u R(q)[:, 0], s_v R(q)[:, 1]
    float mx = 0.f, my = 0.f, mz = 0.f, op = 0.f;
    float m00 = 0.f, m10 = 0.f, m20 = 0.f, m01 = 0.f, m11 = 0.f, m21 = 0.f;
    if (live) {
      mx = st[3 * r];
      my = st[3 * r + 1];
      mz = st[3 * r + 2];
      const float4 qv = reinterpret_cast<const float4*>(st + 3 * R)[r];
      const float sx = st[7 * R + 3 * r], sy = st[7 * R + 3 * r + 1];
      op = st[10 * R + r];
      const float nrm = sqrtf((qv.x * qv.x + qv.z * qv.z) + (qv.y * qv.y + qv.w * qv.w) +
                              F32(1e-24));
      const float w = qv.x / nrm, x = qv.y / nrm, y = qv.z / nrm, z = qv.w / nrm;
      m00 = (1.0f - 2.0f * (y * y + z * z)) * sx;
      m10 = (2.0f * (x * y + w * z)) * sx;
      m20 = (2.0f * (x * z - w * y)) * sx;
      m01 = (2.0f * (x * y - w * z)) * sy;
      m11 = (1.0f - 2.0f * (x * x + z * z)) * sy;
      m21 = (2.0f * (y * z + w * x)) * sy;
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
        // the tangent axes in the camera frame
        const float a0 = (R00 * m00 + R01 * m10) + R02 * m20;
        const float a1 = (R10 * m00 + R11 * m10) + R12 * m20;
        const float a2 = (R20 * m00 + R21 * m10) + R22 * m20;
        const float b0 = (R00 * m01 + R01 * m11) + R02 * m21;
        const float b1 = (R10 * m01 + R11 * m11) + R12 * m21;
        const float b2 = (R20 * m01 + R21 * m11) + R22 * m21;
        float tr[9];
        tr[0] = fx * a0 + cx * a2;
        tr[1] = fx * b0 + cx * b2;
        tr[2] = fx * px + cx * pz;
        tr[3] = fy * a1 + cy * a2;
        tr[4] = fy * b1 + cy * b2;
        tr[5] = fy * py + cy * pz;
        tr[6] = a2;
        tr[7] = b2;
        tr[8] = pz;
        const surfel::Footprint f = surfel::footprint(tr, op);
        bool ok = (pz > p.near_plane) & (pz < p.far_plane);
        ok &= (f.dist < 0.0f) & (f.dr < 0.0f) & (f.r2 > 0.0f);
        ok &= (f.bx + f.rx > 0.0f) & (f.bx - f.rx < p.width);
        ok &= (f.by + f.ry > 0.0f) & (f.by - f.ry < p.height);

        p.means2d[o] = make_float2(f.mx, f.my);
        p.boxes[o] = make_float4(f.bx, f.by, f.rx, f.ry);
        p.depths[o] = pz;
        p.valid[o] = ok;
#pragma unroll
        for (int j = 0; j < 9; ++j) s_out[9 * r + j] = tr[j];

        const float cpx = -((R00 * t0 + R10 * t1) + R20 * t2);
        const float cpy = -((R01 * t0 + R11 * t1) + R21 * t2);
        const float cpz = -((R02 * t0 + R12 * t1) + R22 * t2);
        const float dx = mx - cpx, dy = my - cpy, dz = mz - cpz;
        const float dn = sqrtf(((dx * dx + dy * dy) + dz * dz) + F32(1e-20));
        float acc[3] = {0.0f, 0.0f, 0.0f};
        sh_colour<ROWS16>(st + 11 * R + r * p.sh_stride, p.nb, dx / dn, dy / dn, dz / dn, acc);
        s_out[9 * R + 3 * r] = clamp_min(acc[0] + 0.5f, 0.0f);
        s_out[9 * R + 3 * r + 1] = clamp_min(acc[1] + 0.5f, 0.0f);
        s_out[9 * R + 3 * r + 2] = clamp_min(acc[2] + 0.5f, 0.0f);
      }
      __syncthreads();
      const int64_t base = static_cast<int64_t>(ci) * p.n + r0;
      for (int i = r; i < 9 * nr; i += R) p.transforms[9 * base + i] = s_out[i];
      for (int i = r; i < 3 * nr; i += R) p.colors[3 * base + i] = s_out[9 * R + i];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int surfel_project(const float* means, const float* quats, const float* scales,
                              const float* opac, const float* sh, const float* viewmats, const float* ks, float* means2d,
                              float* transforms, float* depths, float* boxes, float* colors,
                              uint8_t* valid, int n, int c, int k, int nb, int width, int height,
                              float near_plane, float far_plane, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  Params p;
  p.means = means;
  p.quats = quats;
  p.scales = scales;
  p.opac = opac;
  p.sh = sh;
  p.viewmats = viewmats;
  p.ks = ks;
  p.means2d = reinterpret_cast<float2*>(means2d);
  p.transforms = transforms;
  p.depths = depths;
  p.boxes = reinterpret_cast<float4*>(boxes);
  p.colors = colors;
  p.valid = valid;
  p.n = n;
  p.c = c;
  p.k = k;
  p.nb = nb;
  const bool rows16 = k % 4 == 0;
  p.sh_chunks = rows16 ? 3 * k / 4 : 0;
  p.sh_stride = rows16 ? 4 * (p.sh_chunks | 1) : 3 * k;
  p.stage_floats = 11 * R + R * p.sh_stride;
  p.width = static_cast<float>(width);
  p.height = static_cast<float>(height);
  p.near_plane = near_plane;
  p.far_plane = far_plane;

  const int bytes = static_cast<int>(sizeof(float)) * (2 * p.stage_floats + 12 * R);
  auto kernel = rows16 ? surfel_project_kernel<true> : surfel_project_kernel<false>;
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
