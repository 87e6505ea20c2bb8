// Supertile-stream forward compositing of 2D gaussian surfels for Hopper
// (sm_90a): stream_fwd.cu's walk with the ray-splat intersection's alpha.
//
// Replaces no TPU kernel: the JAX package has no surfel model. The plain
// version is splat_one_tpu_torch/ops/surfels.py `surfel_fwd_plain`. Per
// (camera, 32x32 px supertile) the supertile's depth-sorted slots are
// streamed in chunks of G = 128 from the aligned base floor(s0 / G) * G,
// each slot gated per 16 px tile by its footprint's box (the box the
// build used, recomputed from the row's T and opacity:
// surfel_common.cuh), composited front to back, and a tile stops at chunk
// granularity once all its 256 pixels have T < 1e-5. A slot's alpha at a
// pixel centre (x, y) (gsplat's rasterize_to_pixels_2dgs_fwd):
//
//   h_u = x w - u, h_v = y w - v, c = h_u x h_v   (u, v, w: T's rows)
//   (a, b) = (c_x, c_y) / c_z                     (killed where c_z = 0)
//   sigma = min(a^2 + b^2, 2 |(x, y) - mean2d|^2) / 2
//   alpha = min(o exp(-sigma), 0.999), killed where sigma < 0 or < 1/255
//
// and the pixel's rgb and depth sums take w c as the 3D gaussians' do.
//
// Design: stream_fwd.cu's (fwd_common.cuh), with SurfelSlots for its
// slots: the gate's thread also leaves the row's box in shared memory,
// from which each warp leaves out the slots whose box holds none of its
// pixel centres; each thread forms h_u once for its column's PPT pixels.
// ~45 f32 operations a (pixel, slot) pair against the 3D gaussians' 26.
//
// Arithmetic: the plain version's, in its order, under the build's
// --fmad=false, so that the two agree to the last bit.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_common.cuh"
#include "surfel_common.cuh"

namespace {

constexpr int PPT = 2;      // pixels a thread
constexpr int UNROLL = 4;   // slots walked together
constexpr int STAGES = 4;   // chunk buffers: STAGES - 1 chunks in flight
constexpr int SS = 2;       // tiles per supertile side
constexpr int NT = SS * SS;  // tiles per supertile
using Shape = fwd::Shape<PPT>;

// SURF_* of splat_one_tpu_torch/ops/surfels.py: x, y, T[9], opacity, r, g,
// b, depth
constexpr int SURF_T = 2, SURF_OPAC = 11;

// The rows' boxes (centre x, y, half widths x, y) of the last two chunks,
// written by the gate.
using Boxes = float4[2][fwd::G];

struct SurfelSlots {
  const Boxes* box;

  // no pixel centre of the warp's block lies in the slot's box
  template <bool WRAP, int P>
  __device__ __forceinline__ bool misses(const float4* rows, int k, int g,
                                         const fwd::Pixels<P>& pix, float, float) const {
    static_assert(!WRAP, "surfels are served by pinhole cameras");
    const float4 b = (*box)[k & 1][g];
    const float dx = fabsf(b.x - pix.bx) - pix.hx;
    const float dy = fabsf(b.y - pix.by) - pix.hy;
    return dx > b.z + 0.01f || dy > b.w + 0.01f;
  }

  template <int P, int U, bool WRAP>
  __device__ __forceinline__ void composite(const float4* rows, const unsigned char* list,
                                            int n, fwd::Pixels<P>& pix, float,
                                            float) const {
    float tin[P];  // product of (1 - alpha) over this chunk so far
#pragma unroll
    for (int q = 0; q < P; ++q) tin[q] = 1.0f;
    for (int j = 0; j < n; j += U) {
      float alpha[U][P];
      float4 color[U];  // r, g, b, depth
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* row = rows + list[j + u] * fwd::ROW4;
        const float4 a = row[0];  // x, y, u0, u1
        const float4 b = row[1];  // u2, v0, v1, v2
        const float4 c = row[2];  // w0, w1, w2, opacity
        color[u] = row[3];
        const float hu0 = pix.px * c.x - a.z;
        const float hu1 = pix.px * c.y - a.w;
        const float hu2 = pix.px * c.z - b.x;
        const float dx = a.x - pix.px;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float hv0 = pix.py[q] * c.x - b.y;
          const float hv1 = pix.py[q] * c.y - b.z;
          const float hv2 = pix.py[q] * c.z - b.w;
          const float cx = hu1 * hv2 - hu2 * hv1;
          const float cy = hu2 * hv0 - hu0 * hv2;
          const float cz = hu0 * hv1 - hu1 * hv0;
          const float su = cx / cz, sv = cy / cz;
          const float g3 = su * su + sv * sv;
          const float dy = a.y - pix.py[q];
          const float g2 = 2.0f * (dx * dx + dy * dy);
          const float sigma = 0.5f * (g3 < g2 ? g3 : g2);
          const float alpha_raw = c.w * expf(-sigma);
          alpha[u][q] = (cz == 0.0f || sigma < 0.0f || alpha_raw < fwd::ALPHA_MIN)
                            ? 0.0f
                            : fminf(alpha_raw, fwd::ALPHA_MAX);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float w = alpha[u][q] * tin[q] * pix.T[q];
          pix.acc[q][0] = pix.acc[q][0] + w * color[u].x;
          pix.acc[q][1] = pix.acc[q][1] + w * color[u].y;
          pix.acc[q][2] = pix.acc[q][2] + w * color[u].z;
          pix.acc[q][3] = pix.acc[q][3] + w * color[u].w;
          tin[q] = tin[q] * (1.0f - alpha[u][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) pix.T[q] = pix.T[q] * tin[q];
  }
};

__global__ void __launch_bounds__(Shape::THREADS)
surfel_fwd_kernel(const int* __restrict__ st_starts,
                  const float4* __restrict__ packed,  // [rows, NF / 4]
                  float* __restrict__ out,            // [CS, NT, OUT_CH, P]
                  int sw, int sh, float term_thresh) {
  __shared__ fwd::Smem<Shape::WARPS, UNROLL, STAGES> sm;
  __shared__ Boxes box;
  const int tile = blockIdx.x;  // t * NT + j
  const int t = tile / NT;
  const int j = tile % NT;

  const int s0 = st_starts[t];
  const int s1 = st_starts[t + 1];
  const int base0 = (s0 / fwd::G) * fwd::G;
  const int nchunks = (s1 - base0 + fwd::G - 1) / fwd::G;

  const int st = t % (sw * sh);
  const int tx = (st % sw) * SS + j % SS;
  const int ty = (st / sw) * SS + j / SS;
  fwd::Pixels<PPT> pix;
  pix.init(tx * fwd::TS, ty * fwd::TS, threadIdx.x);

  const float tsf = static_cast<float>(fwd::TS);
  const float txf = static_cast<float>(tx);
  const float tyf = static_cast<float>(ty);
  // the slot belongs to the supertile's range and its footprint's box
  // covers this tile (the plain version's _surfel_gate); the box stays for
  // the warps' culling
  auto gate = [&](const float* row, int slot) {
    const int idx = base0 + slot;
    const surfel::Footprint f = surfel::footprint(row + SURF_T, row[SURF_OPAC]);
    box[(slot / fwd::G) & 1][slot % fwd::G] = make_float4(f.bx, f.by, f.rx, f.ry);
    const bool in_y =
        (tyf >= floorf((f.by - f.ry) / tsf)) && (tyf < ceilf((f.by + f.ry) / tsf));
    const bool in_x =
        (txf >= floorf((f.bx - f.rx) / tsf)) && (txf < ceilf((f.bx + f.rx) / tsf));
    return (idx >= s0) && (idx < s1) && in_x && in_y;
  };
  const SurfelSlots slots{&box};
  const int nch = fwd::walk_tile<PPT, UNROLL, STAGES, false, false>(
      sm, packed + static_cast<int64_t>(base0) * fwd::ROW4, nchunks, pix, gate, 0.0f, 0.0f,
      term_thresh, slots);
  pix.store(out + static_cast<int64_t>(tile) * fwd::OUT_CH * fwd::P, nch);
}

}  // namespace

extern "C" int surfel_fwd(const int* st_starts, const float* packed, float* out, int cs,
                          int sw, int sh, float term_thresh, void* stream) {
  if (cs <= 0) return 0;
  surfel_fwd_kernel<<<cs * NT, Shape::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      st_starts, reinterpret_cast<const float4*>(packed), out, sw, sh, term_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
