// Gen-1 per-tile forward compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/tile_raster.py `_fwd_kernel`
// (launched by `_fwd_call`). It computes the same function: per (camera,
// 16 px tile), walk the tile's G-aligned slot range [starts[t],
// starts[t + 1]) of the packed [align_cap, 16] field table in chunks of
// G = 128, composite front to back with alpha = min(opa * exp(-sigma),
// 0.999), killed where sigma < 0 or alpha < 1/255, and stop the tile at the
// first chunk start where all its 256 pixels have T < 1e-5. Channel 5 of
// the output records how many chunks it composited (the backward replays
// exactly these). Membership comes from the builder: no per-slot gate, and
// padding slots are zero rows (opacity 0, always killed).
//
// Design. One block per tile, walking
// its chunks with the forward kernels' shared walk (fwd_common.cuh):
// STAGES - 1 chunks in flight (cp.async) while one is walked, one barrier
// a chunk that doubles as the termination test, PPT pixels a thread,
// UNROLL slots at a time, the spherical wrap a compile-time branch. A slot whose opacity is below ALPHA_MIN / 2 is killed at
// every pixel (alpha = opa * exp(-sigma) <= opa for sigma >= 0, within
// expf's 2 ulp), so the walk skips it: the padding rows at the end of each
// tile's last chunk are never visited. The TPU kernel forms the in-chunk
// exclusive transmittance in log space with a strictly lower-triangular
// [128, 128] matmul and the colour sums with an [8, G] x [G, 256] matmul on
// the MXU; here each pixel walks the slots in order with a running T in
// registers (the serial form of those sums) in plain f32, bit for bit as
// the plain PyTorch version.
//
// What bounds it on the H100. It reads each slot row of the chunks it
// reaches once (64 B) and writes [CT, 8, 256] f32: well below 3.35 TB/s for
// the time its arithmetic takes. Every slot of a processed chunk is
// evaluated at all 256 pixels (about 26 f32 operations with one exp per
// pair), so it is bound by f32 issue where many tiles share the card, and
// by the latency of the longest tile's walk where the slots crowd into a
// few tiles; early termination caps the chunks a dense tile streams.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_common.cuh"

namespace {

constexpr int PPT = 2;      // pixels a thread
constexpr int UNROLL = 4;   // slots walked together
constexpr int STAGES = 4;   // chunk buffers: STAGES - 1 chunks in flight
using Shape = fwd::Shape<PPT>;

template <bool WRAP>
__global__ void __launch_bounds__(Shape::THREADS)
tile_fwd_kernel(const int* __restrict__ starts,
                const float4* __restrict__ packed,  // [align_cap, NF / 4]
                float* __restrict__ out,            // [CT, OUT_CH, P]
                int tw, int tiles_per_cam, int tile_offset, float width,
                float inv_width, float term_thresh) {
  __shared__ fwd::Smem<Shape::WARPS, UNROLL, STAGES> sm;
  const int t = blockIdx.x;
  const int start = starts[t];
  const int nchunks = (starts[t + 1] - start) / fwd::G;
  // t indexes this launch's tiles (starts, out); the pixels come from the
  // global tile id t + tile_offset
  const int rem = (t + tile_offset) % tiles_per_cam;
  fwd::Pixels<PPT> pix;
  pix.init((rem % tw) * fwd::TS, (rem / tw) * fwd::TS, threadIdx.x);

  auto may_composite = [](const float* row, int) {
    return !(row[fwd::OPAC] < 0.5f * fwd::ALPHA_MIN);
  };
  const int nch = fwd::walk_tile<PPT, UNROLL, STAGES, WRAP, true>(
      sm, packed + static_cast<int64_t>(start) * fwd::ROW4, nchunks, pix, may_composite,
      width, inv_width, term_thresh);
  pix.store(out + static_cast<int64_t>(t) * fwd::OUT_CH * fwd::P, nch);
}

}  // namespace

extern "C" int tile_fwd(const int* starts, const float* packed, float* out,
                        int ct, int tw, int tiles_per_cam, int tile_offset,
                        int wrap_x, float width, float inv_width, float term_thresh,
                        void* stream) {
  if (ct <= 0) return 0;
  auto* kernel = wrap_x ? tile_fwd_kernel<true> : tile_fwd_kernel<false>;
  kernel<<<ct, Shape::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, reinterpret_cast<const float4*>(packed), out, tw, tiles_per_cam, tile_offset,
      width, inv_width, term_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
