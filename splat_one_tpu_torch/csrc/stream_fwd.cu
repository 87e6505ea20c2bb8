// Supertile-stream forward compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/stream_raster.py
// `_stream_fwd_kernel` (launched by `_fwd_call`). It computes the same
// function: per (camera, 32x32 px supertile), stream the supertile's
// depth-sorted slots in chunks of G = 128 from the aligned base
// floor(s0 / G) * G, gate each slot per 16 px tile by its ellipse extents
// (COL_EXT_RX/RY, spherical x-span modular), composite front to back with
// alpha = min(opa * exp(-sigma), 0.999), killed where sigma < 0 or
// alpha < 1/255, and stop a tile at chunk granularity once all its 256
// pixels have T < 1e-5. n_chunks records, per tile, the last chunk
// it composited (the backward replays exactly these).
//
// Design. A tile's result depends only on its own gates and its own
// termination, so the grid has one block per tile, not per supertile: the four tiles of a crowded
// supertile run on four SMs. Each tile walks the supertile's chunks
// itself (fwd_common.cuh): STAGES - 1 chunks are in flight (cp.async)
// while one is walked, the tile's 128-bit gate mask is built by the
// threads that staged the rows and a ballot, one barrier a chunk doubles
// as the termination test, and each pixel visits only the gated slots,
// PPT pixels a thread, UNROLL slots at a time, the spherical wrap a
// compile-time branch. The TPU version builds the in-chunk
// transmittance as a log2(G)-step doubling product over a [G, 256] tile
// and accumulates colours with a split-bf16 MXU matmul; here each pixel
// walks the slots in order with a running T in registers (the serial form
// of that product) in plain f32, so the kernel and its plain PyTorch
// version agree to the last bit.
//
// What bounds it on the H100. It reads the slot rows of the chunks its
// tiles reach (64 B each, four times per supertile chunk, from L2 after
// the first) and writes [CS, 4, 8, 256] f32: far below 3.35 TB/s for the
// time its arithmetic takes. Per gated (pixel, slot) pair the function
// needs about 26 f32 operations with one exp, so it is bound by f32 issue
// where many tiles share the card (a pinhole view) and by the latency of
// the longest tile's serial walk where the slots crowd into a few
// supertiles (a spherical view of a compact scene): the design keeps
// that walk free of ungated slots, exposed loads and extra barriers.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_common.cuh"

namespace {

constexpr int PPT = 2;      // pixels a thread
constexpr int UNROLL = 4;   // slots walked together
constexpr int STAGES = 4;   // chunk buffers: STAGES - 1 chunks in flight
constexpr int SS = 2;       // tiles per supertile side
constexpr int NT = SS * SS;  // tiles per supertile
using Shape = fwd::Shape<PPT>;

// COL_EXT_* of splat_one_tpu_torch/ops/stream_isect.py
constexpr int COL_EXT_RX = 12, COL_EXT_RY = 13;

template <bool WRAP>
__global__ void __launch_bounds__(Shape::THREADS)
stream_fwd_kernel(const int* __restrict__ st_starts,
                  const float4* __restrict__ packed,  // [rows, NF / 4]
                  float* __restrict__ out,            // [CS, NT, OUT_CH, P]
                  int sw, int sh, int tw, int st_offset, float width,
                  float inv_width) {
  __shared__ fwd::Smem<Shape::WARPS, UNROLL, STAGES> sm;
  const int tile = blockIdx.x;  // t * NT + j
  const int t = tile / NT;
  const int j = tile % NT;

  const int s0 = st_starts[t];
  const int s1 = st_starts[t + 1];
  const int base0 = (s0 / fwd::G) * fwd::G;
  const int nchunks = (s1 - base0 + fwd::G - 1) / fwd::G;

  // t indexes this launch's slab (st_starts, out); the pixels come from
  // the global supertile id t + st_offset
  const int st = (t + st_offset) % (sw * sh);
  const int tx = (st % sw) * SS + j % SS;
  const int ty = (st / sw) * SS + j / SS;
  fwd::Pixels<PPT> pix;
  pix.init(tx * fwd::TS, ty * fwd::TS, threadIdx.x);

  const float tsf = static_cast<float>(fwd::TS);
  const float txf = static_cast<float>(tx);
  const float tyf = static_cast<float>(ty);
  const float twf = static_cast<float>(tw);
  // the slot belongs to the supertile's range and its ellipse bbox covers
  // this tile (the plain version's _chunk_gate)
  auto gate = [&](const float* row, int slot) {
    const int idx = base0 + slot;
    const float x = row[fwd::X], y = row[fwd::Y];
    const float rx = row[COL_EXT_RX], ry = row[COL_EXT_RY];
    const bool in_y = (tyf >= floorf((y - ry) / tsf)) && (tyf < ceilf((y + ry) / tsf));
    bool in_x;
    if constexpr (WRAP) {
      const float tx0 = floorf((x - rx) / tsf);
      const float span = fminf(ceilf((x + rx) / tsf) - tx0, twf);
      float rel = fmodf(txf - tx0, twf);
      if (rel < 0.0f) rel += twf;
      in_x = rel < span;
    } else {
      in_x = (txf >= floorf((x - rx) / tsf)) && (txf < ceilf((x + rx) / tsf));
    }
    return (idx >= s0) && (idx < s1) && in_x && in_y;
  };
  const int nch = fwd::walk_tile<PPT, UNROLL, STAGES, WRAP, false>(
      sm, packed + static_cast<int64_t>(base0) * fwd::ROW4, nchunks, pix, gate, width,
      inv_width);
  pix.store(out + static_cast<int64_t>(tile) * fwd::OUT_CH * fwd::P, nch);
}

}  // namespace

extern "C" int stream_fwd(const int* st_starts, const float* packed,
                          float* out, int cs, int sw, int sh, int tw,
                          int st_offset, int wrap_x, float width,
                          float inv_width, void* stream) {
  if (cs <= 0) return 0;
  auto* kernel = wrap_x ? stream_fwd_kernel<true> : stream_fwd_kernel<false>;
  kernel<<<cs * NT, Shape::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      st_starts, reinterpret_cast<const float4*>(packed), out, sw, sh, tw, st_offset,
      width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
