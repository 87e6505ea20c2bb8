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
// Design. One block per tile, one thread per pixel (256 threads, 8 warps).
// The TPU kernel forms the in-chunk exclusive transmittance in log space
// with a strictly lower-triangular [128, 128] matmul and the colour sums
// with an [8, G] x [G, 256] matmul on the MXU; here each pixel's thread
// walks the chunk's slots in order with a running T in registers (the
// serial form of those sums) in plain f32, as the stream kernel does. A
// chunk's 128 rows (64 B each, 8 KB) are staged in shared memory with two
// 16-byte loads per thread; every read of them is a warp broadcast. The
// termination test is __syncthreads_or(T >= 1e-5) before each chunk,
// where the TPU kernel's while-loop condition tests the tile's max T.
//
// What bounds it on the H100. It reads each slot row of the chunks it
// reaches once (64 B) and writes [CT, 8, 256] f32: well below 3.35 TB/s for
// the time its arithmetic takes. Every slot of a processed chunk is
// evaluated at all 256 pixels (about 26 f32 operations with one exp per
// pair), so it is bound by f32 issue rate; early termination caps the
// chunks a dense tile streams. Not yet done (later work): double-buffered
// cp.async/TMA chunk loads, several pixels per thread, skipping slots
// whose ellipse misses a whole warp.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 128;   // slots per chunk
constexpr int NF = 16;   // floats per slot row
constexpr int TS = 16;   // tile size in pixels
constexpr int P = TS * TS;  // pixels per tile = threads per block
constexpr int OUT_CH = 8;

// ROW_* of splat_one_tpu_torch/ops/intersect.py
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_OPAC = 5, ROW_R = 6, ROW_G = 7, ROW_B = 8, ROW_DEPTH = 9;

// The JAX package's Python-double constants rounded once to f32.
constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);
constexpr float TERM_THRESH = 1e-5f;  // TERM_THRESH of ops/stream_raster.py

__global__ void __launch_bounds__(P)
tile_fwd_kernel(const int* __restrict__ starts,
                const float4* __restrict__ packed,  // [align_cap, NF / 4]
                float* __restrict__ out,            // [CT, OUT_CH, P]
                int tw, int tiles_per_cam, int wrap_x, float width,
                float inv_width) {
  __shared__ float4 s_chunk[G * NF / 4];
  const float* s_rows = reinterpret_cast<const float*>(s_chunk);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = starts[t];
  const int nchunks = (starts[t + 1] - start) / G;
  const int rem = t % tiles_per_cam;
  const int ty = rem / tw;
  const int tx = rem % tw;
  const float px = static_cast<float>(tx * TS + p % TS) + 0.5f;
  const float py = static_cast<float>(ty * TS + p / TS) + 0.5f;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int k = 0;
  for (; k < nchunks; ++k) {
    // also the barrier after which the previous chunk's rows are consumed
    if (!__syncthreads_or(T >= TERM_THRESH)) break;
    const int64_t base = (static_cast<int64_t>(start) + static_cast<int64_t>(k) * G) * (NF / 4);
    for (int i = p; i < G * NF / 4; i += P) s_chunk[i] = packed[base + i];
    __syncthreads();
    float tin = 1.0f;  // product of (1 - alpha) over this chunk so far
    for (int g = 0; g < G; ++g) {
      const float* row = s_rows + g * NF;
      float dx = row[ROW_X] - px;
      if (wrap_x) dx = dx - width * rintf(dx * inv_width);
      const float dy = row[ROW_Y] - py;
      const float sigma =
          0.5f * (row[ROW_CA] * dx * dx + row[ROW_CC] * dy * dy) +
          row[ROW_CB] * dx * dy;
      const float alpha_raw = row[ROW_OPAC] * expf(-sigma);
      if (sigma < 0.0f || alpha_raw < ALPHA_MIN) continue;
      const float alpha = fminf(alpha_raw, ALPHA_MAX);
      const float w = alpha * tin * T;
      acc_r = acc_r + w * row[ROW_R];
      acc_g = acc_g + w * row[ROW_G];
      acc_b = acc_b + w * row[ROW_B];
      acc_d = acc_d + w * row[ROW_DEPTH];
      tin = tin * (1.0f - alpha);
    }
    T = T * tin;
  }

  float* o = out + static_cast<int64_t>(t) * OUT_CH * P + p;
  o[0 * P] = acc_r;
  o[1 * P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = 1.0f - T;
  o[4 * P] = acc_d;
  o[5 * P] = static_cast<float>(k);
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

}  // namespace

extern "C" int tile_fwd(const int* starts, const float* packed, float* out,
                        int ct, int tw, int tiles_per_cam, int wrap_x,
                        float width, float inv_width, void* stream) {
  if (ct <= 0) return 0;
  tile_fwd_kernel<<<ct, P, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, reinterpret_cast<const float4*>(packed), out, tw, tiles_per_cam,
      wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
