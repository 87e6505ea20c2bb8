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
// Design. One block per supertile, one thread per pixel of its four tiles
// (1024 threads; each warp lies inside one tile). The TPU version builds
// the in-chunk transmittance as a log2(G)-step doubling product over a
// [G, 256] tile and accumulates colours with a split-bf16 MXU matmul;
// here each pixel's thread walks the chunk's slots in order with a
// running T in registers (the serial form of that product) and
// accumulates in plain f32. A chunk's 128 slot rows (64 bytes each, 8 KB)
// are loaded into shared memory with one 16-byte load per thread, the
// per-(tile, slot) gate is built once per chunk by 512 threads, and the
// pixel loop skips gated-out slots with a warp-uniform branch.
//
// What bounds it on the H100. It reads each slot row once (n_isect * 64
// bytes) and writes [CS, 4, 8, 256] f32, a few hundred MB/s of work at
// 1M gaussians / 720p: far below 3.35 TB/s. The per-(pixel, live slot)
// arithmetic (about 25 f32 operations and one exp) dominates, so the
// kernel is bound by f32 issue rate and by how well the gate prunes
// slots; early termination caps the chunks a dense supertile streams.
// Shared-memory reads are warp broadcasts. Not yet done (later work):
// double-buffered cp.async/TMA chunk loads, multiple pixels per thread.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 128;           // slots per chunk
constexpr int NF = 16;           // floats per slot row
constexpr int TS = 16;           // tile size in pixels
constexpr int SS = 2;            // tiles per supertile side
constexpr int NT = SS * SS;      // tiles per supertile
constexpr int P = TS * TS;       // pixels per tile
constexpr int OUT_CH = 8;
constexpr int THREADS = NT * P;  // 1024

// COL_* of splat_one_tpu_torch/ops/stream_isect.py
constexpr int COL_X = 0, COL_Y = 1, COL_CA = 2, COL_CB = 3, COL_CC = 4;
constexpr int COL_OPAC = 5, COL_R = 6, COL_G = 7, COL_B = 8, COL_DEPTH = 9;
constexpr int COL_EXT_RX = 12, COL_EXT_RY = 13;

// The JAX package's Python-double constants rounded once to f32.
constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);
constexpr float TERM_THRESH = 1e-5f;  // TERM_THRESH of ops/stream_raster.py

__global__ void __launch_bounds__(THREADS)
stream_fwd_kernel(const int* __restrict__ st_starts,
                  const float4* __restrict__ packed,  // [rows, NF / 4]
                  float* __restrict__ out,            // [CS, NT, OUT_CH, P]
                  int sw, int sh, int tw, int wrap_x, float width,
                  float inv_width) {
  __shared__ float4 s_chunk[G * NF / 4];
  __shared__ unsigned char s_gate[NT][G];
  // Flags double-buffered by chunk parity: buffer k & 1 is written during
  // chunk k and cleared during chunk k + 1, after every thread has passed
  // the barrier that ends its reads of chunk k - 1.
  __shared__ int s_alive[2][NT];
  __shared__ int s_live[2][NT];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid / P;  // this thread's tile
  const int p = tid % P;
  const int lane = tid & 31;

  const int s0 = st_starts[t];
  const int s1 = st_starts[t + 1];
  const int base0 = (s0 / G) * G;
  const int nchunks = (s1 - base0 + G - 1) / G;

  const int st = t % (sw * sh);
  const int sy = st / sw;
  const int sx = st % sw;
  const float px = static_cast<float>((sx * SS + j % SS) * TS + p % TS) + 0.5f;
  const float py = static_cast<float>((sy * SS + j / SS) * TS + p / TS) + 0.5f;

  if (tid < 2 * NT) {
    (&s_alive[0][0])[tid] = 0;
    (&s_live[0][0])[tid] = 0;
  }

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int nch = 0;
  for (int k = 0; k < nchunks; ++k) {
    const int b = k & 1;
    __syncthreads();  // previous chunk fully consumed; flag buffer b clear
    if (tid < NT) {
      s_alive[b ^ 1][tid] = 0;
      s_live[b ^ 1][tid] = 0;
    }
    const bool alive = T >= TERM_THRESH;
    if (__any_sync(0xffffffffu, alive) && lane == 0) s_alive[b][j] = 1;
    const int row0 = base0 + k * G;
    if (tid < G * NF / 4) {
      s_chunk[tid] = packed[static_cast<int64_t>(row0) * (NF / 4) + tid];
    }
    __syncthreads();
    if (!(s_alive[b][0] | s_alive[b][1] | s_alive[b][2] | s_alive[b][3])) {
      break;  // every tile terminated (block-uniform)
    }
    if (tid < NT * G) {
      const int jj = tid / G;
      const int g = tid % G;
      const float* row = reinterpret_cast<const float*>(s_chunk) + g * NF;
      const int idx = row0 + g;
      const float tsf = static_cast<float>(TS);
      const float txf = static_cast<float>(sx * SS + jj % SS);
      const float tyf = static_cast<float>(sy * SS + jj / SS);
      const float x = row[COL_X], y = row[COL_Y];
      const float rx = row[COL_EXT_RX], ry = row[COL_EXT_RY];
      const bool in_y = (tyf >= floorf((y - ry) / tsf)) &&
                        (tyf < ceilf((y + ry) / tsf));
      bool in_x;
      if (wrap_x) {
        const float twf = static_cast<float>(tw);
        const float tx0 = floorf((x - rx) / tsf);
        const float span = fminf(ceilf((x + rx) / tsf) - tx0, twf);
        float rel = fmodf(txf - tx0, twf);
        if (rel < 0.0f) rel += twf;
        in_x = rel < span;
      } else {
        in_x = (txf >= floorf((x - rx) / tsf)) && (txf < ceilf((x + rx) / tsf));
      }
      const bool live = (idx >= s0) && (idx < s1) && in_x && in_y;
      s_gate[jj][g] = live;
      if (live) s_live[b][jj] = 1;
    }
    __syncthreads();
    if (s_alive[b][j] && s_live[b][j]) {
      float tin = 1.0f;  // product of (1 - alpha) over this chunk so far
      for (int g = 0; g < G; ++g) {
        if (!s_gate[j][g]) continue;  // warp-uniform
        const float* row = reinterpret_cast<const float*>(s_chunk) + g * NF;
        float dx = row[COL_X] - px;
        if (wrap_x) dx = dx - width * rintf(dx * inv_width);
        const float dy = row[COL_Y] - py;
        const float sigma =
            0.5f * (row[COL_CA] * dx * dx + row[COL_CC] * dy * dy) +
            row[COL_CB] * dx * dy;
        const float alpha_raw = row[COL_OPAC] * expf(-sigma);
        if (sigma < 0.0f || alpha_raw < ALPHA_MIN) continue;
        const float alpha = fminf(alpha_raw, ALPHA_MAX);
        const float w = alpha * tin * T;
        acc_r = acc_r + w * row[COL_R];
        acc_g = acc_g + w * row[COL_G];
        acc_b = acc_b + w * row[COL_B];
        acc_d = acc_d + w * row[COL_DEPTH];
        tin = tin * (1.0f - alpha);
      }
      T = T * tin;
      nch = k + 1;
    }
  }

  float* o = out + (static_cast<int64_t>(t) * NT + j) * OUT_CH * P + p;
  o[0 * P] = acc_r;
  o[1 * P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = 1.0f - T;
  o[4 * P] = acc_d;
  o[5 * P] = static_cast<float>(nch);
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

}  // namespace

extern "C" int stream_fwd(const int* st_starts, const float* packed,
                          float* out, int cs, int sw, int sh, int tw,
                          int wrap_x, float width, float inv_width,
                          void* stream) {
  if (cs <= 0) return 0;
  stream_fwd_kernel<<<cs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      st_starts, reinterpret_cast<const float4*>(packed), out, sw, sh, tw,
      wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
