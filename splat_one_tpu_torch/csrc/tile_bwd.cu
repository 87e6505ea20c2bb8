// Gen-1 per-tile backward compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/tile_raster.py `_bwd_kernel`
// (launched by `_bwd_call`). It computes the same function: per (camera,
// 16 px tile), replay the tile's first min(its chunks, the forward's
// n_chunks) chunks of G = 128 slots in forward order with the forward's
// kill and clamp rules; per pixel, carry the transmittance T and the prefix
// of w * cg over the slots composited so far, and form
//   dalpha = T_i cg - (godot - gP - prefix) / (1 - alpha)
//            + gA T_final / (1 - alpha)
// (godot = sum of gout . out over rgb and depth, gA = gout of alpha); then
// per slot sum over the tile's 256 pixels the gradients of means2d, conic
// (a, b, c), opacity, rgb, depth and |d means2d| (12 columns, GROW_* of
// ops/intersect.py). Rows are slot-major, [align_cap, 16], one per slot of
// the replayed chunks; every slot belongs to exactly one tile, so every row
// has one writer. Rows of chunks past n_chunks stay as the wrapper zeroed
// them (the TPU kernel aliases a zero buffer into its output for that).
//
// Design. One block per tile, one thread per pixel (256 threads, 8 warps),
// as the forward. The TPU kernel builds in-chunk prefixes with triangular
// matmuls and sums over pixels with row reductions; here each pixel walks
// the chunk's slots in order with T and the prefix in registers, so
// (godot - gP - prefix) is formed in the plain version's order. The
// per-slot sum over 256 pixels of 12 values is taken in a fixed order with
// no atomics, as in stream_bwd.cu: a warp-shuffle butterfly over the 32
// lanes (every lane ends with the same bits), one partial per (slot, warp,
// value) in shared memory ([128][8][12] f32 = 48 KiB, with the staged chunk
// 56 KiB: dynamic shared memory above the 48 KB static limit), then one
// thread per (slot, column) adds the 8 warps' partials in warp order. The
// plain PyTorch version repeats this tree, so the two agree to the last
// bit wherever expf and the division round alike. A warp skips the shuffles
// of a slot that none of its lanes composites.
//
// What bounds it on the H100. Per evaluated (pixel, slot) pair the
// function needs about 55 f32 operations (exp as one) and one add per
// reduced value (12) for the sums over pixels. It reads each replayed slot
// row once (64 B) and fwd_out and gout once (2 x CT x 8 KiB) and writes
// 64 B per replayed slot: far below 3.35 TB/s for the time the arithmetic
// takes, so it is bound by operations. The butterfly spends 5 shuffles and
// 5 adds per value and pair instead of one add, which that bound does not
// grant. Not yet done (later work): reducing several values per shuffle,
// double-buffered chunk loads.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 128;      // slots per chunk
constexpr int NF = 16;      // floats per slot row (fields and gradients)
constexpr int TS = 16;      // tile size in pixels
constexpr int P = TS * TS;  // pixels per tile = threads per block
constexpr int OUT_CH = 8;
constexpr int CH_NCHUNKS = 5;
constexpr int WARPS = P / 32;
constexpr int NR = 12;      // reduced gradient columns

// ROW_* of splat_one_tpu_torch/ops/intersect.py
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_OPAC = 5, ROW_R = 6, ROW_G = 7, ROW_B = 8, ROW_DEPTH = 9;

constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);

constexpr int SMEM_BYTES = G * NF * 4 + G * WARPS * NR * 4;

__global__ void __launch_bounds__(P)
tile_bwd_kernel(const int* __restrict__ starts,
                const float4* __restrict__ packed,  // [align_cap, NF / 4]
                const float* __restrict__ fwd_out,  // [CT, OUT_CH, P]
                const float* __restrict__ gout,     // [CT, OUT_CH, P]
                float* __restrict__ pgrad,          // [align_cap, NF]
                int tw, int tiles_per_cam, int wrap_x, float width,
                float inv_width) {
  extern __shared__ float4 smem[];
  float4* s_chunk = smem;                                       // [G * NF / 4]
  float* s_part = reinterpret_cast<float*>(smem + G * NF / 4);  // [G][WARPS][NR]
  const float* s_rows = reinterpret_cast<const float*>(s_chunk);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;

  const int start = starts[t];
  const int64_t tile0 = static_cast<int64_t>(t) * OUT_CH * P;
  const int nchunks = min((starts[t + 1] - start) / G,
                          static_cast<int>(fwd_out[tile0 + CH_NCHUNKS * P]));
  const float* fo = fwd_out + tile0 + p;
  const float* go = gout + tile0 + p;
  const float g0 = go[0 * P], g1 = go[1 * P], g2 = go[2 * P];
  const float gA = go[3 * P], g3 = go[4 * P];
  float godot = g0 * fo[0 * P];
  godot = godot + g1 * fo[1 * P];
  godot = godot + g2 * fo[2 * P];
  godot = godot + g3 * fo[4 * P];
  const float gAT = gA * (1.0f - fo[3 * P]);  // gA * T_final

  const int rem = t % tiles_per_cam;
  const int ty = rem / tw;
  const int tx = rem % tw;
  const float px = static_cast<float>(tx * TS + p % TS) + 0.5f;
  const float py = static_cast<float>(ty * TS + p / TS) + 0.5f;

  float T = 1.0f;   // transmittance before the chunk
  float gP = 0.0f;  // sum of w * cg over the chunks before this one
  for (int k = 0; k < nchunks; ++k) {
    const int64_t row0 = static_cast<int64_t>(start) + static_cast<int64_t>(k) * G;
    __syncthreads();  // the previous chunk's rows and partials are consumed
    for (int i = p; i < G * NF / 4; i += P) s_chunk[i] = packed[row0 * (NF / 4) + i];
    __syncthreads();

    const float dconst = godot - gP;
    float tin = 1.0f;  // product of (1 - alpha) over this chunk so far
    float pre = 0.0f;  // inclusive prefix of w * cg over this chunk
    for (int g = 0; g < G; ++g) {
      float* part = s_part + (g * WARPS + warp) * NR;
      const float* row = s_rows + g * NF;
      float dx = row[ROW_X] - px;
      if (wrap_x) dx = dx - width * rintf(dx * inv_width);
      const float dy = row[ROW_Y] - py;
      const float ca = row[ROW_CA], cb = row[ROW_CB], cc = row[ROW_CC];
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float expneg = expf(-sigma);
      const float alpha_raw = row[ROW_OPAC] * expneg;
      const bool killed = (sigma < 0.0f) || (alpha_raw < ALPHA_MIN);
      const float alpha = killed ? 0.0f : fminf(alpha_raw, ALPHA_MAX);
      const float one_m = 1.0f - alpha;
      const float T_i = tin * T;
      const float w = alpha * T_i;
      float cg = row[ROW_R] * g0;
      cg = cg + row[ROW_G] * g1;
      cg = cg + row[ROW_B] * g2;
      cg = cg + row[ROW_DEPTH] * g3;
      pre = pre + w * cg;
      tin = tin * one_m;
      if (!__any_sync(0xffffffffu, alpha > 0.0f)) {  // warp-uniform
        if (lane < NR) part[lane] = 0.0f;
        continue;
      }
      const float dalpha = (T_i * cg - (dconst - pre) / one_m) + gAT / one_m;
      const bool live = !(killed || alpha_raw > ALPHA_MAX);
      const float dsigma = live ? (-dalpha) * alpha : 0.0f;
      const float dopac = live ? dalpha * expneg : 0.0f;
      const float ddx = dsigma * (ca * dx + cb * dy);
      const float ddy = dsigma * (cc * dy + cb * dx);
      float v[NR];
      v[0] = ddx;
      v[1] = ddy;
      v[2] = dsigma * 0.5f * dx * dx;
      v[3] = dsigma * dx * dy;
      v[4] = dsigma * 0.5f * dy * dy;
      v[5] = dopac;
      v[6] = w * g0;
      v[7] = w * g1;
      v[8] = w * g2;
      v[9] = w * g3;
      v[10] = fabsf(ddx);
      v[11] = fabsf(ddy);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v[r] = v[r] + __shfl_xor_sync(0xffffffffu, v[r], off);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (lane == r) part[r] = v[r];
      }
    }
    T = T * tin;
    gP = gP + pre;
    __syncthreads();

    for (int i = p; i < G * NF; i += P) {
      const int g = i / NF;
      const int c = i % NF;
      float val = 0.0f;
      if (c < NR) {
        const float* q = s_part + g * WARPS * NR + c;
        val = q[0];
        for (int wi = 1; wi < WARPS; ++wi) val = val + q[wi * NR];
      }
      pgrad[(row0 + g) * NF + c] = val;
    }
  }
}

}  // namespace

extern "C" int tile_bwd(const int* starts, const float* packed,
                        const float* fwd_out, const float* gout, float* pgrad,
                        int ct, int tw, int tiles_per_cam, int wrap_x,
                        float width, float inv_width, void* stream) {
  if (ct <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_bwd_kernel<<<ct, P, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      starts, reinterpret_cast<const float4*>(packed), fwd_out, gout, pgrad, tw,
      tiles_per_cam, wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
