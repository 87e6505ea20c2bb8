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
// has one writer. Every other row is written 0 by the kernel itself (the
// TPU kernel aliases a zero buffer into its output for that): each block
// zeroes the rows of its tile's range [starts[t], starts[t + 1]) past the
// chunks it replays, and all blocks share the rows outside every range
// ([0, starts[0]) and [starts[CT], align_cap)) in a grid-stride loop.
//
// Design. One block per tile, 128 threads, each thread two pixels, p and
// p + 16 of a row pair, so each half of a hardware warp carries one
// 32-pixel warp of the plain version's tree. The TPU kernel builds
// in-chunk prefixes with triangular matmuls and sums over pixels with row
// reductions; here each pixel walks the chunk's slots in order with T and
// the prefix in registers, so (godot - gP - prefix) is formed in the plain
// version's order. The per-slot sum over 256 pixels of 12 values is taken
// in a fixed order with no atomics, as in stream_bwd.cu: over each
// 32-pixel warp by the plain version's halving tree, its first level
// inside the thread and the other four a reduce-scatter over 16 lanes
// (bwd_common.cuh, 15 shuffles per hardware warp and slot); one partial
// per (slot, 32-pixel warp, value) in shared memory ([128][8][12] f32 =
// 48 KiB); then one thread per (slot, column) adds the 8 partials in warp
// order. So the kernel and its plain PyTorch version agree to the last
// bit; the divisions by 1 - alpha round as IEEE division does
// (bwd_common.cuh `div_rn`). A warp skips the gradient arithmetic and the
// sums of a slot that none of its 64 pixels composites, and reduces a live
// slot's sums while it forms the next live slot's gradients. A chunk is
// copied in (cp.async, 16 B per copy) before its walk: 56 KiB of dynamic
// shared memory, 4 blocks per SM, whose other blocks cover the copy. (A
// second buffer filled while the previous chunk is walked costs 8 KiB and
// a block per SM, and was slower on the H100.)
//
// What bounds it on the H100. Per evaluated (pixel, slot) pair the
// function needs about 55 f32 operations (exp as one) and one add per
// reduced value (12) for the sums over pixels. It reads each replayed slot
// row once (64 B) and fwd_out and gout once (2 x CT x 8 KiB) and writes
// 64 B per replayed slot: far below 3.35 TB/s for the time the arithmetic
// takes, so it is bound by operations. The kernel stays well above that
// bound because its warps wait: a slot is a chain of dependent steps (exp,
// reciprocal, shuffles), with 16 warps per SM to cover it. The design
// shortens the chains (no division branch, two pixels a thread, sums
// overlapped with the next slot). The rows no tile replays (most of the
// align_cap rows) are zeroed by stores that overlap that arithmetic, where
// a zeroed buffer was a separate pass before the kernel, a fifth of the
// call.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_common.cuh"

namespace {

constexpr int G = 128;      // slots per chunk
constexpr int NF = 16;      // floats per slot row (fields and gradients)
constexpr int CHUNK4 = G * NF / 4;  // float4s per staged chunk
constexpr int TS = 16;      // tile size in pixels
constexpr int P = TS * TS;  // pixels per tile
constexpr int OUT_CH = 8;
constexpr int CH_NCHUNKS = 5;
constexpr int THREADS = P / 2;      // 128: two pixels a thread
constexpr int VWARPS = P / 32;      // 32-pixel warps of the plain tree: 8
constexpr int NR = 12;      // reduced gradient columns

// ROW_* of splat_one_tpu_torch/ops/intersect.py
constexpr int ROW_X = 0, ROW_Y = 1, ROW_CA = 2, ROW_CB = 3, ROW_CC = 4;
constexpr int ROW_OPAC = 5, ROW_R = 6, ROW_G = 7, ROW_B = 8, ROW_DEPTH = 9;

constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);

// the staged chunk and the 32-pixel warps' partials
constexpr int SMEM_BYTES = G * NF * 4 + G * VWARPS * NR * 4;

__global__ void __launch_bounds__(THREADS)
tile_bwd_kernel(const int* __restrict__ starts,
                const float4* __restrict__ packed,  // [align_cap, NF / 4]
                const float* __restrict__ fwd_out,  // [CT, OUT_CH, P]
                const float* __restrict__ gout,     // [CT, OUT_CH, P]
                float* __restrict__ pgrad,          // [align_cap, NF]
                int ct, int align_cap, int tw, int tiles_per_cam,
                int tile_offset, int wrap_x, float width, float inv_width) {
  extern __shared__ float4 smem[];
  float4* s_chunk = smem;                                   // [CHUNK4]
  float* s_part = reinterpret_cast<float*>(smem + CHUNK4);  // [G][VWARPS][NR]
  const float* s_rows = reinterpret_cast<const float*>(s_chunk);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int vw = 2 * (tid >> 5) + (lane >> 4);  // this thread's 32-pixel warp
  const int p0 = vw * 32 + (lane & 15);         // its pixels p0, p0 + 16

  const int start = starts[t];
  const int64_t tile0 = static_cast<int64_t>(t) * OUT_CH * P;
  const int nchunks = min((starts[t + 1] - start) / G,
                          static_cast<int>(fwd_out[tile0 + CH_NCHUNKS * P]));

  // The rows no chunk reaches, as 0: this tile's past its replayed chunks,
  // and a share of those outside every tile's range.
  {
    float4* out4 = reinterpret_cast<float4*>(pgrad);
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int64_t lo = 4 * (static_cast<int64_t>(start) + static_cast<int64_t>(nchunks) * G);
    const int64_t hi = 4 * static_cast<int64_t>(starts[t + 1]);
    for (int64_t i = lo + tid; i < hi; i += THREADS) out4[i] = zero4;
    const int64_t head = 4 * static_cast<int64_t>(starts[0]);
    const int64_t tail0 = 4 * static_cast<int64_t>(min(starts[ct], align_cap));
    const int64_t n_out = head + 4 * static_cast<int64_t>(align_cap) - tail0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + tid; i < n_out;
         i += static_cast<int64_t>(gridDim.x) * THREADS) {
      out4[i < head ? i : tail0 + (i - head)] = zero4;
    }
  }

  // t indexes this launch's tiles (starts, fwd_out, gout); the pixels
  // come from the global tile id t + tile_offset
  const int rem = (t + tile_offset) % tiles_per_cam;
  const int ty = rem / tw;
  const int tx = rem % tw;
  const float px = static_cast<float>(tx * TS + p0 % TS) + 0.5f;
  float py[2], g0[2], g1[2], g2[2], g3[2], godot[2], gAT[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = p0 + 16 * q;
    py[q] = static_cast<float>(ty * TS + p / TS) + 0.5f;
    const float* fo = fwd_out + tile0 + p;
    const float* go = gout + tile0 + p;
    g0[q] = go[0 * P];
    g1[q] = go[1 * P];
    g2[q] = go[2 * P];
    g3[q] = go[4 * P];
    godot[q] = g0[q] * fo[0 * P];
    godot[q] = godot[q] + g1[q] * fo[1 * P];
    godot[q] = godot[q] + g2[q] * fo[2 * P];
    godot[q] = godot[q] + g3[q] * fo[4 * P];
    gAT[q] = go[3 * P] * (1.0f - fo[3 * P]);  // gA * T_final
  }

  float T[2] = {1.0f, 1.0f};   // transmittance before the chunk
  float gP[2] = {0.0f, 0.0f};  // sum of w * cg over the chunks before this one
  for (int k = 0; k < nchunks; ++k) {
    const int64_t row0 = static_cast<int64_t>(start) + static_cast<int64_t>(k) * G;
    __syncthreads();  // the previous chunk's rows and partials are consumed
    // chunk k in, four 16 B copies a thread
    const float4* src = packed + row0 * (NF / 4);
    for (int i = tid; i < CHUNK4; i += THREADS) cp_async::copy16(s_chunk + i, src + i);
    cp_async::commit();
    cp_async::wait_all();
    __syncthreads();

    float dconst[2], tin[2], pre[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dconst[q] = godot[q] - gP[q];
      tin[q] = 1.0f;  // product of (1 - alpha) over this chunk so far
      pre[q] = 0.0f;  // inclusive prefix of w * cg over this chunk
    }
    // The sums of a live slot are reduced while the next live slot's
    // gradients are formed: `spend` holds the pending slot's per-thread
    // sums, `gpend` its slot (G when there is none: nothing is stored).
    float spend[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) spend[i] = 0.0f;
    int gpend = G;
    for (int g = 0; g < G; ++g) {
      const float* row = s_rows + g * NF;
      float dx = row[ROW_X] - px;
      if (wrap_x) dx = dx - width * rintf(dx * inv_width);
      const float ca = row[ROW_CA], cb = row[ROW_CB], cc = row[ROW_CC];
      float dy[2], expneg[2], alpha_raw[2], alpha[2], one_m[2], T_i[2], w[2], cg[2];
      bool killed[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        dy[q] = row[ROW_Y] - py[q];
        const float sigma = 0.5f * (ca * dx * dx + cc * dy[q] * dy[q]) + cb * dx * dy[q];
        expneg[q] = expf(-sigma);
        alpha_raw[q] = row[ROW_OPAC] * expneg[q];
        killed[q] = (sigma < 0.0f) || (alpha_raw[q] < ALPHA_MIN);
        alpha[q] = killed[q] ? 0.0f : fminf(alpha_raw[q], ALPHA_MAX);
        one_m[q] = 1.0f - alpha[q];
        T_i[q] = tin[q] * T[q];
        w[q] = alpha[q] * T_i[q];
        cg[q] = row[ROW_R] * g0[q];
        cg[q] = cg[q] + row[ROW_G] * g1[q];
        cg[q] = cg[q] + row[ROW_B] * g2[q];
        cg[q] = cg[q] + row[ROW_DEPTH] * g3[q];
        pre[q] = pre[q] + w[q] * cg[q];
        tin[q] = tin[q] * one_m[q];
      }
      if (!__any_sync(bwd::FULL_MASK, (alpha[0] > 0.0f) || (alpha[1] > 0.0f))) {
        if ((lane & 15) < NR) s_part[(g * VWARPS + vw) * NR + (lane & 15)] = 0.0f;
        continue;  // warp-uniform
      }
      float v[2][NR];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const double inv = bwd::recip(one_m[q]);
        const float dalpha = (T_i[q] * cg[q] - bwd::div_rn(dconst[q] - pre[q], inv)) +
                             bwd::div_rn(gAT[q], inv);
        const bool live = !(killed[q] || alpha_raw[q] > ALPHA_MAX);
        const float dsigma = live ? (-dalpha) * alpha[q] : 0.0f;
        const float dopac = live ? dalpha * expneg[q] : 0.0f;
        const float ddx = dsigma * (ca * dx + cb * dy[q]);
        const float ddy = dsigma * (cc * dy[q] + cb * dx);
        v[q][0] = ddx;
        v[q][1] = ddy;
        v[q][2] = dsigma * 0.5f * dx * dx;
        v[q][3] = dsigma * dx * dy[q];
        v[q][4] = dsigma * 0.5f * dy[q] * dy[q];
        v[q][5] = dopac;
        v[q][6] = w[q] * g0[q];
        v[q][7] = w[q] * g1[q];
        v[q][8] = w[q] * g2[q];
        v[q][9] = w[q] * g3[q];
        v[q][10] = fabsf(ddx);
        v[q][11] = fabsf(ddy);
      }
      const float sum = bwd::half_warp_sum<NR>(spend, lane);
      if ((lane & 15) < NR && gpend < G) s_part[(gpend * VWARPS + vw) * NR + (lane & 15)] = sum;
#pragma unroll
      for (int r = 0; r < NR; ++r) spend[r] = v[0][r] + v[1][r];  // pixels l, l + 16
      gpend = g;
    }
    const float sum = bwd::half_warp_sum<NR>(spend, lane);
    if ((lane & 15) < NR && gpend < G) s_part[(gpend * VWARPS + vw) * NR + (lane & 15)] = sum;
    __syncthreads();

    for (int i = tid; i < G * NF; i += THREADS) {
      const int g = i / NF;
      const int c = i % NF;
      float val = 0.0f;
      if (c < NR) {
        const float* q = s_part + g * VWARPS * NR + c;
        val = q[0];
        for (int wi = 1; wi < VWARPS; ++wi) val = val + q[wi * NR];
      }
      pgrad[(row0 + g) * NF + c] = val;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T[q] = T[q] * tin[q];
      gP[q] = gP[q] + pre[q];
    }
  }
}

}  // namespace

extern "C" int tile_bwd(const int* starts, const float* packed,
                        const float* fwd_out, const float* gout, float* pgrad,
                        int ct, int align_cap, int tw, int tiles_per_cam,
                        int tile_offset, int wrap_x, float width,
                        float inv_width, void* stream) {
  if (ct <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_bwd_kernel<<<ct, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      starts, reinterpret_cast<const float4*>(packed), fwd_out, gout, pgrad, ct,
      align_cap, tw, tiles_per_cam, tile_offset, wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
