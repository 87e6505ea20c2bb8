// Supertile-stream backward compositing for Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/stream_raster.py
// `_stream_bwd_kernel` (launched by `_bwd_call`). It computes the same
// function: per (camera, 32x32 px supertile), replay the forward's chunks
// of G = 128 slots from floor(s0 / G) * G, each tile only up to its forward
// chunk count (channel 5 of fwd_out), with the forward's gate, kill and
// clamp rules; per pixel, carry the transmittance T and the prefix of
// w * cg over the slots composited so far, and form
//   dalpha = T_i cg - (godot - gP - prefix) / (1 - alpha)
//            + gA T_final / (1 - alpha)
// (godot = sum of gout . out over rgb and depth, gA = gout of alpha); then
// per slot sum over the supertile's 4 x 256 pixels the gradients of
// means2d, conic (a, b, c), opacity, rgb, depth and, with absgrad,
// |d means2d|. Rows are written slot-major, [pad_cap, 16], at the
// supertile's G-aligned offset st_starts_al[t] + k G + g; column 12 is the
// reduce key, gid + 1 on the supertile's own slots and 0 elsewhere. Every
// other row of the output is written 0 by the kernel itself (the output
// needs no zeroed buffer): each block zeroes the rows of its range
// [st_starts_al[t], st_starts_al[t + 1]) past the chunks it replays, and
// all blocks share the rows outside every range ([0, st_starts_al[0]) and
// [st_starts_al[CS], pad_cap)) in a grid-stride loop.
//
// Design. One block per supertile, 512 threads, each thread two pixels of
// one tile, p and p + 16 of a row pair, so each half of a hardware warp
// carries one 32-pixel warp of the plain version's tree. The TPU kernel
// builds in-chunk prefixes with doubling networks over [G, 256] and sums
// over pixels with row reductions; here each pixel walks the chunk's
// slots in order with T and the prefix in registers. The per-slot sum
// over 1,024 pixels of 10 or 12 values is taken in a fixed order, with no
// atomics: over each 32-pixel warp by the plain version's halving tree,
// its first level inside the thread and the other four a reduce-scatter
// over 16 lanes (bwd_common.cuh, 15 shuffles per hardware warp and slot);
// one partial per (slot, 32-pixel warp, value) in shared memory
// (G x 32 x 12 floats, 192 KiB); after the chunk, one thread per (slot,
// column) adds the 32 partials in warp order, a tile that does not gate
// the slot adding 0. So the kernel and its plain PyTorch version agree to
// the last bit; the divisions by 1 - alpha round as IEEE division does
// (bwd_common.cuh `div_rn`). A warp visits only the slots its tile gates
// (a bit mask from the gate bytes), skips the gradient arithmetic and the
// sums of a slot that none of its 64 pixels composites, and reduces a live
// slot's sums while it forms the next live slot's gradients. Chunks are
// staged asynchronously: chunk k + 1 is copied (cp.async, 16 B a thread)
// into the second of two 8 KiB buffers while chunk k is walked, and its
// gate bytes (two 512 B buffers) are built while chunk k's partials are
// added: two barriers a chunk and no exposed load.
//
// What bounds it on the H100. Per evaluated (pixel, slot) pair the
// function needs about 55 f32 operations (exp as one) and, for the sums
// over pixels, one add per reduced value (10 or 12). It reads each slot
// row once (64 B) and fwd_out and gout once (2 x CS x 32 KiB) and writes
// pad_cap x 64 B, far below 3.35 TB/s for the time the arithmetic takes,
// so it is bound by operations: the pairs its data needs x ~65 f32
// operations at 67 TFLOP/s. The kernel stays well above that bound because
// its warps wait: a slot is a chain of dependent steps (exp, reciprocal,
// shuffles) and one block of 16 warps per SM (98-99 registers a thread,
// 209 KiB of shared memory) waits at every chunk's barrier for the warps
// of the supertile's busiest tile. The design shortens the chains (no
// division branch, two pixels a thread, sums overlapped with the next
// slot) and never visits an ungated slot. The rows no chunk reaches are
// zeroed by stores that overlap that arithmetic, where a zeroed buffer
// was a separate pass before the kernel. A cluster of four tile blocks
// (four blocks of 4 warps an SM, each waiting only for its own cluster,
// the partials summed through distributed shared memory) was slower on
// the H100 at the 1M pinhole step input and no faster at the spherical
// one: its warps still wait for the supertile's busiest tile every chunk,
// and they walk the same chains with no more of them resident.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_common.cuh"

namespace {

constexpr int G = 128;           // slots per chunk
constexpr int NF = 16;           // floats per slot row (fields and gradients)
constexpr int CHUNK4 = G * NF / 4;  // float4s per staged chunk
constexpr int TS = 16;           // tile size in pixels
constexpr int SS = 2;            // tiles per supertile side
constexpr int NT = SS * SS;      // tiles per supertile
constexpr int P = TS * TS;       // pixels per tile
constexpr int OUT_CH = 8;
constexpr int CH_NCHUNKS = 5;
constexpr int THREADS = NT * P / 2;  // 512: two pixels a thread
constexpr int TILE_THREADS = P / 2;  // 128
constexpr int VWARPS = NT * P / 32;  // 32-pixel warps of the plain tree: 32
static_assert(THREADS == NT * G && THREADS == CHUNK4,
              "each thread builds one gate byte and copies 16 B of a chunk");

// COL_* and GCOL_KEY of splat_one_tpu_torch/ops/stream_isect.py
constexpr int COL_X = 0, COL_Y = 1, COL_CA = 2, COL_CB = 3, COL_CC = 4;
constexpr int COL_OPAC = 5, COL_R = 6, COL_G = 7, COL_B = 8, COL_DEPTH = 9;
constexpr int COL_GID = 11, COL_EXT_RX = 12, COL_EXT_RY = 13;
constexpr int GCOL_KEY = 12;

constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);

// two staged chunks, the 32-pixel warps' partials, two chunks' gate bytes
template <int NR>
constexpr int smem_bytes() {
  return 2 * G * NF * 4 + G * VWARPS * NR * 4 + 2 * NT * G;
}

template <bool ABS>
__global__ void __launch_bounds__(THREADS)
stream_bwd_kernel(const int* __restrict__ st_starts,
                  const int* __restrict__ st_starts_al,
                  const float4* __restrict__ packed,  // [rows, NF / 4]
                  const float* __restrict__ fwd_out,  // [CS, NT, OUT_CH, P]
                  const float* __restrict__ gout,     // [CS, NT, OUT_CH, P]
                  float* __restrict__ pgrad,          // [pad_cap, NF]
                  int cs, int pad_cap, int sw, int sh, int tw, int st_offset,
                  int wrap_x, float width, float inv_width) {
  constexpr int NR = ABS ? 12 : 10;  // reduced gradient columns
  extern __shared__ float4 smem[];
  float4* s_chunk = smem;                                        // [2][CHUNK4]
  float* s_part = reinterpret_cast<float*>(smem + 2 * CHUNK4);  // [G][VWARPS][NR]
  unsigned char* s_gate =
      reinterpret_cast<unsigned char*>(s_part + G * VWARPS * NR);  // [2][NT][G]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = tid / TILE_THREADS;                 // this thread's tile
  const int vw = 2 * (tid >> 5) + (lane >> 4);      // its 32-pixel warp
  const int p0 = (vw % (P / 32)) * 32 + (lane & 15);  // its pixels p0, p0 + 16

  const int s0 = st_starts[t];
  const int s1 = st_starts[t + 1];
  const int base0 = (s0 / G) * G;
  const int a0 = st_starts_al[t];

  const int64_t tile0 = static_cast<int64_t>(t) * NT * OUT_CH * P;
  int nch_max = 0;
  for (int jj = 0; jj < NT; ++jj) {
    nch_max = max(nch_max,
                  static_cast<int>(fwd_out[tile0 + (jj * OUT_CH + CH_NCHUNKS) * P]));
  }
  const int nchunks = min((s1 - base0 + G - 1) / G, nch_max);

  // The rows no chunk reaches, as 0: this supertile's past its replayed
  // chunks, and a share of those outside every range.
  {
    float4* out4 = reinterpret_cast<float4*>(pgrad);
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int64_t lo = 4 * (static_cast<int64_t>(a0) + static_cast<int64_t>(nchunks) * G);
    const int64_t hi = 4 * static_cast<int64_t>(st_starts_al[t + 1]);
    for (int64_t i = lo + tid; i < hi; i += THREADS) out4[i] = zero4;
    const int64_t head = 4 * static_cast<int64_t>(st_starts_al[0]);
    const int64_t tail0 = 4 * static_cast<int64_t>(min(st_starts_al[cs], pad_cap));
    const int64_t n_out = head + 4 * static_cast<int64_t>(pad_cap) - tail0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + tid; i < n_out;
         i += static_cast<int64_t>(gridDim.x) * THREADS) {
      out4[i < head ? i : tail0 + (i - head)] = zero4;
    }
  }

  // t indexes this launch's slab (starts, fwd_out, gout, the gradient
  // rows); the pixels come from the global supertile id t + st_offset
  const int st = (t + st_offset) % (sw * sh);
  const int sy = st / sw;
  const int sx = st % sw;
  const float px = static_cast<float>((sx * SS + j % SS) * TS + p0 % TS) + 0.5f;
  float py[2], g0[2], g1[2], g2[2], g3[2], godot[2], gAT[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = p0 + 16 * q;
    py[q] = static_cast<float>((sy * SS + j / SS) * TS + p / TS) + 0.5f;
    const float* fo = fwd_out + tile0 + j * OUT_CH * P + p;
    const float* go = gout + tile0 + j * OUT_CH * P + p;
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

  // The gate byte this thread builds: tile gj, slot gg, each tile up to its
  // own forward chunk count.
  const int gj = tid / G;
  const int gg = tid % G;
  const int gate_nch =
      static_cast<int>(fwd_out[tile0 + (gj * OUT_CH + CH_NCHUNKS) * P]);
  const float txf = static_cast<float>(sx * SS + gj % SS);
  const float tyf = static_cast<float>(sy * SS + gj / SS);

  // chunk k into buffer k & 1, 16 B a thread
  auto stage = [&](int k) {
    cp_async::copy16(s_chunk + (k & 1) * CHUNK4 + tid,
                     packed + static_cast<int64_t>(base0 + k * G) * (NF / 4) + tid);
    cp_async::commit();
  };
  // gate bytes of the staged chunk k, into gate buffer k & 1
  auto build_gate = [&](int k) {
    const float* row = reinterpret_cast<const float*>(s_chunk + (k & 1) * CHUNK4) + gg * NF;
    const int idx = base0 + k * G + gg;
    const float tsf = static_cast<float>(TS);
    const float x = row[COL_X], y = row[COL_Y];
    const float rx = row[COL_EXT_RX], ry = row[COL_EXT_RY];
    const bool in_y = (tyf >= floorf((y - ry) / tsf)) && (tyf < ceilf((y + ry) / tsf));
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
    s_gate[(k & 1) * NT * G + gj * G + gg] =
        (k < gate_nch) && (idx >= s0) && (idx < s1) && in_x && in_y;
  };

  if (nchunks > 0) {  // block-uniform
    stage(0);
    cp_async::wait_all();
    __syncthreads();
    build_gate(0);
  }
  float T[2] = {1.0f, 1.0f};   // transmittance before the chunk
  float gP[2] = {0.0f, 0.0f};  // sum of w * cg over the chunks before this one
  for (int k = 0; k < nchunks; ++k) {
    const int row0 = base0 + k * G;
    const float* s_rows = reinterpret_cast<const float*>(s_chunk + (k & 1) * CHUNK4);
    const unsigned char* gate = s_gate + (k & 1) * NT * G + j * G;
    // chunk k and its gates are in; chunk k - 1's buffer, gates and
    // partials are consumed
    __syncthreads();
    if (k + 1 < nchunks) stage(k + 1);

    float dconst[2], tin[2], pre[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dconst[q] = godot[q] - gP[q];
      tin[q] = 1.0f;  // product of (1 - alpha) over this chunk so far
      pre[q] = 0.0f;  // inclusive prefix of w * cg over this chunk
    }
    // This tile's gated slots as a bit mask: ungated slots are never
    // visited (the partials' sum reads them as 0).
    unsigned gmask[G / 32];
#pragma unroll
    for (int i = 0; i < G / 32; ++i) gmask[i] = __ballot_sync(bwd::FULL_MASK, gate[32 * i + lane]);
    // The sums of a live slot are reduced while the next live slot's
    // gradients are formed: `spend` holds the pending slot's per-thread
    // sums, `gpend` its slot (G when there is none: nothing is stored).
    float spend[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) spend[i] = 0.0f;
    int gpend = G;
#pragma unroll
    for (int i = 0; i < G / 32; ++i) {
      for (unsigned m = gmask[i]; m != 0; m &= m - 1) {
        const int g = 32 * i + __ffs(m) - 1;
        const float* row = s_rows + g * NF;
        float dx = row[COL_X] - px;
        if (wrap_x) dx = dx - width * rintf(dx * inv_width);
        const float ca = row[COL_CA], cb = row[COL_CB], cc = row[COL_CC];
        float dy[2], expneg[2], alpha_raw[2], alpha[2], one_m[2], T_i[2], w[2], cg[2];
        bool killed[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          dy[q] = row[COL_Y] - py[q];
          const float sigma = 0.5f * (ca * dx * dx + cc * dy[q] * dy[q]) + cb * dx * dy[q];
          expneg[q] = expf(-sigma);
          alpha_raw[q] = row[COL_OPAC] * expneg[q];
          killed[q] = (sigma < 0.0f) || (alpha_raw[q] < ALPHA_MIN);
          alpha[q] = killed[q] ? 0.0f : fminf(alpha_raw[q], ALPHA_MAX);
          one_m[q] = 1.0f - alpha[q];
          T_i[q] = tin[q] * T[q];
          w[q] = alpha[q] * T_i[q];
          cg[q] = row[COL_R] * g0[q];
          cg[q] = cg[q] + row[COL_G] * g1[q];
          cg[q] = cg[q] + row[COL_B] * g2[q];
          cg[q] = cg[q] + row[COL_DEPTH] * g3[q];
          pre[q] = pre[q] + w[q] * cg[q];
          tin[q] = tin[q] * one_m[q];
        }
        float* part = s_part + (g * VWARPS + vw) * NR;
        if (!__any_sync(bwd::FULL_MASK, (alpha[0] > 0.0f) || (alpha[1] > 0.0f))) {
          if ((lane & 15) < NR) part[lane & 15] = 0.0f;  // warp-uniform
          continue;
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
          if constexpr (ABS) {
            v[q][10] = fabsf(ddx);
            v[q][11] = fabsf(ddy);
          }
        }
        const float sum = bwd::half_warp_sum<NR>(spend, lane);
        if ((lane & 15) < NR && gpend < G) s_part[(gpend * VWARPS + vw) * NR + (lane & 15)] = sum;
#pragma unroll
        for (int r = 0; r < NR; ++r) spend[r] = v[0][r] + v[1][r];  // pixels l, l + 16
        gpend = g;
      }
    }
    const float sum = bwd::half_warp_sum<NR>(spend, lane);
    if ((lane & 15) < NR && gpend < G) s_part[(gpend * VWARPS + vw) * NR + (lane & 15)] = sum;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T[q] = T[q] * tin[q];
      gP[q] = gP[q] + pre[q];
    }
    cp_async::wait_all();
    __syncthreads();  // chunk k's partials and chunk k + 1's rows are in
    if (k + 1 < nchunks) build_gate(k + 1);

    const unsigned char* gates = s_gate + (k & 1) * NT * G;
    for (int i = tid; i < G * NF; i += THREADS) {
      const int g = i / NF;
      const int c = i % NF;
      float val = 0.0f;
      if (c < NR) {
        // the 32 warps in order; a tile's warps add 0 where it does not gate g
        const float* q = s_part + g * VWARPS * NR + c;
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          const bool on = gates[jj * G + g];
#pragma unroll
          for (int wi = jj * (P / 32); wi < (jj + 1) * (P / 32); ++wi) {
            const float x = on ? q[wi * NR] : 0.0f;
            val = (wi == 0) ? x : val + x;
          }
        }
      } else if (c == GCOL_KEY) {
        const int idx = row0 + g;
        val = (idx >= s0 && idx < s1) ? s_rows[g * NF + COL_GID] + 1.0f : 0.0f;
      }
      pgrad[static_cast<int64_t>(a0 + k * G + g) * NF + c] = val;
    }
  }
}

template <bool ABS>
int launch(const int* st_starts, const int* st_starts_al, const float* packed,
           const float* fwd_out, const float* gout, float* pgrad, int cs,
           int pad_cap, int sw, int sh, int tw, int st_offset, int wrap_x,
           float width, float inv_width, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<ABS ? 12 : 10>();
  cudaError_t err = cudaFuncSetAttribute(
      stream_bwd_kernel<ABS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_bwd_kernel<ABS><<<cs, THREADS, bytes, stream>>>(
      st_starts, st_starts_al, reinterpret_cast<const float4*>(packed), fwd_out,
      gout, pgrad, cs, pad_cap, sw, sh, tw, st_offset, wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stream_bwd(const int* st_starts, const int* st_starts_al,
                          const float* packed, const float* fwd_out,
                          const float* gout, float* pgrad, int cs,
                          int pad_cap, int sw, int sh, int tw, int st_offset,
                          int wrap_x, float width, float inv_width,
                          int absgrad, void* stream) {
  if (cs <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return absgrad ? launch<true>(st_starts, st_starts_al, packed, fwd_out, gout,
                                pgrad, cs, pad_cap, sw, sh, tw, st_offset, wrap_x,
                                width, inv_width, s)
                 : launch<false>(st_starts, st_starts_al, packed, fwd_out, gout,
                                 pgrad, cs, pad_cap, sw, sh, tw, st_offset, wrap_x,
                                 width, inv_width, s);
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
