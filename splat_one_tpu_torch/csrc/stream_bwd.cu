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
// reduce key, gid + 1 on the supertile's own slots and 0 elsewhere. Rows of
// chunks no tile reached stay as the wrapper zeroed them.
//
// Design. One block per supertile, one thread per pixel (1024 threads,
// each warp inside one tile), as the forward kernel. The TPU kernel builds
// in-chunk prefixes with doubling networks over [G, 256] and sums over
// pixels with row reductions; here each pixel walks the chunk's slots in
// order with T and the prefix in registers. The crux is the per-slot sum
// over 1,024 pixels of 10 or 12 values. It is taken in a fixed order, with
// no atomics: a warp-shuffle butterfly over the 32 lanes (every lane ends
// with the same bits), one partial per (slot, warp, value) in shared memory
// (G x 32 x 12 floats, 192 KiB, dynamic shared memory), then, after the
// chunk, one thread per (slot, column) adds the 32 warps' partials in warp
// order. The plain PyTorch version repeats this order, so the two agree to
// the last bit wherever expf and the division round alike. A warp skips a
// slot its tile does not gate (warp-uniform) and the shuffles of a slot
// that no lane of it composites.
//
// What bounds it on the H100. Per evaluated (pixel, slot) pair the
// function needs about 55 f32 operations (exp as one) and, for the sums
// over pixels, one add per reduced value (10 or 12). It reads each slot
// row once (64 B) and fwd_out and gout once (2 x CS x 32 KiB) and writes
// pad_cap x 64 B, far below 3.35 TB/s for the time the arithmetic takes,
// so it is bound by operations: the pairs its data needs x ~65 f32
// operations at 67 TFLOP/s. The butterfly spends 5 shuffles and 5 adds per
// value and pair instead of one add, which that bound does not grant; in
// practice the shuffle rate sets the time. Not yet done (later work):
// reducing several values per shuffle, double-buffered chunk loads,
// splitting long supertile streams.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 128;           // slots per chunk
constexpr int NF = 16;           // floats per slot row (fields and gradients)
constexpr int TS = 16;           // tile size in pixels
constexpr int SS = 2;            // tiles per supertile side
constexpr int NT = SS * SS;      // tiles per supertile
constexpr int P = TS * TS;       // pixels per tile
constexpr int OUT_CH = 8;
constexpr int CH_NCHUNKS = 5;
constexpr int THREADS = NT * P;  // 1024
constexpr int WARPS = THREADS / 32;

// COL_* and GCOL_KEY of splat_one_tpu_torch/ops/stream_isect.py
constexpr int COL_X = 0, COL_Y = 1, COL_CA = 2, COL_CB = 3, COL_CC = 4;
constexpr int COL_OPAC = 5, COL_R = 6, COL_G = 7, COL_B = 8, COL_DEPTH = 9;
constexpr int COL_GID = 11, COL_EXT_RX = 12, COL_EXT_RY = 13;
constexpr int GCOL_KEY = 12;

constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);

template <int NR>
constexpr int smem_bytes() {
  return G * NF * 4 + G * WARPS * NR * 4 + NT * G;
}

template <bool ABS>
__global__ void __launch_bounds__(THREADS)
stream_bwd_kernel(const int* __restrict__ st_starts,
                  const int* __restrict__ st_starts_al,
                  const float4* __restrict__ packed,  // [rows, NF / 4]
                  const float* __restrict__ fwd_out,  // [CS, NT, OUT_CH, P]
                  const float* __restrict__ gout,     // [CS, NT, OUT_CH, P]
                  float* __restrict__ pgrad,          // [pad_cap, NF]
                  int sw, int sh, int tw, int wrap_x, float width,
                  float inv_width) {
  constexpr int NR = ABS ? 12 : 10;  // reduced gradient columns
  extern __shared__ float4 smem[];
  float4* s_chunk = smem;                                    // [G * NF / 4]
  float* s_part = reinterpret_cast<float*>(smem + G * NF / 4);  // [G][WARPS][NR]
  unsigned char* s_gate =
      reinterpret_cast<unsigned char*>(s_part + G * WARPS * NR);  // [NT][G]
  const float* s_rows = reinterpret_cast<const float*>(s_chunk);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid / P;  // this thread's tile
  const int p = tid % P;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int s0 = st_starts[t];
  const int s1 = st_starts[t + 1];
  const int base0 = (s0 / G) * G;
  const int a0 = st_starts_al[t];

  const int64_t tile0 = static_cast<int64_t>(t) * NT * OUT_CH * P;
  const float* fo = fwd_out + tile0 + j * OUT_CH * P + p;
  const float* go = gout + tile0 + j * OUT_CH * P + p;
  int nch_max = 0;
  for (int jj = 0; jj < NT; ++jj) {
    nch_max = max(nch_max,
                  static_cast<int>(fwd_out[tile0 + (jj * OUT_CH + CH_NCHUNKS) * P]));
  }
  const int nchunks = min((s1 - base0 + G - 1) / G, nch_max);
  // the tile whose gate this thread builds (threads < NT * G) and its count
  const int gj = min(tid / G, NT - 1);
  const int gate_nch =
      static_cast<int>(fwd_out[tile0 + (gj * OUT_CH + CH_NCHUNKS) * P]);

  const float g0 = go[0 * P], g1 = go[1 * P], g2 = go[2 * P];
  const float gA = go[3 * P], g3 = go[4 * P];
  float godot = g0 * fo[0 * P];
  godot = godot + g1 * fo[1 * P];
  godot = godot + g2 * fo[2 * P];
  godot = godot + g3 * fo[4 * P];
  const float gAT = gA * (1.0f - fo[3 * P]);  // gA * T_final

  const int st = t % (sw * sh);
  const int sy = st / sw;
  const int sx = st % sw;
  const float px = static_cast<float>((sx * SS + j % SS) * TS + p % TS) + 0.5f;
  const float py = static_cast<float>((sy * SS + j / SS) * TS + p / TS) + 0.5f;

  float T = 1.0f;   // transmittance before the chunk
  float gP = 0.0f;  // sum of w * cg over the chunks before this one
  for (int k = 0; k < nchunks; ++k) {
    const int row0 = base0 + k * G;
    __syncthreads();  // the previous chunk's rows and partials are consumed
    if (tid < G * NF / 4) {
      s_chunk[tid] = packed[static_cast<int64_t>(row0) * (NF / 4) + tid];
    }
    __syncthreads();
    if (tid < NT * G) {
      const int g = tid % G;
      const float* row = s_rows + g * NF;
      const int idx = row0 + g;
      const float tsf = static_cast<float>(TS);
      const float txf = static_cast<float>(sx * SS + gj % SS);
      const float tyf = static_cast<float>(sy * SS + gj / SS);
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
      s_gate[gj * G + g] =
          (k < gate_nch) && (idx >= s0) && (idx < s1) && in_x && in_y;
    }
    __syncthreads();

    const float dconst = godot - gP;
    float tin = 1.0f;  // product of (1 - alpha) over this chunk so far
    float pre = 0.0f;  // inclusive prefix of w * cg over this chunk
    for (int g = 0; g < G; ++g) {
      float* part = s_part + (g * WARPS + warp) * NR;
      if (!s_gate[j * G + g]) {  // warp-uniform
        if (lane < NR) part[lane] = 0.0f;
        continue;
      }
      const float* row = s_rows + g * NF;
      float dx = row[COL_X] - px;
      if (wrap_x) dx = dx - width * rintf(dx * inv_width);
      const float dy = row[COL_Y] - py;
      const float ca = row[COL_CA], cb = row[COL_CB], cc = row[COL_CC];
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float expneg = expf(-sigma);
      const float alpha_raw = row[COL_OPAC] * expneg;
      const bool killed = (sigma < 0.0f) || (alpha_raw < ALPHA_MIN);
      const float alpha = killed ? 0.0f : fminf(alpha_raw, ALPHA_MAX);
      const float one_m = 1.0f - alpha;
      const float T_i = tin * T;
      const float w = alpha * T_i;
      float cg = row[COL_R] * g0;
      cg = cg + row[COL_G] * g1;
      cg = cg + row[COL_B] * g2;
      cg = cg + row[COL_DEPTH] * g3;
      pre = pre + w * cg;
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
      if constexpr (ABS) {
        v[10] = fabsf(ddx);
        v[11] = fabsf(ddy);
      }
      tin = tin * one_m;
      if (__any_sync(0xffffffffu, alpha > 0.0f)) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[r] = v[r] + __shfl_xor_sync(0xffffffffu, v[r], off);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < NR; ++r) v[r] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (lane == r) part[r] = v[r];
      }
    }
    T = T * tin;
    gP = gP + pre;
    __syncthreads();

    for (int i = tid; i < G * NF; i += THREADS) {
      const int g = i / NF;
      const int c = i % NF;
      float val = 0.0f;
      if (c < NR) {
        const float* q = s_part + g * WARPS * NR + c;
        val = q[0];
        for (int wi = 1; wi < WARPS; ++wi) val = val + q[wi * NR];
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
           int sw, int sh, int tw, int wrap_x, float width, float inv_width,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<ABS ? 12 : 10>();
  cudaError_t err = cudaFuncSetAttribute(
      stream_bwd_kernel<ABS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_bwd_kernel<ABS><<<cs, THREADS, bytes, stream>>>(
      st_starts, st_starts_al, reinterpret_cast<const float4*>(packed), fwd_out,
      gout, pgrad, sw, sh, tw, wrap_x, width, inv_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stream_bwd(const int* st_starts, const int* st_starts_al,
                          const float* packed, const float* fwd_out,
                          const float* gout, float* pgrad, int cs, int sw,
                          int sh, int tw, int wrap_x, float width,
                          float inv_width, int absgrad, void* stream) {
  if (cs <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return absgrad ? launch<true>(st_starts, st_starts_al, packed, fwd_out, gout,
                                pgrad, cs, sw, sh, tw, wrap_x, width, inv_width, s)
                 : launch<false>(st_starts, st_starts_al, packed, fwd_out, gout,
                                 pgrad, cs, sw, sh, tw, wrap_x, width, inv_width, s);
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
