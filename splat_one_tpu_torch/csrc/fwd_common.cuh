// The front-to-back compositing walk shared by the two forward kernels
// (stream_fwd.cu, tile_fwd.cu): one tile of 16 x 16 pixels walks a
// stream of G = 128-slot chunks of 64-byte slot rows, each pixel with its
// own running transmittance, until the stream ends or every pixel of the
// tile has T < 1e-5 at a chunk start.
//
// A tile is one block. Each thread carries PPT vertically adjacent
// pixels of one column, so a slot's dx (and its wrap) is formed once for
// them, and a warp covers a compact 16 x (2 PPT) block. Per chunk k:
//   1. each thread waits for its own cp.async copies of chunk k (the rows
//      g = tid, tid + THREADS, ...), tests them with the kernel's
//      predicate (the stream gate, or "may composite" for the tiled
//      kernel) and ballots the bits into the chunk's 128-bit mask;
//   2. one barrier, __syncthreads_or(T >= 1e-5): it publishes chunk k and
//      its mask, frees the buffer of chunk k - 1, and is the tile's
//      termination test;
//   3. chunk k + STAGES - 1 is copied into the freed buffer: a ring of
//      STAGES buffers keeps STAGES - 1 chunks in flight, so a walk over
//      empty chunks does not wait on memory;
//   4. each warp compacts the mask into its own list of slot indices,
//      leaving out the slots that provably composite none of its pixels
//      (misses_block), padded to a multiple of U with an all-zero row
//      (alpha = 0 leaves every bit unchanged), and walks the list U slots
//      at a time: first the U slots' alphas, which are independent, then
//      their serial sums, with no branch between them.
// A slot is composited exactly as the plain versions do it: alpha =
// min(opa * exp(-sigma), 0.999), 0 where sigma < 0 or alpha < 1/255,
// w = alpha * tin * T, acc += w * c, tin *= 1 - alpha, T *= tin after the
// chunk; with --fmad=false every operation rounds as in PyTorch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace fwd {

constexpr int G = 128;            // slots per chunk
constexpr int NF = 16;            // floats per slot row
constexpr int ROW4 = NF / 4;      // float4s per slot row
constexpr int TS = 16;            // tile size in pixels
constexpr int P = TS * TS;        // pixels per tile
constexpr int OUT_CH = 8;
constexpr int ZERO_ROW = G;       // the all-zero row after each staged chunk
constexpr int BUF4 = (G + 1) * ROW4;  // float4s per staging buffer
constexpr unsigned FULL_MASK = 0xffffffffu;

// Columns common to COL_* (ops/stream_isect.py) and ROW_* (ops/intersect.py)
constexpr int X = 0, Y = 1, CA = 2, CB = 3, CC = 4, OPAC = 5;

// The JAX package's Python-double constants rounded once to f32.
constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float ALPHA_MAX = static_cast<float>(0.999);

template <int PPT>
struct Shape {
  static_assert(PPT <= 8 && P % (PPT * 32) == 0, "whole warps per block");
  static constexpr int THREADS = P / PPT;
  static constexpr int WARPS = THREADS / 32;
};

template <int WARPS, int U, int STAGES>
struct Smem {
  float4 rows[STAGES][BUF4];          // the staged chunks and their zero rows
  unsigned mask[2][G / 32];           // each chunk's slots to walk
  unsigned char list[WARPS][G + U];   // each warp's compacted slot indices
};

// A thread's pixels: one column px, rows py[q], their transmittance before
// the current chunk and the r, g, b, depth sums.
template <int PPT>
struct Pixels {
  int p[PPT];  // pixel index inside the tile
  float px;
  float py[PPT];
  float T[PPT];
  float acc[PPT][4];
  float bx, by, hx, hy;  // the warp's pixel centres: [bx - hx, bx + hx] x [by - hy, by + hy]

  // pixels of thread g of a tile whose top-left pixel is (x0, y0): column
  // g % 16 of rows (g / 16) PPT ... (g / 16) PPT + PPT - 1
  __device__ __forceinline__ void init(int x0, int y0, int g) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      p[q] = ((g / TS) * PPT + q) * TS + g % TS;
      py[q] = static_cast<float>(y0 + p[q] / TS) + 0.5f;
      T[q] = 1.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
    }
    px = static_cast<float>(x0 + g % TS) + 0.5f;
    const int g0 = g - (g & 31);  // the warp's rows: r0 ... r1
    const int r0 = (g0 / TS) * PPT, r1 = ((g0 + 31) / TS) * PPT + PPT - 1;
    bx = static_cast<float>(x0) + 0.5f * TS;
    hx = 0.5f * (TS - 1);
    by = static_cast<float>(y0) + 0.5f * (r0 + r1 + 1);
    hy = 0.5f * (r1 - r0);
  }

  // some pixel has T >= term_thresh, or term_thresh <= 0 (never stop)
  __device__ __forceinline__ bool alive(float term_thresh) const {
    bool a = term_thresh <= 0.0f;
#pragma unroll
    for (int q = 0; q < PPT; ++q) a = a || (T[q] >= term_thresh);
    return a;
  }

  // out_tile: the tile's [OUT_CH, P] plane
  __device__ __forceinline__ void store(float* out_tile, int nch) const {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      float* o = out_tile + p[q];
      o[0 * P] = acc[q][0];
      o[1 * P] = acc[q][1];
      o[2 * P] = acc[q][2];
      o[3 * P] = 1.0f - T[q];
      o[4 * P] = acc[q][3];
      o[5 * P] = static_cast<float>(nch);
      o[6 * P] = 0.0f;
      o[7 * P] = 0.0f;
    }
  }
};

// Rows tid, tid + THREADS, ... of a chunk, 64 B each as four 16-byte copies.
template <int THREADS>
__device__ __forceinline__ void stage(float4* dst, const float4* src, int tid) {
  for (int g = tid; g < G; g += THREADS) {
#pragma unroll
    for (int c = 0; c < ROW4; ++c) cp_async::copy16(dst + g * ROW4 + c, src + g * ROW4 + c);
  }
}

// The chunk's mask from the rows this thread staged (once they have landed
// its own copies are visible to it): bit g is pred(row g, g).
template <int THREADS, class Pred>
__device__ __forceinline__ void mask_rows(const float4* rows, unsigned* mask, int tid,
                                          Pred pred) {
  for (int g = tid; g < G; g += THREADS) {  // warp-uniform
    const unsigned bits =
        __ballot_sync(FULL_MASK, pred(reinterpret_cast<const float*>(rows + g * ROW4), g));
    if ((tid & 31) == 0) mask[g / 32] = bits;
  }
}

// True where no pixel centre of the warp's block can composite the slot:
// where, for every pixel, the computed sigma exceeds ln(2 opa / ALPHA_MIN),
// so that alpha = opa exp(-sigma) < ALPHA_MIN / 2 even with expf's and
// the product's rounding. For a positive-definite conic with eigenvalues
// l1 <= l2, sigma >= 0.5 l1 (dx^2 + dy^2) exactly and the f32 sigma lies
// within 2^-20 l2 (dx^2 + dy^2) of it; |dx| >= Dx, the distance from the
// slot's centre to the block's columns (modular where WRAP), |dy| >= Dy.
// Each margin below is wider than the rounding it covers (the eigenvalue
// bound by 1e-5 l2 against ~5e-7 l2, the product by 1 %, the distance by
// 0.01 px, the log by 0.05); a NaN field never culls.
template <bool WRAP, int PPT>
__device__ __forceinline__ bool misses_block(const float* row, const Pixels<PPT>& pix,
                                             float width, float inv_width) {
  float dcx = row[X] - pix.bx;
  if constexpr (WRAP) dcx = dcx - width * rintf(dcx * inv_width);
  const float dx = fmaxf(fabsf(dcx) - pix.hx - 0.01f, 0.0f);
  const float dy = fmaxf(fabsf(row[Y] - pix.by) - pix.hy - 0.01f, 0.0f);
  const float a = row[CA], b = row[CB], c = row[CC];
  const float mid = 0.5f * (a + c);
  const float rad = sqrtf(0.25f * (a - c) * (a - c) + b * b);
  const float lo = 0.5f * (mid - rad) - 1e-5f * (mid + rad);  // <= 0.5 l1 - 2^-20 l2
  const float bound = 0.99f * lo * (dx * dx + dy * dy);
  return lo > 0.0f && bound > __logf(2.0f / ALPHA_MIN * row[OPAC]) + 0.05f;
}

// The mask's set slots that keep(g) passes, in order, into `list`, padded
// with ZERO_ROW to a multiple of U; returns the padded length.
template <int U, class Keep>
__device__ __forceinline__ int build_list(const unsigned (&m)[G / 32], unsigned char* list,
                                          int lane, Keep keep) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int i = 0; i < G / 32; ++i) {
    const int g = 32 * i + lane;
    const bool on = ((m[i] >> lane) & 1u) && keep(g);
    const unsigned bits = __ballot_sync(FULL_MASK, on);
    if (on) list[n + __popc(bits & below)] = static_cast<unsigned char>(g);
    n += __popc(bits);
  }
  const int padded = (n + U - 1) / U * U;
  if (n + lane < padded) list[n + lane] = ZERO_ROW;
  __syncwarp();
  return padded;
}

// Composite the listed rows into the thread's pixels, U slots at a time.
template <int PPT, int U, bool WRAP>
__device__ __forceinline__ void composite(const float4* rows, const unsigned char* list,
                                          int n, Pixels<PPT>& pix, float width,
                                          float inv_width) {
  float tin[PPT];  // product of (1 - alpha) over this chunk so far
#pragma unroll
  for (int q = 0; q < PPT; ++q) tin[q] = 1.0f;
  for (int j = 0; j < n; j += U) {
    float alpha[U][PPT];
    float4 color[U];  // r, g, b, depth
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4* row = rows + list[j + u] * ROW4;
      const float4 a = row[0];  // x, y, conic a, conic b
      const float4 b = row[1];  // conic c, opacity, r, g
      const float4 c = row[2];  // b, depth
      color[u] = make_float4(b.z, b.w, c.x, c.y);
      float dx = a.x - pix.px;
      if constexpr (WRAP) dx = dx - width * rintf(dx * inv_width);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float dy = a.y - pix.py[q];
        const float sigma = 0.5f * (a.z * dx * dx + b.x * dy * dy) + a.w * dx * dy;
        const float alpha_raw = b.y * expf(-sigma);
        alpha[u][q] = (sigma < 0.0f || alpha_raw < ALPHA_MIN) ? 0.0f
                                                               : fminf(alpha_raw, ALPHA_MAX);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
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
  for (int q = 0; q < PPT; ++q) pix.T[q] = pix.T[q] * tin[q];
}

// The slots of the 3D gaussians' rows (conic, opacity, colour, depth): a
// warp leaves out a slot that misses_block proves composites none of its
// pixels, and composites the rest by the conic's alpha. A kernel that walks
// other rows gives walk_tile its own with these two members; k is the
// chunk's index and g the row's within it.
struct ConicSlots {
  template <bool WRAP, int PPT>
  __device__ __forceinline__ bool misses(const float4* rows, int k, int g,
                                         const Pixels<PPT>& pix, float width,
                                         float inv_width) const {
    return misses_block<WRAP>(reinterpret_cast<const float*>(rows + g * ROW4), pix, width,
                              inv_width);
  }
  template <int PPT, int U, bool WRAP>
  __device__ __forceinline__ void composite(const float4* rows, const unsigned char* list,
                                            int n, Pixels<PPT>& pix, float width,
                                            float inv_width) const {
    fwd::composite<PPT, U, WRAP>(rows, list, n, pix, width, inv_width);
  }
};

// Walk the tile's `nchunks` chunks, chunk k being the G rows at
// src + k * G rows, and return how many it composited: every chunk it
// reached alive (COUNT_EMPTY) or only those whose mask is not empty.
// pred(row, slot) picks the slots to walk (slot = k * G + g); the tile
// stops before a chunk once no pixel is alive(term_thresh); `slots` culls
// and composites the walked rows (ConicSlots: 3D gaussians).
template <int PPT, int U, int STAGES, bool WRAP, bool COUNT_EMPTY, class Pred,
          class Slots = ConicSlots>
__device__ __forceinline__ int walk_tile(Smem<Shape<PPT>::WARPS, U, STAGES>& sm,
                                         const float4* src, int nchunks,
                                         Pixels<PPT>& pix, Pred pred, float width,
                                         float inv_width, float term_thresh,
                                         const Slots& slots = Slots()) {
  static_assert(STAGES >= 2, "a chunk in flight while one is walked");
  constexpr int THREADS = Shape<PPT>::THREADS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  unsigned char* list = sm.list[tid / 32];
  if (tid < STAGES * ROW4) {
    sm.rows[tid / ROW4][ZERO_ROW * ROW4 + tid % ROW4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // one commit group per chunk (empty past the stream's end), so that
  // "all but the STAGES - 2 newest groups" is chunk k
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) stage<THREADS>(sm.rows[s], src + static_cast<int64_t>(s) * G * ROW4, tid);
    cp_async::commit();
  }
  int nch = 0;
  for (int k = 0; k < nchunks; ++k) {
    const float4* rows = sm.rows[k % STAGES];
    cp_async::wait_pending<STAGES - 2>();
    mask_rows<THREADS>(rows, sm.mask[k & 1], tid,
                       [&](const float* row, int g) { return pred(row, k * G + g); });
    // chunk k and its mask are in; chunk k - 1's buffer is free
    const bool alive = __syncthreads_or(pix.alive(term_thresh));
    const int kn = k + STAGES - 1;
    if (kn < nchunks) {
      stage<THREADS>(sm.rows[kn % STAGES], src + static_cast<int64_t>(kn) * G * ROW4, tid);
    }
    cp_async::commit();
    if (!alive) break;  // block-uniform
    unsigned m[G / 32];
#pragma unroll
    for (int i = 0; i < G / 32; ++i) m[i] = sm.mask[k & 1][i];
    if (COUNT_EMPTY || (m[0] | m[1] | m[2] | m[3])) {
      const int n = build_list<U>(m, list, lane, [&](int g) {
        return !slots.template misses<WRAP>(rows, k, g, pix, width, inv_width);
      });
      slots.template composite<PPT, U, WRAP>(rows, list, n, pix, width, inv_width);
      nch = k + 1;
    }
  }
  cp_async::wait_all();  // copies started before the tile stopped
  return nch;
}

}  // namespace fwd
