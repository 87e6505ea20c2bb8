// Device helpers shared by the backward compositing kernels (stream_bwd.cu,
// tile_bwd.cu): the exact division by 1 - alpha and the per-slot sum of
// the reduced values over a warp of the plain versions' tree. Chunks are
// staged with cp_async.cuh.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace bwd {

constexpr unsigned FULL_MASK = 0xffffffffu;

// a / b as IEEE f32 division rounds it, for a normal b > 0, without the
// division's slow-path branch (which splits the instruction stream and
// serialises the divisions): `inv` is 1/b to double precision (`recip`),
// the product a * inv is rounded once to f32. Its relative error, below
// 2^-51.9, is smaller than the least distance a quotient of two f32 values
// can have from an f32 rounding midpoint (2^-48 relative; down to the
// subnormal results, 2^-174 absolute against an error below 2^-177), and
// no such quotient is a midpoint, so both round to the same f32; zeros,
// infinities and NaNs pass through the product as through the division.
__device__ __forceinline__ double recip(float b) {
  const double bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
  y = fma(y, fma(-bd, y, 1.0), y);  // two Newton steps: 2^-20 -> 2^-53
  y = fma(y, fma(-bd, y, 1.0), y);
  return y;
}

__device__ __forceinline__ float div_rn(float a, double inv) {
  return __double2float_rn(static_cast<double>(a) * inv);
}

// One halving step of the reduce-scatter: the lane holds 2N values, keeps
// the half that bit `off` of its lane picks (the upper half if set), sends
// the other half to lane ^ off and adds the partner's copy of the kept half.
template <int N>
__device__ __forceinline__ void scatter_step(const float (&in)[2 * N],
                                             float (&out)[N], int off,
                                             bool up) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = up ? in[i + N] : in[i];
    const float send = up ? in[i] : in[i + N];
    out[i] = keep + __shfl_xor_sync(FULL_MASK, send, off);
  }
}

// The plain versions sum each of NR values over a warp of 32 pixels (32
// "lanes") by halving: lane l + 16 onto lane l, then + 8, + 4, + 2, + 1
// (ops/stream_raster.py `warp_sum`). The kernels give a thread two of
// those lanes, l = lane & 15 and l + 16, so the 16 threads of each half of
// the hardware warp carry one such warp, and the thread adds its two
// pixels' values itself: that is the first level, and `s` holds its sums.
// This takes the other four levels as a reduce-scatter over the 16
// threads (xor offsets 8, 4, 2, 1): at each a thread keeps half of the
// values it holds and swaps the other half with its partner, 8 + 4 + 2 + 1
// shuffles in all, after which thread lane holds the sum of value
// lane & 15 (returned; meaningless for lane & 15 >= NR). The pairings are
// the plain tree's and f32 addition commutes, so every sum has its bits.
// Where value i + 8 does not exist (i + 8 >= NR) the threads that would
// keep it store no sum, so there every thread keeps and sends value i and
// needs no selects.
template <int NR>
__device__ __forceinline__ float half_warp_sum(const float (&s)[NR], int lane) {
  static_assert(NR > 8 && NR <= 16, "8 < NR <= 16 values per lane");
  const bool up8 = lane & 8;
  float a[8];
#pragma unroll
  for (int i = 0; i < NR - 8; ++i) {
    const float keep = up8 ? s[i + 8] : s[i];
    const float send = up8 ? s[i] : s[i + 8];
    a[i] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
#pragma unroll
  for (int i = NR - 8; i < 8; ++i) {
    a[i] = s[i] + __shfl_xor_sync(FULL_MASK, s[i], 8);
  }
  float b[4], c[2], d[1];
  scatter_step<4>(a, b, 4, lane & 4);
  scatter_step<2>(b, c, 2, lane & 2);
  scatter_step<1>(c, d, 1, lane & 1);
  return d[0];
}

}  // namespace bwd
