// The build's pack: the slot-major stream table [rows, 16] written straight
// from the projection's [C, N, ...] outputs through the sorted slot order,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's pack
// (splat_one_tpu/ops/stream_isect.py `build_fields` + `pack_stream`) is a
// jnp concatenation and row gather that XLA fuses. The port's plain version
// (splat_one_tpu_torch/ops/stream_isect.py `build_field_columns` +
// `pack_stream`) runs ~25 launches: the [M0, 16] field table's elementwise
// extents and its `cat`s, a copy with a zero row appended, a 64-byte row
// gather over every slot (sentinel slots gather the zero row), and a
// second `cat` for the chunk of padding rows. This kernel writes the same
// table, bit for bit, in one pass.
//
// What bounds it on the H100: bytes. Every one of the `rows` rows is
// written once (64 B) and its slot's index read once (4 B); a kept slot
// reads its gaussian's fields (means2d 8, conic 12, opacity 4, colour 12,
// depth 4, radius 4: 44 B). At garden's size (3 x 2^23 slots, ~9.1M kept)
// that is 25.2M x 68 B + 9.1M x 44 B, ~2.1 GB, 0.63 ms at 3.35 TB/s; the
// plain version moves the field table and its copies several times over.
//
// Design. Four threads a row, each storing one 16-byte quarter, so a warp
// writes 8 whole rows, 512 contiguous bytes, in one coalesced store. A
// sentinel slot (index M0, past `exp_cap` or dropped) stores zeros and
// reads nothing more, so the design reads only the kept slots' fields. The
// four threads of a row read the same fields (one request a warp for the
// eight rows), and each selects its own columns, so no load sits in a
// divergent branch. The gathered reads are scattered: the slots run in
// supertile and depth order, not gaussian order.
//
// Arithmetic. The extents (COL_EXT_RX/RY) are `conic_ellipse_radii` with
// `opacity_extent`, operation by operation in PyTorch's order, under the
// build's --fmad=false: each Python float constant rounded to float as
// PyTorch rounds a scalar against a float32 tensor; `1.0 / det` is
// PyTorch's reciprocal; clamps propagate NaN as torch.clamp does. COL_GID
// is the float of the gaussian's index, rounded to nearest as
// torch.arange's float32 values are.
//
// The launcher returns the CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 64 rows a block

// A Python float constant against a float32 tensor: the double, cast.
#define F32(x) static_cast<float>(x)

struct Params {
  const int* sorted_g;  // [exp_cap] flat gaussian of each slot, M0 = none
  const float* means2d;  // [M0, 2]
  const float* conics;   // [M0, 3]
  const float* opac;     // [M0]
  const float* colors;   // [M0, 3]
  const float* depths;   // [M0]
  const float* radii;    // [M0]
  float4* packed;        // [rows, 4] of float4
  int64_t quarters;      // 4 * rows
  int exp_cap, m0;
};

// torch.clamp's NaN rule: a NaN input passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__global__ void __launch_bounds__(THREADS) stream_pack_kernel(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= p.quarters) return;
  const int64_t row = i >> 2;
  const int q = static_cast<int>(i & 3);
  const int g = row < p.exp_cap ? __ldg(p.sorted_g + row) : p.m0;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g >= 0 && g < p.m0) {
    const int64_t g2 = 2 * static_cast<int64_t>(g), g3 = 3 * static_cast<int64_t>(g);
    const float x = __ldg(p.means2d + g2), y = __ldg(p.means2d + g2 + 1);
    const float ca = __ldg(p.conics + g3), cb = __ldg(p.conics + g3 + 1);
    const float cc = __ldg(p.conics + g3 + 2);
    const float op = __ldg(p.opac + g);
    const float cr = __ldg(p.colors + g3), cg = __ldg(p.colors + g3 + 1);
    const float cbl = __ldg(p.colors + g3 + 2);
    const float depth = __ldg(p.depths + g), radius = __ldg(p.radii + g);
    // projection.conic_ellipse_radii(a, b, c, opacity_extent(opacity))
    const float det = clamp_min(ca * cc - cb * cb, F32(1e-30));
    const float inv = 1.0f / det;
    const float s2 = 2.0f * logf(clamp_min(op, F32(1e-12)) * F32(1.0 / (1.0 / 255.0)));
    const float s = clamp_max(sqrtf(clamp_min(s2, 0.0f)) + F32(1e-3), 3.0f);
    const float rx = s * sqrtf(clamp_min(cc * inv, 0.0f));
    const float ry = s * sqrtf(clamp_min(ca * inv, 0.0f));
    // selects, not branches: every load is used by every thread
    const bool q0 = q == 0, q1 = q == 1, q2 = q == 2;
    v.x = q0 ? x : q1 ? cc : q2 ? cbl : rx;
    v.y = q0 ? y : q1 ? op : q2 ? depth : ry;
    v.z = q0 ? ca : q1 ? cr : q2 ? radius : 0.0f;
    v.w = q0 ? cb : q1 ? cg : q2 ? static_cast<float>(g) : 0.0f;
  }
  p.packed[i] = v;
}

}  // namespace

extern "C" int stream_pack(const int* sorted_g, const float* means2d, const float* conics,
                           const float* opac, const float* colors, const float* depths,
                           const float* radii, float* packed, int exp_cap, int m0, int rows,
                           void* stream) {
  if (rows <= 0) return 0;
  Params p;
  p.sorted_g = sorted_g;
  p.means2d = means2d;
  p.conics = conics;
  p.opac = opac;
  p.colors = colors;
  p.depths = depths;
  p.radii = radii;
  p.packed = reinterpret_cast<float4*>(packed);
  p.quarters = 4 * static_cast<int64_t>(rows);
  p.exp_cap = exp_cap;
  p.m0 = m0;
  const int64_t blocks = (p.quarters + THREADS - 1) / THREADS;
  stream_pack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
