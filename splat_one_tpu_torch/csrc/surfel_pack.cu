// The build's pack for 2D gaussian surfels: the slot-major stream table
// [rows, 16] written from the surfel projection's [C, N, ...] outputs
// through the sorted slot order, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no surfel model. The plain
// version is splat_one_tpu_torch/ops/surfels.py `pack_surfels_plain` (the
// field table's `cat`, a row gather by `sorted_g` with sentinel slots
// gathering a zero row, and a chunk of zero rows for padding). A row is
// SURF_* of ops/surfels.py: mean2d (2), the ray transform T (9), opacity,
// colour (3), depth; the forward serves no backward, so the row holds no
// id and no extents (the forward's gate recomputes them from T).
//
// What bounds it: bytes. Every one of the `rows` rows is written once (64
// B) and its slot's index read once (4 B); a kept slot reads its
// surfel's 64 B of fields.
//
// Design: stream_pack.cu's. Four threads a row, each storing one 16-byte
// quarter, so a warp writes 8 whole rows, 512 contiguous bytes; each
// thread reads only its quarter's fields; a sentinel slot (index M0, past
// `exp_cap` or dropped) stores zeros and reads nothing more. The table is
// the plain version's bit for bit (it copies, it computes nothing).
//
// The launcher returns the CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 64 rows a block

struct Params {
  const int* sorted_g;     // [exp_cap] flat surfel of each slot, M0 = none
  const float* means2d;    // [M0, 2]
  const float* transforms; // [M0, 9]
  const float* opac;       // [M0]
  const float* colors;     // [M0, 3]
  const float* depths;     // [M0]
  float4* packed;          // [rows, 4] of float4
  int64_t quarters;        // 4 * rows
  int exp_cap, m0;
};

__global__ void __launch_bounds__(THREADS) surfel_pack_kernel(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= p.quarters) return;
  const int64_t row = i >> 2;
  const int q = static_cast<int>(i & 3);
  const int g = row < p.exp_cap ? __ldg(p.sorted_g + row) : p.m0;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g >= 0 && g < p.m0) {
    const float* t = p.transforms + 9 * static_cast<int64_t>(g);
    if (q == 0) {  // x, y, T[0], T[1]
      const float2 xy = __ldg(reinterpret_cast<const float2*>(p.means2d) + g);
      v = make_float4(xy.x, xy.y, __ldg(t), __ldg(t + 1));
    } else if (q == 1) {  // T[2..5]
      v = make_float4(__ldg(t + 2), __ldg(t + 3), __ldg(t + 4), __ldg(t + 5));
    } else if (q == 2) {  // T[6..8], opacity
      v = make_float4(__ldg(t + 6), __ldg(t + 7), __ldg(t + 8), __ldg(p.opac + g));
    } else {  // colour, depth
      const float* c = p.colors + 3 * static_cast<int64_t>(g);
      v = make_float4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(p.depths + g));
    }
  }
  p.packed[i] = v;
}

}  // namespace

extern "C" int surfel_pack(const int* sorted_g, const float* means2d, const float* transforms,
                           const float* opac, const float* colors, const float* depths,
                           float* packed, int exp_cap, int m0, int rows, void* stream) {
  if (rows <= 0) return 0;
  Params p;
  p.sorted_g = sorted_g;
  p.means2d = means2d;
  p.transforms = transforms;
  p.opac = opac;
  p.colors = colors;
  p.depths = depths;
  p.packed = reinterpret_cast<float4*>(packed);
  p.quarters = 4 * static_cast<int64_t>(rows);
  p.exp_cap = exp_cap;
  p.m0 = m0;
  const int64_t blocks = (p.quarters + THREADS - 1) / THREADS;
  surfel_pack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
