// Segmented reduce-by-key of key-sorted gradient rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/seg_reduce.py `_kernel`
// (launched by `_segment_reduce_stacked`). Input: the backward's per-slot
// gradient rows [cap, 16] f32, stably sorted by their key (gaussian id + 1),
// and bounds [M0 + 1] int32, the start of each gaussian's run of rows.
// Output: out[c, m] = sum over the run of gaussian m of rows[b, c], for the
// n_payload leading columns (10, or 12 with absgrad), as [n_payload, M0].
//
// Design. The TPU kernel reduces blocks of 2048 gaussians with a one-hot
// matmul on the MXU because scatters are slow there. Here one thread owns
// one gaussian: it reads its run's rows (48 contiguous bytes each, as
// three 16-byte loads) and adds them front to back from 0, in sorted
// order, then writes its n_payload sums; neighbouring threads write
// neighbouring addresses of each output row. No atomics: the result does
// not depend on scheduling, and the plain PyTorch version reproduces it
// bit for bit.
//
// What bounds it on the H100. It does one add per payload value, so it is
// bound by bytes: the payload of the keyed rows read (rows the backward
// never wrote hold key 0 and lie outside every run), the bounds read and
// n_payload x M0 sums written, at 3.35 TB/s. Runs are short (a few
// supertiles per gaussian) and contiguous, so the loads of a warp fall on
// a few neighbouring cache lines. A gaussian with a very long run (one
// that covers many supertiles) keeps its warp waiting; splitting long runs
// is later work.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;
constexpr int THREADS = 256;

template <int NP>
__global__ void __launch_bounds__(THREADS)
seg_reduce_kernel(const float4* __restrict__ rows,  // [cap, NF / 4]
                  const int* __restrict__ bounds,   // [m0 + 1]
                  float* __restrict__ out,          // [NP, m0]
                  int m0) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= m0) return;
  const int b0 = bounds[m];
  const int b1 = bounds[m + 1];
  float acc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) acc[c] = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const float4* r = rows + static_cast<int64_t>(b) * (NF / 4);
    const float4 v0 = r[0], v1 = r[1], v2 = r[2];
    acc[0] = acc[0] + v0.x;
    acc[1] = acc[1] + v0.y;
    acc[2] = acc[2] + v0.z;
    acc[3] = acc[3] + v0.w;
    acc[4] = acc[4] + v1.x;
    acc[5] = acc[5] + v1.y;
    acc[6] = acc[6] + v1.z;
    acc[7] = acc[7] + v1.w;
    acc[8] = acc[8] + v2.x;
    acc[9] = acc[9] + v2.y;
    acc[10] = acc[10] + v2.z;
    acc[11] = acc[11] + v2.w;
  }
#pragma unroll
  for (int c = 0; c < NP; ++c) out[static_cast<int64_t>(c) * m0 + m] = acc[c];
}

}  // namespace

extern "C" int seg_reduce(const float* rows, const int* bounds, float* out,
                          int m0, int n_payload, void* stream) {
  if (m0 <= 0) return 0;
  const int blocks = (m0 + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r = reinterpret_cast<const float4*>(rows);
  switch (n_payload) {
    case 10:
      seg_reduce_kernel<10><<<blocks, THREADS, 0, s>>>(r, bounds, out, m0);
      break;
    case 12:
      seg_reduce_kernel<12><<<blocks, THREADS, 0, s>>>(r, bounds, out, m0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
