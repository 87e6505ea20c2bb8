// Segmented broadcast (slot -> owning parent and its metadata) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/seg_broadcast.py `_kernel`
// (launched by `expand_parent_meta`). It computes the same function: the
// parents' slot runs [off[p], off[p + 1]) are contiguous and ascending, so
// the owners of a chunk of 1,024 consecutive slots lie in one window of
// `slab` parents starting at the 128-aligned base pbases[k] (chosen on the
// host, ops/seg_broadcast.py::coverage_windows). Each slot s takes the last
// window parent p with off[p] <= s; s is covered if p is a parent (p < MP;
// entry MP of the offsets is the total) and s < off[p + 1], and
// then gets that parent's sx0, sy0, span (at least 1), ka, offset, depth
// (f32 bits) and p itself. A slot the window does not cover, or one past
// the total, gets the zero row with span 1 and parent 0, as the TPU
// kernel's one-hot product gives. Output is planar [7, n] int32.
//
// Design. One block per chunk, one thread per slot (1,024 threads). The
// block stages the window's slab + 1 offsets in shared memory (12.3 KB at
// the default slab of 3,072) and each thread finds its parent by binary
// search over them (12 steps at 3,072). The TPU kernel builds a [1024,
// slab] compare mask and a one-hot bf16 matmul with byte- and split-
// encoded value columns to make the MXU's product exact; here the parent's
// row ([MP, 8] int32, 32 B) is read directly, so the values are exact by
// construction and no encoding is needed.
//
// What bounds it on the H100. Per chunk it reads slab + 1 offsets (4 B
// each) and the parent rows its slots own (neighbouring slots share rows),
// and writes 7 x 4 B per slot: bound by bytes. The binary search is ~12
// shared-memory reads per slot. Not yet done (later work): reading only the
// live window instead of a fixed slab, or fusing the caller's span decode.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 1024;  // slots per block
constexpr int NOUT = 7;   // output rows: sx0, sy0, span, ka, off, depth, parent

__global__ void __launch_bounds__(CH)
seg_broadcast_kernel(const int* __restrict__ pbases,
                     const int* __restrict__ offs_pad,  // [>= MP + slab + 1]
                     const int4* __restrict__ table,    // [MP, 2] (8 int32)
                     int* __restrict__ out,             // [NOUT, n]
                     int n, int mp, int slab) {
  extern __shared__ int s_off[];  // [slab + 1]
  const int k = blockIdx.x;
  const int base = pbases[k];
  for (int i = threadIdx.x; i <= slab; i += CH) s_off[i] = offs_pad[base + i];
  __syncthreads();

  const int s = k * CH + threadIdx.x;
  // number of window entries with off <= s (the offsets are non-decreasing)
  int lo = 0, hi = slab;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = lo - 1;
  const int p = base + i;
  int v[NOUT] = {0, 0, 1, 0, 0, 0, 0};
  // entry mp of the offsets is the total: past it there is no parent
  if (i >= 0 && p < mp && s < s_off[i + 1]) {
    const int4 a = table[2 * static_cast<int64_t>(p)];
    const int4 b = table[2 * static_cast<int64_t>(p) + 1];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = max(a.z, 1);
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = p;
  }
#pragma unroll
  for (int r = 0; r < NOUT; ++r) out[static_cast<int64_t>(r) * n + s] = v[r];
}

}  // namespace

extern "C" int seg_broadcast(const int* pbases, const int* offs_pad,
                             const int* table, int* out, int nb, int mp,
                             int slab, void* stream) {
  if (nb <= 0) return 0;
  const int bytes = (slab + 1) * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      seg_broadcast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_broadcast_kernel<<<nb, CH, bytes, static_cast<cudaStream_t>(stream)>>>(
      pbases, offs_pad, reinterpret_cast<const int4*>(table), out, nb * CH, mp,
      slab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
