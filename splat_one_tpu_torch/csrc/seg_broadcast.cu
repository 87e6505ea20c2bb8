// Segmented broadcast (slot -> owning parent -> the slot's sort key) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/seg_broadcast.py `_kernel`
// (launched by `expand_parent_meta`) and the decode that follows it in the
// stream builder (splat_one_tpu/ops/stream_isect.py, the slot -> supertile
// arithmetic before the sort). The parents' slot runs [off[p], off[p + 1])
// are contiguous and ascending, so the owners of a chunk of 1,024
// consecutive slots lie in one window of `slab` parents starting at the
// 128-aligned base pbases[k] (chosen on the host,
// ops/seg_broadcast.py::coverage_windows). Each slot s takes the last
// window parent p with off[p] <= s; s is covered if p is a parent (p < MP;
// entry MP of the offsets is the total) and s < off[p + 1]. A covered slot
// reads its parent's sx0, sy0, span (at least 1), ka and depth; a slot the
// window does not cover, or one past the total, takes the zero row (span 1,
// parent 0), as the TPU kernel's one-hot product gives it. Then, as the
// builder's decode: local = s - off + ka, the supertile (sx0 + local mod
// span, sy0 + local div span), x taken mod sw for a spherical camera, of
// camera q div n, where q is the slot's (camera, gaussian) pair: p, or
// p div 2 with `segmented` (the slab build's spherical parents, two
// unwrapped segments a pair, whose x is not taken mod sw); out: key[s] =
// ((supertile id - st_lo) << 32) | f32 bits of depth, id cs for slots at
// or past min(total, exp_cap) and for supertiles outside the slab
// [st_lo, st_lo + cs), and g[s] = q (int32). Without a slab st_lo is 0
// and cs the whole grid.
//
// Design. One block per chunk, 256 threads of four consecutive slots each.
// The block stages the window's slab + 1 offsets in shared memory (3.6 KB
// at the observed window of 896 parents, 12.3 KB at the default 3,072); a
// thread finds its first slot's parent by binary search over them and
// walks forward from it for the next three (a run holds ~2.4 slots), reads
// a parent's columns once for the slots it owns, and writes its four keys
// and owners as 32 and 16 contiguous bytes. Blocks of 256 threads, with no
// barrier after the window, let several chunks overlap on an SM. The TPU kernel
// builds a [1024, slab] compare mask and a one-hot bf16 matmul with byte-
// and split-encoded value columns to make the MXU's product exact; here
// the parent's columns are read where the builder made them (int64, f32),
// so the values are exact by construction, and the slot leaves the kernel
// as the 12 bytes the sort consumes instead of seven 4-byte columns.
//
// What bounds it on the H100: bytes. The function reads each parent's
// four int64 columns, its depth and its offset once, and writes 12 bytes a
// slot, at 3.35 TB/s. The kernel reads the window's offsets once per chunk
// and a parent's columns once per thread that owns one of its slots; the
// binary search is ~10 shared-memory reads a thread and the decode one
// integer division a slot.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 1024;            // slots per block
constexpr int SPT = 4;              // consecutive slots a thread
constexpr int THREADS = CH / SPT;   // 256

__global__ void __launch_bounds__(THREADS)
seg_broadcast_kernel(const int* __restrict__ pbases,
                     const int* __restrict__ offs_pad,   // [>= mp + slab + 1]
                     const int64_t* __restrict__ sx0,    // [mp]
                     const int64_t* __restrict__ sy0,    // [mp]
                     const int64_t* __restrict__ span,   // [mp]
                     const int64_t* __restrict__ ka,     // [mp]
                     const float* __restrict__ depth,    // [mp]
                     int64_t* __restrict__ key,          // [nb * CH]
                     int* __restrict__ g,                // [nb * CH]
                     int mp, int slab, int exp_cap, int n, int sw, int ns, int cs,
                     int st_lo, int wrap, int segmented) {
  extern __shared__ int s_off[];  // [slab + 1]
  const int k = blockIdx.x;
  const int base = pbases[k];
  for (int i = threadIdx.x; i <= slab; i += THREADS) s_off[i] = offs_pad[base + i];
  const int live = min(offs_pad[mp], exp_cap);
  __syncthreads();

  const int s0 = k * CH + SPT * threadIdx.x;
  // i: the last window entry with off <= s, found for s0 by binary search
  // (the offsets are non-decreasing), then walked forward slot by slot
  int lo = 0, hi = slab;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] <= s0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo - 1;
  int64_t kv[SPT];
  int gv[SPT];
  int cached = -1;  // the parent whose columns are in vx .. dbits
  int vx = 0, vy = 0, vspan = 1, vka = 0;
  unsigned dbits = 0u;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = s0 + j;
    while (i + 1 < slab && s_off[i + 1] <= s) ++i;
    const int p = base + i;
    // entry mp of the offsets is the total: past it there is no parent; a
    // slot the window does not cover takes the zero row (span 1, parent 0)
    const bool covered = i >= 0 && p < mp && s < s_off[i + 1];
    if (covered && p != cached) {
      vx = static_cast<int>(sx0[p]);
      vy = static_cast<int>(sy0[p]);
      vspan = max(static_cast<int>(span[p]), 1);
      vka = static_cast<int>(ka[p]);
      dbits = __float_as_uint(depth[p]);
      cached = p;
    }
    const int px = covered ? vx : 0, py = covered ? vy : 0, pspan = covered ? vspan : 1;
    const int pka = covered ? vka : 0;
    const int pp = covered ? (segmented ? p >> 1 : p) : 0;
    const int local = s - (covered ? s_off[i] : 0) + pka;
    int st_x = px + local % pspan;
    if (wrap && !segmented) st_x %= sw;
    const int st_y = py + local / pspan;
    int64_t st = static_cast<int64_t>(pp / n) * ns + static_cast<int64_t>(st_y) * sw + st_x -
                 st_lo;
    if (s >= live || st < 0 || st >= cs) st = cs;
    kv[j] = static_cast<int64_t>((static_cast<uint64_t>(st) << 32) | (covered ? dbits : 0u));
    gv[j] = pp;
  }
  longlong2* kout = reinterpret_cast<longlong2*>(key + s0);
  kout[0] = make_longlong2(kv[0], kv[1]);
  kout[1] = make_longlong2(kv[2], kv[3]);
  *reinterpret_cast<int4*>(g + s0) = make_int4(gv[0], gv[1], gv[2], gv[3]);
}

}  // namespace

extern "C" int seg_broadcast(const int* pbases, const int* offs_pad, const int64_t* sx0,
                             const int64_t* sy0, const int64_t* span, const int64_t* ka,
                             const float* depth, int64_t* key, int* g, int nb, int mp,
                             int slab, int exp_cap, int n, int sw, int ns, int cs, int st_lo,
                             int wrap, int segmented, void* stream) {
  if (nb <= 0) return 0;
  const int bytes = (slab + 1) * static_cast<int>(sizeof(int));
  if (bytes > 48 * 1024) {  // above the default limit of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        seg_broadcast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  seg_broadcast_kernel<<<nb, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      pbases, offs_pad, sx0, sy0, span, ka, depth, key, g, mp, slab, exp_cap, n, sw, ns,
      cs, st_lo, wrap, segmented);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
