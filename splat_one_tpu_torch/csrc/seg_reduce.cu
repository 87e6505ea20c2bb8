// Segmented reduce of gradient rows read through an index, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel splat_one_tpu/ops/seg_reduce.py `_kernel`
// (launched by `_segment_reduce_stacked`) together with the copy that the
// TPU path makes in front of it: there the rows are sorted by key into a
// new array (jax.lax.sort, splat_one_tpu/ops/stream_isect.py:543; the
// row gather by rank_perm, splat_one_tpu/ops/intersect.py:378), so that
// each gaussian's rows form one contiguous run. Here the rows stay where
// the backward wrote them. Input: the backward's per-slot gradient rows
// [cap, 16] f32, an int32 index perm, an int32 run table bounds [M0 + 1]
// (gaussian m's rows are perm[bounds[m]], ..., perm[bounds[m + 1] - 1])
// and an optional int32 output index out_index [M0] (the tiled path's
// rank_src). Output: out[c, j] = the sum over gaussian m's rows of
// rows[., c] for the n_payload leading columns (10, or 12 with absgrad),
// with j = out_index[m] (m without an index): planar [n_payload, M0]
// without an index, row-major [M0, 16] with one (columns n_payload.. hold
// sums of the rows' other columns, or 0). Each sum
// is taken front to back from 0 in the order of perm, so the result is
// deterministic, equals the plain PyTorch version bit for bit, and equals
// the sorted-copy composition it replaces.
//
// Design. The TPU kernel reduces blocks of 2048 gaussians with a one-hot
// matmul on the MXU because scatters are slow there; on this card the
// cost is the bytes and the latency of reaching them. A row's payload
// spans two 32-byte sectors (columns 0-7 and 8-15) and the rows of a run
// lie anywhere in the array. Each lane fetches the index entries of U rows
// of its run at once, then issues their row loads (16 bytes each, whole
// sectors, those past n_payload skipped) together, and only then adds
// them, in run order: no load waits for an add. U = 2 rows at a time,
// measured against 1 and 4 (reduce_anatomy.py). The two outputs get two
// lane shapes: with a planar output (the stream path, whose runs are its
// keyed rows, a few a gaussian and none for most) one lane a gaussian, so
// a thread holds few registers and many threads wait out the chain bounds
// -> index -> row at once; through an output index (the tiled path, ~4
// rows a gaussian) two lanes a gaussian, one per sector.
// Neighbouring gaussians sit on neighbouring lanes, so the bounds and
// index reads and each output plane's writes are coalesced. Through an
// output index the writes land at random: 4-byte writes scattered into
// n_payload planes each leave a partial 32-byte sector, and took 4.5x the
// time (reduce_anatomy.py), so each lane writes whole sectors of the
// gaussian's 64-byte output row instead. No atomics.
//
// What bounds it on the H100: bytes. The function reads the payload of
// each row in the runs, the index entries and the bounds (and the output
// index) once and writes n_payload x M0 sums, at 3.35 TB/s. The kernel
// moves more than that: a whole sector for each row's 40 or 48 payload
// bytes (64 B) and, with an output index, 64 B of output a gaussian. The
// tiled path's rows lie at random (a gaussian's slots are in several
// tiles), so its reads are random sectors too.
//
// The launcher returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;  // floats per gradient row
constexpr int THREADS = 256;
constexpr int U = 2;  // rows of a run in flight a lane
// Lanes a gaussian, for the two outputs: planar (the stream path: only
// keyed rows, a few a gaussian) and through an output index (the tiled
// path: every intersection, ~4 a gaussian).
constexpr int LANES_PLANAR = 1;
constexpr int LANES_INDEXED = 2;

// LANES lanes a gaussian; lane h covers columns [W h, W h + W), W = 16 /
// LANES, as Q = W / 4 16-byte loads of each row (those past n_payload
// skipped), U rows of the run at a time.
template <int NP, bool OUT_IDX, int LANES>
__global__ void __launch_bounds__(THREADS)
seg_reduce_kernel(const float4* __restrict__ rows,    // [cap, NF / 4]
                  const int* __restrict__ perm,       // [>= bounds[m0]]
                  const int* __restrict__ bounds,     // [m0 + 1]
                  const int* __restrict__ out_index,  // [m0] (OUT_IDX)
                  float* __restrict__ out,  // [NP, m0], or [m0, NF] (OUT_IDX)
                  int m0) {
  constexpr int W = NF / LANES;
  constexpr int Q = W / 4;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int m = t / LANES;
  const int h = t % LANES;
  if (m >= m0) return;
  const int dst = OUT_IDX ? out_index[m] : m;
  const int b0 = bounds[m];
  const int b1 = bounds[m + 1];
  float acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.0f;
  for (int b = b0; b < b1; b += U) {
    int p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] = b + u < b1 ? perm[b + u] : -1;
    float4 v[U][Q];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[u][q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p[u] >= 0 && W * h + 4 * q < NP) {
          v[u][q] = rows[static_cast<int64_t>(p[u]) * (NF / 4) + Q * h + q];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p[u] < 0) continue;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[4 * q] = acc[4 * q] + v[u][q].x;
        acc[4 * q + 1] = acc[4 * q + 1] + v[u][q].y;
        acc[4 * q + 2] = acc[4 * q + 2] + v[u][q].z;
        acc[4 * q + 3] = acc[4 * q + 3] + v[u][q].w;
      }
    }
  }
  if (OUT_IDX) {
    float4* o = reinterpret_cast<float4*>(out) + static_cast<int64_t>(dst) * (NF / 4) + Q * h;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (W * h + c < NP) out[static_cast<int64_t>(W * h + c) * m0 + dst] = acc[c];
    }
  }
}

template <int NP>
void launch(const float4* rows, const int* perm, const int* bounds,
            const int* out_index, float* out, int m0, cudaStream_t s) {
  if (out_index != nullptr) {
    const int blocks = static_cast<int>((1LL * LANES_INDEXED * m0 + THREADS - 1) / THREADS);
    seg_reduce_kernel<NP, true, LANES_INDEXED><<<blocks, THREADS, 0, s>>>(
        rows, perm, bounds, out_index, out, m0);
  } else {
    const int blocks = static_cast<int>((1LL * LANES_PLANAR * m0 + THREADS - 1) / THREADS);
    seg_reduce_kernel<NP, false, LANES_PLANAR><<<blocks, THREADS, 0, s>>>(
        rows, perm, bounds, nullptr, out, m0);
  }
}

}  // namespace

extern "C" int seg_reduce(const float* rows, const int* perm, const int* bounds,
                          const int* out_index, float* out, int m0, int n_payload,
                          void* stream) {
  if (m0 <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r = reinterpret_cast<const float4*>(rows);
  switch (n_payload) {
    case 10:
      launch<10>(r, perm, bounds, out_index, out, m0, s);
      break;
    case 12:
      launch<12>(r, perm, bounds, out_index, out, m0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
