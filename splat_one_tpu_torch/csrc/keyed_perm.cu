// Stable order of the backward's keyed gradient rows by key, for Hopper
// (sm_90a).
//
// Replaces the key sort in front of the TPU reduction:
// splat_one_tpu/ops/stream_isect.py `reduce_stream_grads` sorts every
// pad_cap row by its key (jax.lax.sort, :543) before the Pallas reduce.
// Input: the stream backward's rows [cap, 16] f32 with the key in column
// 12 (gaussian id + 1 on the rows the tiles reached, 0 elsewhere).
// Output: bounds [m0 + 1] int32, bounds[m] = the number of keyed rows with
// key <= m, and perm [>= bounds[m0]] int32, the keyed rows' indices
// ordered by key and, within a key, by row index: what a stable sort of
// the keys gives after its head of key-0 rows. Gaussian m's rows are then
// perm[bounds[m] .. bounds[m + 1]) in stream order, which is the order the
// segmented reduce (seg_reduce.cu) adds them in.
//
// Design. A counting sort, since the keys are dense in [1, m0] and only a
// seventh of the rows are keyed; no pass touches the unkeyed rows beyond
// their key:
//   1. count: a thread per row reads its key and, if keyed, adds one to
//      cnt[key - 1] and appends (row, key - 1) to a compact list (one
//      atomic per warp for the list's length);
//   2. scan: bounds = the exclusive prefix sum of cnt (block totals, one
//      block scanning the totals, then the blocks' own scans);
//   3. place: each listed row takes a ticket from its key's count
//      (atomicSub) and lands at bounds[key - 1] + ticket, so its key's run
//      holds the key's rows in the order the tickets were taken;
//   4. rank: each listed row counts the rows of its run with a smaller
//      index and moves to bounds[key - 1] + that count: the run in row
//      order, whatever the order of the tickets.
// So the output does not depend on scheduling and equals the plain
// version's stable sort bit for bit. Passes 3 and 4 run over the list's
// length on the card: nothing is read back by the host. A run of L rows
// costs its rows L reads each in pass 4; runs are a few supertiles long.
//
// What bounds it on the H100: bytes. The function must read the key column
// (4 B a row) and write bounds and the keyed rows' indices. The kernel
// reads a whole 32-byte sector for each row's key (the rows are 64 B wide)
// and moves the list, the counts and an unordered copy of perm besides.
//
// The launcher returns the first CUDA error of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;             // floats per gradient row
constexpr int KEY_COL = 12;        // GCOL_KEY of splat_one_tpu_torch/ops/stream_isect.py
constexpr int THREADS = 256;       // row and list kernels
constexpr int LIST_BLOCKS = 1056;  // list kernels: 132 SMs x 8 blocks
constexpr int SCAN_T = 1024;       // scan kernels: 32 warps
constexpr int SCAN_V = 4;          // values a scan thread
constexpr int SCAN_B = SCAN_T * SCAN_V;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
count_kernel(const float* __restrict__ rows, int cap, int m0,
             int* __restrict__ cnt, int* __restrict__ n_list, int2* __restrict__ list) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  int k = 0;
  if (p < cap) k = static_cast<int>(rows[static_cast<int64_t>(p) * NF + KEY_COL]);
  const bool keyed = k > 0 && k <= m0;
  if (keyed) atomicAdd(cnt + k - 1, 1);
  const unsigned mask = __ballot_sync(FULL, keyed);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n_list, __popc(mask));
  base = __shfl_sync(FULL, base, leader);
  if (keyed) list[base + __popc(mask & ((1u << lane) - 1u))] = make_int2(p, k - 1);
}

// Exclusive scan of one value a thread over a block of SCAN_T threads;
// *total gets the block's sum. Every thread of the block must call it.
__device__ int block_scan(int v, int* total) {
  __shared__ int s_warp[SCAN_T / 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    s_warp[lane] = s;
  }
  __syncthreads();
  *total = s_warp[SCAN_T / 32 - 1];
  const int r = (w ? s_warp[w - 1] : 0) + x - v;
  __syncthreads();  // s_warp is reused by the next call
  return r;
}

// this thread's SCAN_V values of a[base + SCAN_V t ...), 0 past n
__device__ void load_v(const int* a, int64_t base, int n, int v[SCAN_V]) {
#pragma unroll
  for (int i = 0; i < SCAN_V; ++i) {
    const int64_t j = base + SCAN_V * threadIdx.x + i;
    v[i] = j < n ? a[j] : 0;
  }
}

__global__ void __launch_bounds__(SCAN_T)
scan_totals_kernel(const int* __restrict__ cnt, int m0, int* __restrict__ tot) {
  int v[SCAN_V];
  load_v(cnt, static_cast<int64_t>(blockIdx.x) * SCAN_B, m0, v);
  int total;
  block_scan(v[0] + v[1] + v[2] + v[3], &total);
  if (threadIdx.x == 0) tot[blockIdx.x] = total;
}

// one block: tot[b] -> the sum of tot[0 .. b), for nb <= SCAN_B
__global__ void __launch_bounds__(SCAN_T)
scan_top_kernel(int* __restrict__ tot, int nb) {
  int v[SCAN_V];
  load_v(tot, 0, nb, v);
  int total;
  int run = block_scan(v[0] + v[1] + v[2] + v[3], &total);
#pragma unroll
  for (int i = 0; i < SCAN_V; ++i) {
    const int j = SCAN_V * threadIdx.x + i;
    if (j < nb) tot[j] = run;
    run += v[i];
  }
}

__global__ void __launch_bounds__(SCAN_T)
scan_write_kernel(const int* __restrict__ cnt, int m0, const int* __restrict__ tot,
                  int* __restrict__ bounds) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SCAN_B;
  int v[SCAN_V];
  load_v(cnt, base, m0, v);
  int total;
  int run = block_scan(v[0] + v[1] + v[2] + v[3], &total) + tot[blockIdx.x];
#pragma unroll
  for (int i = 0; i < SCAN_V; ++i) {
    const int64_t j = base + SCAN_V * threadIdx.x + i;
    run += v[i];
    if (j < m0) bounds[j + 1] = run;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) bounds[0] = 0;
}

__global__ void __launch_bounds__(THREADS)
place_kernel(const int2* __restrict__ list, const int* __restrict__ n_list,
             const int* __restrict__ bounds, int* __restrict__ cnt,
             int* __restrict__ perm_u) {
  const int n = *n_list;
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < n; j += gridDim.x * THREADS) {
    const int2 e = list[j];
    const int ticket = atomicSub(cnt + e.y, 1) - 1;
    perm_u[bounds[e.y] + ticket] = e.x;
  }
}

__global__ void __launch_bounds__(THREADS)
rank_kernel(const int2* __restrict__ list, const int* __restrict__ n_list,
            const int* __restrict__ bounds, const int* __restrict__ perm_u,
            int* __restrict__ perm) {
  const int n = *n_list;
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < n; j += gridDim.x * THREADS) {
    const int2 e = list[j];
    const int b0 = bounds[e.y];
    const int b1 = bounds[e.y + 1];
    int r = 0;
    for (int i = b0; i < b1; ++i) r += perm_u[i] < e.x;
    perm[b0 + r] = e.x;
  }
}

}  // namespace

// cnt_n: [m0 + 1] int32, zero on entry: the counts, then the list's length.
// tot: [ceil(m0 / 4096)] int32 scratch; list: [cap] int2 scratch; perm_u,
// perm: [cap] int32; bounds: [m0 + 1] int32.
extern "C" int keyed_perm(const float* rows, int cap, int m0, int* cnt_n,
                          int* tot, int* list, int* perm_u, int* perm, int* bounds,
                          void* stream) {
  if (m0 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (m0 + SCAN_B - 1) / SCAN_B;
  if (nb > SCAN_B) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* n_list = cnt_n + m0;
  int2* l2 = reinterpret_cast<int2*>(list);
  cudaError_t err;
  if (cap > 0) {
    count_kernel<<<(cap + THREADS - 1) / THREADS, THREADS, 0, s>>>(rows, cap, m0,
                                                                  cnt_n, n_list, l2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  scan_totals_kernel<<<nb, SCAN_T, 0, s>>>(cnt_n, m0, tot);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_top_kernel<<<1, SCAN_T, 0, s>>>(tot, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_write_kernel<<<nb, SCAN_T, 0, s>>>(cnt_n, m0, tot, bounds);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (cap > 0) {
    const int row_blocks = (cap + THREADS - 1) / THREADS;
    const int blocks = row_blocks < LIST_BLOCKS ? row_blocks : LIST_BLOCKS;
    place_kernel<<<blocks, THREADS, 0, s>>>(l2, n_list, bounds, cnt_n, perm_u);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rank_kernel<<<blocks, THREADS, 0, s>>>(l2, n_list, bounds, perm_u, perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
