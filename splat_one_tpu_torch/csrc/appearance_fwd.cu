// The viewer's appearance head in one pass over the rows, for Hopper
// (sm_90a): gsplat's colour sigmoid(colors + MLP([e, features, Y(d)])) for
// one camera, where e is the camera's image embedding and Y(d) the SH basis
// of the unit direction d from the camera centre to the row's mean.
//
// Replaces no TPU kernel: the JAX package evaluates the head in plain jnp
// (splat_one_tpu/train/appearance.py), and so does the port's plain version
// (splat_one_tpu_torch/train/appearance.py `appearance_rgb`), which training
// keeps for its autograd. Without this kernel a viewer request runs that
// plain version over every row: ~90 launches, each [N, 64] f32 activation
// written to device memory and read back.
//
// What bounds it on the H100: f32 FMAs. A row of gsplat's head (64 inputs,
// 64 -> 64 -> 64 -> 3) is ~7,400 FMAs against 164 bytes moved (features 128,
// mean 12, colour logits 12, colour 12).
//
// Design. A block of 128 threads takes a tile of 256 consecutive rows and
// walks the tiles in a grid-stride loop; it stages the head once (w0's
// feature and basis rows, the embedding's product with w0's first E rows
// folded into b0: the same sum in another order) in shared memory. Per
// tile, each thread fills two rows of the layer input, k-major ([k][row]):
// their features (8 16-byte loads a row in flight), the direction from the
// camera centre and its SH basis. Each linear layer is then a small matrix
// product in shared memory: a thread holds an 8-row by 16-column block of
// the tile's [256, 64] output in registers and, for each input k, reads 8
// activations and 16 weights as float4s, 128 FMAs for 6 loads. One row a
// thread would spend a shared or constant load on every FMA, which feeds
// at most a quarter to a half of the card's FMA rate (measured on an H100
// SXM at 700 W over 2^23 rows of gsplat's head: 5.5 ms with the weights in
// shared memory, 11.6 ms in constant memory, against 1.84 ms of FMAs);
// there 8 by 8 blocks took 3.49 ms, 8 by 16 3.29, and 8 loads in flight a
// row took the fill from 0.65 to 0.50 ms (3.15 in all). A warp holds 8 row groups by the 4 column groups: its
// activation reads are 128 contiguous bytes, its weight reads 64, its
// stores of a hidden layer (rows at a stride of 260 floats) meet no bank
// conflict. The hidden layer overwrites layer 0's input in place, after a
// barrier, so one activation buffer serves both and two blocks fit an SM.
// The last layer (64 -> 3) is the last hidden layer's epilogue: each
// thread's partial sums over its 16 columns, added across the 4 column
// groups by two steps of warp shuffles that also scatter the rows, so
// that lane c of a row group ends with rows 2c and 2c + 1 of its 8 and
// writes their colours. Nothing of [N, 64] leaves the SM.
//
// Arithmetic. Strict f32 on the CUDA cores (no TF32, no tensor cores): the
// direction, its norm (clamped at 1e-8), the basis (sh.eval_sh_bases'
// terms in their order, under the build's --fmad=false) and the sigmoid as
// the plain version rounds them; the layers' sums by explicit fmaf, bias
// first and the inputs in order (cuBLAS sums in its own order), so the
// colour differs from the plain version's by a few ulp.
//
// The launcher returns the CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 256;        // rows a tile
constexpr int T = 128;        // threads a block
constexpr int H = R / 2;      // the second row half of a thread's block
constexpr int W = 64;         // hidden width
constexpr int S = R + 4;      // floats a k-row of an activation buffer
constexpr int MAX_NB = 25;    // SH basis values, degree 4
constexpr int MAX_Q = 32;     // 16-byte words of the widest feature row (128 inputs)
constexpr unsigned FULL = 0xffffffffu;

// A Python float constant against a float32 tensor: the double, cast.
#define F32(x) static_cast<float>(x)

struct Params {
  const float* means;       // [N, 3]
  const float* feats;       // [N, F], F % 4 == 0, 16-byte aligned
  const float* logits;      // [N, 3]
  const float* centre;      // the camera centre, element stride cs
  const float* embeds;      // [n_images, E]
  const int64_t* image_id;  // the camera's image
  const float* w0;          // [E + F + NB, W]
  const float* b0;          // [W]
  const float* w1;          // [W, W] or null (two layers)
  const float* b1;          // [W] or null
  const float* wl;          // [W, 3]
  const float* bl;          // [3]
  float* out;               // [N, 3]
  int n, e, f, nb, cs;
  int k0;                   // f + nb: layer 0's inputs after the fold
  // the staged head (floats): b0 + e w0[:E] [W], w0[E:] [k0][W], b1 [W],
  // w1 [W][W], the last bias [4] and layer [W][4] (padded), the centre [4]
  int ow0, ob1, ow1, obl, owl, ocen, nw;
};

// The SH basis of degree sqrt(nb) - 1 at (x, y, z): sh.eval_sh_bases' terms.
__device__ __forceinline__ void sh_basis(int nb, float x, float y, float z,
                                         float (&b)[MAX_NB]) {
  b[0] = F32(0.28209479177387814);
  if (nb > 1) {
    b[1] = F32(-0.4886025119029199) * y;
    b[2] = F32(0.4886025119029199) * z;
    b[3] = F32(-0.4886025119029199) * x;
  }
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  if (nb > 4) {
    b[4] = F32(1.0925484305920792) * xy;
    b[5] = F32(-1.0925484305920792) * yz;
    b[6] = F32(0.31539156525252005) * ((2.0f * zz - xx) - yy);
    b[7] = F32(-1.0925484305920792) * xz;
    b[8] = F32(0.5462742152960396) * (xx - yy);
  }
  if (nb > 9) {
    b[9] = (F32(-0.5900435899266435) * y) * (3.0f * xx - yy);
    b[10] = (F32(2.890611442640554) * xy) * z;
    b[11] = (F32(-0.4570457994644658) * y) * ((4.0f * zz - xx) - yy);
    b[12] = (F32(0.3731763325901154) * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
    b[13] = (F32(-0.4570457994644658) * x) * ((4.0f * zz - xx) - yy);
    b[14] = (F32(1.445305721320277) * z) * (xx - yy);
    b[15] = (F32(-0.5900435899266435) * x) * (xx - 3.0f * yy);
  }
  if (nb > 16) {
    b[16] = (F32(2.5033429417967046) * xy) * (xx - yy);
    b[17] = (F32(-1.7701307697799304) * yz) * (3.0f * xx - yy);
    b[18] = (F32(0.9461746957575601) * xy) * (7.0f * zz - 1.0f);
    b[19] = (F32(-0.6690465435572892) * yz) * (7.0f * zz - 3.0f);
    b[20] = F32(0.10578554691520431) * (zz * (35.0f * zz - 30.0f) + 3.0f);
    b[21] = (F32(-0.6690465435572892) * xz) * (7.0f * zz - 3.0f);
    b[22] = (F32(0.47308734787878004) * (xx - yy)) * (7.0f * zz - 1.0f);
    b[23] = (F32(-1.7701307697799304) * xz) * (xx - 3.0f * yy);
    b[24] = F32(0.6258357354491761) * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
  }
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The head into shared memory, once a block.
__device__ void stage_head(const Params& p, float* sw) {
  const int t = threadIdx.x;
  const float* w0 = p.w0 + p.e * W;  // the feature rows, then the basis rows
  for (int i = t; i < p.k0 * W; i += T) sw[p.ow0 + i] = __ldg(w0 + i);
  if (p.w1 != nullptr) {
    for (int i = t; i < W * W; i += T) sw[p.ow1 + i] = __ldg(p.w1 + i);
    if (t < W) sw[p.ob1 + t] = __ldg(p.b1 + t);
  }
  for (int i = t; i < 4 * W; i += T)
    sw[p.owl + i] = i % 4 < 3 ? __ldg(p.wl + i / 4 * 3 + i % 4) : 0.0f;
  if (t < 4) {
    sw[p.obl + t] = t < 3 ? __ldg(p.bl + t) : 0.0f;
    sw[p.ocen + t] = t < 3 ? __ldg(p.centre + t * p.cs) : 0.0f;
  }
  if (t < W) {
    const float* emb = p.embeds + *p.image_id * p.e;
    float s = 0.0f;
    for (int k = 0; k < p.e; ++k) s = fmaf(__ldg(emb + k), __ldg(p.w0 + k * W + t), s);
    sw[t] = __ldg(p.b0 + t) + s;
  }
}

// Rows threadIdx.x + T h (h < RT) of the tile at r0 (nr live rows) into
// layer 0's input sx [k0][S]: features, then the SH basis of the
// direction; past the live rows zero features and mean (no colour is
// written there). Each thread keeps BQ 16-byte loads of each of its rows in
// flight (the launcher requires F % 4 == 0 and 16-byte aligned features).
// The loop over them is unrolled to the widest row, a bound the compiler
// knows: with the bound F / 4 the kernel took 226 registers and 3.23 ms at
// garden's 2^23 rows, against 210 and 3.08 (H100 SXM, 700 W).
__device__ void fill_input(const Params& p, const float* sw, float* sx, int r0, int nr) {
  constexpr int RT = R / T;  // rows a thread
  constexpr int BQ = 8;      // 16-byte loads a row in flight
  bool live[RT];
  const float* src[RT];
  float m[RT][3];
#pragma unroll
  for (int h = 0; h < RT; ++h) {
    const int row = threadIdx.x + h * T;
    live[h] = row < nr;
    const int64_t g = static_cast<int64_t>(r0) + (live[h] ? row : 0);
    src[h] = p.feats + g * p.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) m[h][c] = live[h] ? __ldg(p.means + 3 * g + c) : 0.0f;
  }
  const int nq = p.f / 4;
#pragma unroll
  for (int q0 = 0; q0 < MAX_Q; q0 += BQ) {
    if (q0 >= nq) break;
    float4 v[RT][BQ];
#pragma unroll
    for (int h = 0; h < RT; ++h)
#pragma unroll
      for (int u = 0; u < BQ; ++u)
        v[h][u] = live[h] && q0 + u < nq ? __ldg(reinterpret_cast<const float4*>(src[h]) + q0 + u)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < RT; ++h)
#pragma unroll
      for (int u = 0; u < BQ; ++u) {
        if (q0 + u >= nq) break;
        float* d = sx + 4 * (q0 + u) * S + threadIdx.x + h * T;
        d[0] = v[h][u].x;
        d[S] = v[h][u].y;
        d[2 * S] = v[h][u].z;
        d[3 * S] = v[h][u].w;
      }
  }
#pragma unroll
  for (int h = 0; h < RT; ++h) {
    const float dx = m[h][0] - sw[p.ocen], dy = m[h][1] - sw[p.ocen + 1];
    const float dz = m[h][2] - sw[p.ocen + 2];
    const float nrm = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
    const float den = nrm < F32(1e-8) ? F32(1e-8) : nrm;  // torch.clamp: NaN passes
    float b[MAX_NB];
    sh_basis(p.nb, dx / den, dy / den, dz / den, b);
#pragma unroll
    for (int k = 0; k < MAX_NB; ++k) {
      if (k >= p.nb) break;
      sx[(p.f + k) * S + threadIdx.x + h * T] = b[k];
    }
  }
}

// A thread's block of a layer's output: rows 4 rg + i and H + 4 rg + i
// (acc[i] and acc[4 + i], i < 4), columns 16 m + 4 cg + j (acc[.][4 m + j]).
__device__ __forceinline__ void layer(const float* sa, int K, const float* wk, const float* bias,
                                      int rg, int cg, float (&acc)[8][16]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 c = ld4(bias + 16 * m + 4 * cg);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][4 * m] = c.x;
      acc[i][4 * m + 1] = c.y;
      acc[i][4 * m + 2] = c.z;
      acc[i][4 * m + 3] = c.w;
    }
  }
  const float* pa = sa + 4 * rg;
  const float* pw = wk + 4 * cg;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 a0 = ld4(pa + k * S), a1 = ld4(pa + k * S + H);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float w[16];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v = ld4(pw + k * W + 16 * m);
      w[4 * m] = v.x;
      w[4 * m + 1] = v.y;
      w[4 * m + 2] = v.z;
      w[4 * m + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

__device__ __forceinline__ int col_of(int cg, int j) { return 16 * (j / 4) + 4 * cg + j % 4; }

// relu(acc) into the next layer's input dst [W][S].
__device__ __forceinline__ void store_hidden(float* dst, int rg, int cg,
                                             const float (&acc)[8][16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float* d = dst + col_of(cg, j) * S + 4 * rg;
    *reinterpret_cast<float4*>(d) =
        make_float4(relu(acc[0][j]), relu(acc[1][j]), relu(acc[2][j]), relu(acc[3][j]));
    *reinterpret_cast<float4*>(d + H) =
        make_float4(relu(acc[4][j]), relu(acc[5][j]), relu(acc[6][j]), relu(acc[7][j]));
  }
}

// The last layer on relu(acc) and the colour: partial sums over the
// thread's 16 columns, then reduced and scattered across the 4 column
// groups in two shuffle steps (lanes xor 2: rows 0-3 and 4-7 of the 8 part;
// xor 1: each half halved again), so that lane cg ends with the whole sums
// of rows 2 cg and 2 cg + 1 of its 8, and writes their colours.
__device__ __forceinline__ void finish(const Params& p, const float* sw, int rg, int cg,
                                       const float (&acc)[8][16], int r0, int nr) {
  float q[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i][0] = q[i][1] = q[i][2] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 v = ld4(sw + p.owl + 4 * col_of(cg, j));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float h = relu(acc[i][j]);
      q[i][0] = fmaf(h, v.x, q[i][0]);
      q[i][1] = fmaf(h, v.y, q[i][1]);
      q[i][2] = fmaf(h, v.z, q[i][2]);
    }
  }
  const bool hi2 = cg & 2, hi1 = cg & 1;
  float r[4][3], o[2][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r[i][c] = (hi2 ? q[4 + i][c] : q[i][c]) +
                __shfl_xor_sync(FULL, hi2 ? q[i][c] : q[4 + i][c], 2);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[i][c] = (hi1 ? r[2 + i][c] : r[i][c]) +
                __shfl_xor_sync(FULL, hi1 ? r[i][c] : r[2 + i][c], 1);
  const float4 bl = ld4(sw + p.obl);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 2 * cg + h;
    const int lr = i < 4 ? 4 * rg + i : H - 4 + 4 * rg + i;
    if (lr >= nr) continue;
    const int64_t g = static_cast<int64_t>(r0) + lr;
    p.out[3 * g] = sigmoid((o[h][0] + bl.x) + __ldg(p.logits + 3 * g));
    p.out[3 * g + 1] = sigmoid((o[h][1] + bl.y) + __ldg(p.logits + 3 * g + 1));
    p.out[3 * g + 2] = sigmoid((o[h][2] + bl.z) + __ldg(p.logits + 3 * g + 2));
  }
}

__global__ void __launch_bounds__(T, 2) appearance_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);     // the head
  float* sx = sw + p.nw;                           // [max(k0, W)][S]
  const int lane = threadIdx.x & 31;
  const int rg = (threadIdx.x >> 5) * 8 + (lane >> 2);  // row group, 0..31
  const int cg = lane & 3;                               // column group, 0..3
  const int tiles = (p.n + R - 1) / R;

  stage_head(p, sw);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * R;
    const int nr = min(R, p.n - r0);
    __syncthreads();  // the head staged; the previous tile's reads done
    fill_input(p, sw, sx, r0, nr);
    __syncthreads();
    float acc[8][16];
    layer(sx, p.k0, sw + p.ow0, sw, rg, cg, acc);
    if (p.w1 != nullptr) {
      __syncthreads();  // every read of layer 0's input done
      store_hidden(sx, rg, cg, acc);
      __syncthreads();
      layer(sx, W, sw + p.ow1, sw + p.ob1, rg, cg, acc);
    }
    finish(p, sw, rg, cg, acc, r0, nr);
  }
}

}  // namespace

extern "C" int appearance_fwd(const float* means, const float* feats, const float* logits,
                              const float* centre, int centre_stride, const float* embeds,
                              const int64_t* image_id, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* wl,
                              const float* bl, float* out, int n, int e, int f, int nb,
                              void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.means = means;
  p.feats = feats;
  p.logits = logits;
  p.centre = centre;
  p.embeds = embeds;
  p.image_id = image_id;
  p.w0 = w0;
  p.b0 = b0;
  p.w1 = w1;
  p.b1 = b1;
  p.wl = wl;
  p.bl = bl;
  p.out = out;
  p.n = n;
  p.e = e;
  p.f = f;
  p.nb = nb;
  p.cs = centre_stride;
  p.k0 = f + nb;
  p.ow0 = W;
  p.ob1 = p.ow0 + p.k0 * W;
  p.ow1 = p.ob1 + W;
  p.obl = w1 != nullptr ? p.ow1 + W * W : p.ob1;
  p.owl = p.obl + 4;
  p.ocen = p.owl + 4 * W;
  p.nw = p.ocen + 4;
  const int rows_k = p.k0 > W ? p.k0 : W;
  const int bytes = static_cast<int>(sizeof(float)) * (p.nw + rows_k * S);
  cudaError_t err = cudaFuncSetAttribute(appearance_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, appearance_kernel, T, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + R - 1) / R;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  appearance_kernel<<<grid, T, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* splat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
