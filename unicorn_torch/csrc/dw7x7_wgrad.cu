// The filter and bias gradient of the depthwise 7x7 'SAME' convolution,
// NHWC, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the filter half of the JAX package's
// restructured dw7x7 backward, `dw_grads_restructured`
// (unicorn_tpu/ops/pallas_convnext.py:341, taken when `set_dw_custom_vjp`
// is on), which XLA computes as 49 shifted multiply-reduce taps, each fused
// into one pass over (x, dy). On this card the counterpart of that fusion
// is one kernel that reads x and dy once for all 49 taps.
//
// What it computes, x and dy (B, H, W, C) of T (float or bfloat16):
//   dW[u,v,c] = sum_{b,i,j} x[b, i+u-3, j+v-3, c] * dy[b, i, j, c]
//   db[c]     = sum_{b,i,j} dy[b, i, j, c]
// with x zero outside the map, every product and sum in fp32. The output is
// one fp32 array (50, C): rows 0..48 are dW in tap order (u, v), row 49 db.
//
// Bound on an H100 SXM: 49 FMAs (+ 1 add for db) per element of dy against
// one read each of x and dy: at 67 TFLOP/s fp32 and 3.35 TB/s the
// operations bound it in bf16 (99 flops per 4 bytes) and the bytes in fp32
// (per 8 bytes). chip_smoke.py computes both bounds per shape from the
// data it runs.
//
// Design. A block takes a slab of CS = 32 channels (a lane each), a tile
// of TW = 32 columns and a band of rows of one image; its 8 warps split
// the tile into column groups of NC = 4. A lane keeps the 49 + 1 sums of
// its channel in registers and walks down the band's input rows (the band
// and its 3 + 3 halo rows, clipped to the map): each row of x, TW + 6
// columns of the slab, is staged in shared memory as fp32 (two buffers, one
// barrier a row, the next row's loads in flight while this one is summed);
// the lane holds the 7 rows of dy that meet the current x row, NC columns
// each, in registers, shifted by one row a step, and reads NC + 6 values of
// the x row: 7 * 7 * NC = 196 FMAs per 10 shared loads. Every element of
// dy is read once (by the lane that owns it), every element of x once by
// each block whose band or halo holds it (from L2 for the halo).
//
// Determinism: no atomics. Each block sums its 8 warps in order through
// shared memory and writes its partial (50, CS) to a workspace slot of its
// own; a second kernel sums the slots for each (tap, channel) in one fixed
// order. The plan depends only on (B, H, W, C) and the card's SM count, so
// two calls on one card give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 7;
constexpr int PAD = 3;
constexpr int CS = 32;             // channels of a block, a lane each
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NC = 4;              // columns of a lane
constexpr int TW = WARPS * NC;     // columns of a block
constexpr int PW = TW + KS - 1;    // x columns of a staged row
constexpr int NT = KS * KS + 1;    // sums of a channel: 49 taps + bias
constexpr int STAGE = (PW * CS + THREADS - 1) / THREADS;  // loads a thread
constexpr int CHUNK = THREADS / CS;  // sums combined a pass (one a thread)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Plan {
  int ntiles, nslabs, nbands, rows, parts;
};

Plan make_plan(int B, int H, int W, int C, int n_sm) {
  Plan p;
  p.ntiles = (W + TW - 1) / TW;
  p.nslabs = (C + CS - 1) / CS;
  // enough bands for about four blocks an SM, at least 8 rows a band
  const int base = p.ntiles * p.nslabs * B;
  int nb = (4 * n_sm + base - 1) / base;
  const int most = (H + 7) / 8;
  nb = nb < 1 ? 1 : (nb > most ? most : nb);
  p.rows = (H + nb - 1) / nb;
  p.nbands = (H + p.rows - 1) / p.rows;   // no empty band
  p.parts = B * p.nbands * p.ntiles;
  return p;
}

// grid (ntiles, nslabs, B * nbands); ws: (parts, NT, C) fp32, the block's
// partial in slot (blockIdx.z * ntiles + blockIdx.x)
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
              float* __restrict__ ws, int H, int W, int C, int nbands,
              int rows) {
  __shared__ float xs[2][PW][CS];
  __shared__ float red[WARPS][CHUNK][CS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tj0 = blockIdx.x * TW;          // first column of the tile
  const int c0 = blockIdx.y * CS;
  const int b = blockIdx.z / nbands;
  const int i0 = (blockIdx.z % nbands) * rows;
  const int i1 = min(i0 + rows, H);
  const int c = c0 + lane;
  const bool c_ok = c < C;
  const size_t img = (size_t)b * H * W * C;
  const int j0 = tj0 + warp * NC;           // first column of the lane

  float acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0.f;

  // dy row i of this lane's NC columns; zero outside the band and the map
  auto load_dy = [&](int i, float (&v)[NC]) {
    const bool row_ok = c_ok && i >= i0 && i < i1;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int j = j0 + n;
      v[n] = (row_ok && j < W)
                 ? to_f(dy[img + ((size_t)i * W + j) * C + c]) : 0.f;
    }
  };
  // x row r of the tile's PW columns, this thread's STAGE elements
  auto fetch_x = [&](int r, float (&v)[STAGE]) {
    const bool row_ok = r >= 0 && r < H;
#pragma unroll
    for (int s = 0; s < STAGE; ++s) {
      const int e = threadIdx.x + s * THREADS;
      const int jj = e / CS, cc = e % CS;
      const int j = tj0 - PAD + jj;
      v[s] = (e < PW * CS && row_ok && j >= 0 && j < W && c0 + cc < C)
                 ? to_f(x[img + ((size_t)r * W + j) * C + c0 + cc]) : 0.f;
    }
  };
  auto store_x = [&](int buf, const float (&v)[STAGE]) {
#pragma unroll
    for (int s = 0; s < STAGE; ++s) {
      const int e = threadIdx.x + s * THREADS;
      if (e < PW * CS) xs[buf][e / CS][e % CS] = v[s];
    }
  };

  // the x rows that meet the band: [i0 - 3, i1 + 3) within the map
  const int rs = max(i0 - PAD, 0);
  const int re = min(i1 + PAD, H);
  // dyw[k] = dy row r - 3 + k at x row r, after the step's shift; before
  // the first shift dyw[k + 1] holds row rs - 3 + k and dnext row rs + 3
  float dyw[KS][NC], dnext[NC];
#pragma unroll
  for (int k = 0; k < KS - 1; ++k) {
    load_dy(rs - PAD + k, dyw[k + 1]);
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[NT - 1] += dyw[k + 1][n];
  }
  load_dy(rs + PAD, dnext);

  float stage[STAGE];
  if (rs < re) {
    fetch_x(rs, stage);
    store_x(0, stage);
  }
  __syncthreads();
  for (int r = rs; r < re; ++r) {
    const int buf = (r - rs) & 1;
    const bool more = r + 1 < re;
    if (more) fetch_x(r + 1, stage);      // in flight while this row sums
    // shift the dy window down a row and take in row r + 3
#pragma unroll
    for (int k = 0; k < KS - 1; ++k)
#pragma unroll
      for (int n = 0; n < NC; ++n) dyw[k][n] = dyw[k + 1][n];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dyw[KS - 1][n] = dnext[n];
      acc[NT - 1] += dnext[n];
    }
    load_dy(r + PAD + 1, dnext);
    float xr[NC + KS - 1];
#pragma unroll
    for (int m = 0; m < NC + KS - 1; ++m) xr[m] = xs[buf][warp * NC + m][lane];
    // x row r meets dy row r - 3 + k at tap row u = 6 - k
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int v = 0; v < KS; ++v)
#pragma unroll
        for (int n = 0; n < NC; ++n)
          acc[(KS - 1 - k) * KS + v] =
              fmaf(xr[n + v], dyw[k][n], acc[(KS - 1 - k) * KS + v]);
    if (more) store_x(buf ^ 1, stage);
    __syncthreads();
  }

  // the block's sums: the warps' in order, CHUNK sums a pass
  float* out = ws + (size_t)(blockIdx.z * gridDim.x + blockIdx.x) * NT * C;
  const int tt = threadIdx.x / CS, cc = threadIdx.x % CS;
#pragma unroll
  for (int q = 0; q < (NT + CHUNK - 1) / CHUNK; ++q) {
#pragma unroll
    for (int t = 0; t < CHUNK; ++t)
      if (q * CHUNK + t < NT) red[warp][t][lane] = acc[q * CHUNK + t];
    __syncthreads();
    const int tap = q * CHUNK + tt;
    if (tap < NT && c0 + cc < C) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][tt][cc];
      out[(size_t)tap * C + c0 + cc] = s;
    }
    __syncthreads();
  }
}

// out[o] = sum over the parts of ws[part][o], o < NT * C, in one fixed
// order: warp w sums the parts w, w + 8, ... (lane = output), then the
// warps' sums are added in order. grid ceil(NT * C / 32).
__global__ void __launch_bounds__(THREADS)
wgrad_reduce(const float* __restrict__ ws, float* __restrict__ out,
             int parts, int n_out) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (o < n_out)
    for (int p = warp; p < parts; p += WARPS) s += ws[(size_t)p * n_out + o];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && o < n_out) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    out[o] = t;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename T>
int launch(const void* x, const void* dy, float* ws, float* out, int B,
           int H, int W, int C, cudaStream_t s) {
  const Plan p = make_plan(B, H, W, C, sm_count());
  const dim3 grid(p.ntiles, p.nslabs, B * p.nbands);
  wgrad_partial<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, H, W, C,
      p.nbands, p.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = NT * C;
  wgrad_reduce<<<(n_out + 31) / 32, THREADS, 0, s>>>(ws, out, p.parts,
                                                      n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.
//
// dw7x7_wgrad_plan: out[0..4] = column tiles, channel slabs, bands an
// image, rows a band, workspace slots (the caller allocates slots * 50 * C
// floats). Returns 0, or an error for a bad shape.
extern "C" int dw7x7_wgrad_plan(int B, int H, int W, int C, int* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, sm_count());
  const int v[5] = {p.ntiles, p.nslabs, p.nbands, p.rows, p.parts};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// dw7x7_wgrad_nhwc: x, dy (B, H, W, C) contiguous of one dtype (0 =
// float32, 1 = bfloat16); ws the workspace of dw7x7_wgrad_plan; out (50,
// C) fp32: dW in tap order, then db. Two launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int dw7x7_wgrad_nhwc(const void* x, const void* dy, void* ws,
                                void* out, int B, int H, int W, int C,
                                int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(x, dy, w, o, B, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, w, o, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dw7x7_wgrad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
