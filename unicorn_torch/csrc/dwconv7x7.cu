// Depthwise 7x7 'SAME' convolution + bias, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dwconv7x7_pallas`
// (unicorn_tpu/ops/pallas_convnext.py:196, default variant dx_hoist), which
// every ConvNeXt block of the MOT path runs: 18 trunk blocks plus 3 head
// attention blocks on each of 3 levels, 27 launches per frame.
//
// What it computes, with T the compute dtype (float or bfloat16):
//   y[b,i,j,c] = round_T( bias[c] + sum_{dy,dx} x[b,i+dy-3,j+dx-3,c] * w[dy,dx,c] )
// Taps and bias arrive already rounded to T (the wrapper does it, as the TPU
// kernel does at pallas_convnext.py:221-222), out-of-range taps read zero,
// the sum is taken in fp32 and rounded once (round to nearest even).
//
// Bound on an H100 SXM, for one frame of the MOT path at 800x1280 (B=1,
// bf16, the seven shapes of unicorn_torch/ops/dwconv7x7.py PATH_SHAPES):
//   bytes: ~59.9 M elements read + written, ~240 MB -> ~72 us at 3.35 TB/s
//   operations: ~2.9 G fp32 FMAs -> ~88 us at 67 TFLOP/s (FMA = 2 flops)
// so the kernel is bound by fp32 FMA issue, by a small margin over bytes.
// chip_smoke.py recomputes both bounds per shape from the data it runs.
//
// Design (simple and right first). C is the contiguous axis, so a thread
// owns one 16-byte channel vector (8 bf16 or 4 fp32 channels). A block owns
// an output tile of TH rows x TW columns x CV channel vectors. It stages the
// tile plus its 3-pixel halo, (TH+6) x (TW+6) x CV vectors, and the 49 taps
// of its channels in shared memory, then each thread computes ROWS output
// rows of one column: for each of the 7 column offsets it holds that
// column's 7 taps in registers and streams the ROWS+6 input rows through
// them, accumulating in fp32. Neighbouring threads own neighbouring channel
// vectors, then neighbouring columns, so global loads and stores are
// contiguous runs of an NHWC row and shared-memory reads are conflict-free.
// The halo is re-read by the neighbouring tiles (about 2x the input bytes,
// mostly from L2); a pipelined, halo-sharing kernel is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int KS = 7;
constexpr int PAD = 3;
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int CV = 4;    // channel vectors per block
constexpr int ROWS = 4;  // output rows per thread
constexpr int THREADS = CV * TW * (TH / ROWS);  // 256
constexpr int SH = TH + KS - 1;
constexpr int SW = TW + KS - 1;

// grid: x = column tiles, y = batch * row tiles, z = channel-vector groups
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw7x7_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ taps,
                  const T* __restrict__ bias, T* __restrict__ y, int H, int W,
                  int C) {
  constexpr int V = Vec<T>::N;
  __shared__ uint4 tile[SH][SW][CV];
  __shared__ uint4 wts[KS * KS][CV];

  const int ncv = C / V;
  const int nrt = (H + TH - 1) / TH;
  const int b = blockIdx.y / nrt;
  const int y0 = (blockIdx.y % nrt) * TH;
  const int x0 = blockIdx.x * TW;
  const int cv0 = blockIdx.z * CV;
  const int tid = threadIdx.x;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < SH * SW * CV; i += THREADS) {
    const int cv = i % CV;
    const int p = i / CV;
    const int gx = x0 - PAD + p % SW;
    const int gy = y0 - PAD + p / SW;
    const int gcv = cv0 + cv;
    uint4 q = zero;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && gcv < ncv)
      q = __ldg(reinterpret_cast<const uint4*>(
          xb + ((size_t)gy * W + gx) * C + (size_t)gcv * V));
    tile[p / SW][p % SW][cv] = q;
  }
  for (int i = tid; i < KS * KS * CV; i += THREADS) {
    const int cv = i % CV;
    const int t = i / CV;
    const int gcv = cv0 + cv;
    wts[t][cv] = gcv < ncv ? __ldg(reinterpret_cast<const uint4*>(
                                 taps + (size_t)t * C + (size_t)gcv * V))
                           : zero;
  }
  __syncthreads();

  const int cv = tid % CV;
  const int col = (tid / CV) % TW;
  const int r0 = (tid / (CV * TW)) * ROWS;
  const int gcv = cv0 + cv;
  const int ox = x0 + col;
  if (gcv >= ncv || ox >= W) return;

  float acc[ROWS][V];
  {
    float bv[V];
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(bias + (size_t)gcv * V)),
                   bv);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[r][k] = bv[k];
  }

#pragma unroll
  for (int dx = 0; dx < KS; ++dx) {
    float w[KS][V];
#pragma unroll
    for (int dy = 0; dy < KS; ++dy) Vec<T>::unpack(wts[dy * KS + dx][cv], w[dy]);
#pragma unroll
    for (int i = 0; i < ROWS + KS - 1; ++i) {
      float v[V];
      Vec<T>::unpack(tile[r0 + i][col + dx][cv], v);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int dy = i - r;  // compile-time after unrolling
        if (dy >= 0 && dy < KS) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[r][k] = fmaf(v[k], w[dy][k], acc[r][k]);
        }
      }
    }
  }

  T* yb = y + (size_t)b * H * W * C + (size_t)gcv * V;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int oy = y0 + r0 + r;
    if (oy < H)
      *reinterpret_cast<uint4*>(yb + ((size_t)oy * W + ox) * C) =
          Vec<T>::pack(acc[r]);
  }
}

template <typename T>
int launch(const void* x, const void* taps, const void* bias, void* y, int B,
           int H, int W, int C, cudaStream_t s) {
  const int ncv = C / Vec<T>::N;
  const long long gy = (long long)B * ((H + TH - 1) / TH);
  const long long gz = (ncv + CV - 1) / CV;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (unsigned)gy, (unsigned)gz);
  dw7x7_nhwc_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps),
      static_cast<const T*>(bias), static_cast<T*>(y), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16.
// x, y: (B, H, W, C) contiguous; taps: (7, 7, C) contiguous; bias: (C,);
// all of dtype, 16-byte aligned, C a multiple of the vector width (4 fp32,
// 8 bf16). Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int dwconv7x7_nhwc(const void* x, const void* taps,
                              const void* bias, void* y, int B, int H, int W,
                              int C, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && C % Vec<float>::N == 0)
    return launch<float>(x, taps, bias, y, B, H, W, C, s);
  if (dtype == 1 && C % Vec<__nv_bfloat16>::N == 0)
    return launch<__nv_bfloat16>(x, taps, bias, y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dwconv7x7_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
