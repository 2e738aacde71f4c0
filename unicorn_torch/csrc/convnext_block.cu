// One whole ConvNeXt block for Hopper (sm_90a), NHWC, forward only.
//
// Replaces the TPU kernel `convnext_block_pallas`
// (unicorn_tpu/ops/pallas_convnext.py:54, body :97-125), the fused
// alternative to the composed ConvNeXtBlock module.
//
// What it computes, with T the compute dtype (float or bfloat16), for x
// (B,H,W,C) and P = B*H*W pixels:
//   acc = b_dw + sum_{dy,dx} x[.., i+dy-3, j+dx-3, c] * k_dw[dy,dx,c]   fp32
//   mu  = mean_c(acc);  var = mean_c((acc - mu)^2)                      fp32
//   yn  = round_T( (acc - mu) * rsqrt(var + eps) * ln_s + ln_b )
//   h   = round_T( gelu( yn . W1^T + b1 ) )          (P, 4C), gelu in fp32
//   y   = round_T( x + (h . W2^T + b2) * gamma )     (P, C)
// The depthwise taps and bias, the LayerNorm scale and bias, b1, b2 and gamma
// enter in fp32, not rounded; W1 (4C, C) and W2 (C, 4C) arrive rounded to T
// (the wrapper does it), as the TPU kernel takes them. The 49-tap sum goes
// into LayerNorm unrounded. The variance is the two-pass form (the TPU body
// takes E[x^2] - mu^2; two passes cancel less). Both products accumulate in
// fp32: bf16 on the tensor cores (wmma m16n16k16), fp32 with plain FMAs.
//
// The TPU kernel keeps a row slab and both weight matrices in VMEM and pads
// C to 128 lanes. Here W1 and W2 (4.7 MB each at C = 768 in bf16) exceed a
// block's shared memory, so the block is four launches on one stream with
// the intermediates in device memory (mostly L2): (1) dw7x7 + bias -> acc
// fp32, (2) LayerNorm over C -> yn, (3) product 1 + b1 + GELU -> h,
// (4) product 2 + b2, x gamma, + residual -> y. Nothing is padded: C is any
// multiple of the 16-byte vector (8 bf16 / 4 fp32), ragged tiles are
// predicated.
//
// Bound on an H100 SXM: the two products are 16*P*C^2 operations, 9.4 GFLOP
// at each trunk stage of an 800x1280 frame, about 236 GFLOP for the 27
// blocks of one frame: 0.24 ms at 989 TFLOP/s in bf16. x in, y out and the
// weights once are 2*P*C + 8*C^2 elements. Operations bound every served
// shape. chip_smoke.py recomputes both sides per shape.
//
// Design (simple and right first).
//  (1) as csrc/dwconv7x7.cu: a thread owns one 16-byte channel vector of one
//      column and 4 rows, the block stages an 8x32 tile plus halo; taps are
//      fp32 in shared memory and the fp32 sums are stored as they are.
//  (2) one warp per pixel: mean, then centred sum of squares, then the
//      normalised row, each a pass over the C floats of the pixel (L1/L2),
//      reduced with xor-shuffles.
//  (3, 4) one routine: Y = epilogue(A (M,K) . Wt (N,K)^T). bf16: a block of
//      8 warps owns 128 x 128 outputs, stages 64-deep K chunks of A and Wt in
//      shared memory, each warp 32 x 64 as 2 x 4 wmma accumulators; the
//      epilogue takes each 16 x 16 accumulator through a per-warp shared
//      patch so that a lane holds 8 neighbouring columns of one row, adds the
//      bias, applies GELU or gamma + residual in fp32 and stores one 16-byte
//      vector. fp32: 128 x 64 outputs, k-major tiles, an 8 x 4 register tile
//      per thread. Loads are not overlapped with compute and the tensor cores
//      go through wmma, not wgmma: both are for the change that makes this
//      fast, as is fusing (3) and (4) so that h stays on the chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

using namespace nvcuda;

// ------------------------------------------------------------ (1) dw7x7
constexpr int KS = 7;
constexpr int PAD = 3;
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int CV = 4;    // channel vectors per block
constexpr int ROWS = 4;  // output rows per thread
constexpr int DW_THREADS = CV * TW * (TH / ROWS);  // 256
constexpr int SH = TH + KS - 1;
constexpr int SW = TW + KS - 1;

// grid: x = column tiles, y = batch * row tiles, z = channel-vector groups
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw7x7_sum_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                 const float* __restrict__ bias, float* __restrict__ acc_out,
                 int H, int W, int C) {
  constexpr int V = Vec<T>::N;
  __shared__ uint4 tile[SH][SW][CV];
  __shared__ __align__(16) float wts[KS * KS][CV * V];

  const int ncv = C / V;
  const int nrt = (H + TH - 1) / TH;
  const int b = blockIdx.y / nrt;
  const int y0 = (blockIdx.y % nrt) * TH;
  const int x0 = blockIdx.x * TW;
  const int cv0 = blockIdx.z * CV;
  const int tid = threadIdx.x;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const T* xb = x + (size_t)b * H * W * C;
  for (int i = tid; i < SH * SW * CV; i += DW_THREADS) {
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
  for (int i = tid; i < KS * KS * CV * V; i += DW_THREADS) {
    const int c = i % (CV * V);
    const int t = i / (CV * V);
    const int gc = cv0 * V + c;
    wts[t][c] = gc < C ? __ldg(taps + (size_t)t * C + gc) : 0.f;
  }
  __syncthreads();

  const int cv = tid % CV;
  const int col = (tid / CV) % TW;
  const int r0 = (tid / (CV * TW)) * ROWS;
  const int gcv = cv0 + cv;
  const int ox = x0 + col;
  if (gcv >= ncv || ox >= W) return;

  float acc[ROWS][V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float bv = __ldg(bias + (size_t)gcv * V + k);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r][k] = bv;
  }

#pragma unroll
  for (int dx = 0; dx < KS; ++dx) {
    float w[KS][V];
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int k = 0; k < V; ++k) w[dy][k] = wts[dy * KS + dx][cv * V + k];
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

  float* ob = acc_out + (size_t)b * H * W * C + (size_t)gcv * V;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int oy = y0 + r0 + r;
    if (oy < H) {
      float4* dst = reinterpret_cast<float4*>(ob + ((size_t)oy * W + ox) * C);
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        dst[k] = make_float4(acc[r][4 * k], acc[r][4 * k + 1],
                             acc[r][4 * k + 2], acc[r][4 * k + 3]);
    }
  }
}

// -------------------------------------------------------- (2) LayerNorm
constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp per pixel; grid x = ceil(P / LN_WARPS)
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ acc, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ yn,
                 long long P, int C, float eps) {
  constexpr int V = Vec<T>::N;
  const long long pix = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= P) return;
  const float4* row = reinterpret_cast<const float4*>(acc + (size_t)pix * C);
  const int n4 = C / 4;

  float s = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 q = row[i];
    s += (q.x + q.y) + (q.z + q.w);
  }
  const float mu = warp_sum(s) / (float)C;
  float ss = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 q = row[i];
    const float a = q.x - mu, b = q.y - mu, c = q.z - mu, d = q.w - mu;
    ss += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);

  const float4* sc = reinterpret_cast<const float4*>(scale);
  const float4* bi = reinterpret_cast<const float4*>(bias);
  T* out = yn + (size_t)pix * C;
  for (int i = lane; i < C / V; i += 32) {
    float v[V];
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 q = row[i * (V / 4) + k];
      const float4 g = __ldg(sc + i * (V / 4) + k);
      const float4 h = __ldg(bi + i * (V / 4) + k);
      v[4 * k] = (q.x - mu) * rstd * g.x + h.x;
      v[4 * k + 1] = (q.y - mu) * rstd * g.y + h.y;
      v[4 * k + 2] = (q.z - mu) * rstd * g.z + h.z;
      v[4 * k + 3] = (q.w - mu) * rstd * g.w + h.w;
    }
    *reinterpret_cast<uint4*>(out + (size_t)i * V) = Vec<T>::pack(v);
  }
}

// ------------------------------------------------- (3, 4) the two products
// EPI 0: round_T(gelu(acc + bias));  EPI 1: round_T(res + (acc + bias) * gamma)
template <bool EXACT>
__device__ __forceinline__ float gelu(float x) {
  if (EXACT) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

// v: Vec<T>::N neighbouring columns gn.. of output row gm, already summed
template <typename T, int EPI, bool EXACT>
__device__ __forceinline__ void epilogue(float (&v)[Vec<T>::N],
                                         const float* __restrict__ bias,
                                         const float* __restrict__ gamma,
                                         const T* __restrict__ res,
                                         T* __restrict__ Y, size_t gm, int gn,
                                         int N) {
  constexpr int V = Vec<T>::N;
  float r[V];
  if (EPI == 1)
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(res + gm * N + gn)), r);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float t = v[k] + __ldg(bias + gn + k);
    v[k] = EPI == 0 ? gelu<EXACT>(t) : r[k] + t * __ldg(gamma + gn + k);
  }
  *reinterpret_cast<uint4*>(Y + gm * N + gn) = Vec<T>::pack(v);
}

constexpr int G_THREADS = 256;
// bf16 tiles
constexpr int GM = 128, GN = 128, GK = 64, GLD = GK + 8;
constexpr int SLD = 20;   // row stride of a warp's 16 x 16 fp32 patch
// fp32 tiles
constexpr int FM = 128, FN = 64, FK = 16;

// grid: x = tiles of GM rows, y = tiles of GN columns
template <int EPI, bool EXACT>
__global__ void __launch_bounds__(G_THREADS)
product_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Wt,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ res,
                    __nv_bfloat16* __restrict__ Y, long long M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[GM][GLD];
  __shared__ __align__(128) __nv_bfloat16 Bs[GN][GLD];
  __shared__ __align__(128) float patch[G_THREADS / 32][16][SLD];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;   // 4 x 2 warps of 32 x 64 outputs
  const long long m0 = (long long)blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();   // the chunk before has been read to its end
    for (int idx = tid; idx < GM * (GK / 8); idx += G_THREADS) {
      const int r = idx / (GK / 8), kv = idx % (GK / 8);
      const int gk = k0 + kv * 8;
      uint4 q = zero;
      if (m0 + r < M && gk < K)
        q = __ldg(reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + gk));
      *reinterpret_cast<uint4*>(&As[r][kv * 8]) = q;
    }
    for (int idx = tid; idx < GN * (GK / 8); idx += G_THREADS) {
      const int r = idx / (GK / 8), kv = idx % (GK / 8);
      const int gk = k0 + kv * 8;
      uint4 q = zero;
      if (n0 + r < N && gk < K)
        q = __ldg(reinterpret_cast<const uint4*>(Wt + (size_t)(n0 + r) * K + gk));
      *reinterpret_cast<uint4*>(&Bs[r][kv * 8]) = q;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], GLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B[k][n] = Wt[n][k]: the row-major Wt tile read as column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, &Bs[wn * 64 + j * 16][kk], GLD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(c[i][j], a[i], bf, c[i][j]);
      }
    }
  }

  // a lane takes 8 neighbouring columns of one row of each 16 x 16 patch
  const int pr = lane / 2, pc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&patch[warp][0][0], c[i][j], SLD,
                              wmma::mem_row_major);
      __syncwarp();
      const long long gm = m0 + wm * 32 + i * 16 + pr;
      const int gn = n0 + wn * 64 + j * 16 + pc;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = patch[warp][pr][pc + k];
        epilogue<__nv_bfloat16, EPI, EXACT>(v, bias, gamma, res, Y, (size_t)gm,
                                            gn, N);
      }
      __syncwarp();
    }
}

// grid: x = tiles of FM rows, y = tiles of FN columns
template <int EPI, bool EXACT>
__global__ void __launch_bounds__(G_THREADS)
product_fp32_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const float* __restrict__ res, float* __restrict__ Y,
                    long long M, int N, int K) {
  __shared__ __align__(16) float As[FK][FM + 4];   // k-major
  __shared__ __align__(16) float Bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;   // rows 8*ti.., columns 4*tj..
  const long long m0 = (long long)blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float s[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[r][q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();
    for (int idx = tid; idx < FM * (FK / 4); idx += G_THREADS) {
      const int r = idx / (FK / 4), kv = idx % (FK / 4);
      const int gk = k0 + kv * 4;
      float4 q = zero;
      if (m0 + r < M && gk < K)
        q = __ldg(reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + gk));
      As[kv * 4][r] = q.x;
      As[kv * 4 + 1][r] = q.y;
      As[kv * 4 + 2][r] = q.z;
      As[kv * 4 + 3][r] = q.w;
    }
    for (int idx = tid; idx < FN * (FK / 4); idx += G_THREADS) {
      const int r = idx / (FK / 4), kv = idx % (FK / 4);
      const int gk = k0 + kv * 4;
      float4 q = zero;
      if (n0 + r < N && gk < K)
        q = __ldg(reinterpret_cast<const float4*>(Wt + (size_t)(n0 + r) * K + gk));
      Bs[kv * 4][r] = q.x;
      Bs[kv * 4 + 1][r] = q.y;
      Bs[kv * 4 + 2][r] = q.z;
      Bs[kv * 4 + 3][r] = q.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][8 * ti]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][8 * ti + 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[k][4 * tj]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = fmaf(a[r], bb[q], s[r][q]);
    }
  }

  const int gn = n0 + 4 * tj;
  if (gn >= N) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long gm = m0 + 8 * ti + r;
    if (gm < M)
      epilogue<float, EPI, EXACT>(s[r], bias, gamma, res, Y, (size_t)gm, gn, N);
  }
}

template <int EPI, bool EXACT>
int launch_product_bf16(const __nv_bfloat16* A, const __nv_bfloat16* Wt,
                        const float* bias, const float* gamma,
                        const __nv_bfloat16* res, __nv_bfloat16* Y, long long M,
                        int N, int K, cudaStream_t s) {
  const dim3 grid((unsigned)((M + GM - 1) / GM), (unsigned)((N + GN - 1) / GN));
  product_bf16_kernel<EPI, EXACT><<<grid, G_THREADS, 0, s>>>(A, Wt, bias, gamma,
                                                            res, Y, M, N, K);
  return (int)cudaGetLastError();
}

template <int EPI, bool EXACT>
int launch_product_fp32(const float* A, const float* Wt, const float* bias,
                        const float* gamma, const float* res, float* Y,
                        long long M, int N, int K, cudaStream_t s) {
  const dim3 grid((unsigned)((M + FM - 1) / FM), (unsigned)((N + FN - 1) / FN));
  product_fp32_kernel<EPI, EXACT><<<grid, G_THREADS, 0, s>>>(A, Wt, bias, gamma,
                                                            res, Y, M, N, K);
  return (int)cudaGetLastError();
}

// both products of one block: h = gelu(yn . W1^T + b1), y = x + (h . W2^T +
// b2) * gamma
template <bool EXACT>
int launch_products(int dtype, const void* yn, const void* w1, const float* b1,
                    const void* w2, const float* b2, const float* gamma,
                    const void* x, void* h, void* y, long long P, int C,
                    cudaStream_t s) {
  int err;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    err = launch_product_bf16<0, EXACT>(
        static_cast<const T*>(yn), static_cast<const T*>(w1), b1, nullptr,
        nullptr, static_cast<T*>(h), P, 4 * C, C, s);
    if (err) return err;
    return launch_product_bf16<1, EXACT>(
        static_cast<const T*>(h), static_cast<const T*>(w2), b2, gamma,
        static_cast<const T*>(x), static_cast<T*>(y), P, C, 4 * C, s);
  }
  err = launch_product_fp32<0, EXACT>(
      static_cast<const float*>(yn), static_cast<const float*>(w1), b1, nullptr,
      nullptr, static_cast<float*>(h), P, 4 * C, C, s);
  if (err) return err;
  return launch_product_fp32<1, EXACT>(
      static_cast<const float*>(h), static_cast<const float*>(w2), b2, gamma,
      static_cast<const float*>(x), static_cast<float*>(y), P, C, 4 * C, s);
}

template <typename T>
int launch_dw_ln(const void* x, const float* taps, const float* b_dw,
                 const float* ln_s, const float* ln_b, float* acc, void* yn,
                 int B, int H, int W, int C, float eps, cudaStream_t s) {
  const int ncv = C / Vec<T>::N;
  const long long gy = (long long)B * ((H + TH - 1) / TH);
  const long long gz = (ncv + CV - 1) / CV;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (unsigned)gy, (unsigned)gz);
  dw7x7_sum_kernel<T><<<grid, DW_THREADS, 0, s>>>(static_cast<const T*>(x), taps,
                                                  b_dw, acc, H, W, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long P = (long long)B * H * W;
  layernorm_kernel<T><<<(unsigned)((P + LN_WARPS - 1) / LN_WARPS), LN_THREADS,
                        0, s>>>(acc, ln_s, ln_b, static_cast<T*>(yn), P, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16 (T below).
// x, y (B,H,W,C) of T; taps (7,7,C), b_dw, ln_s, ln_b (C,), b1 (4C,), b2,
// gamma (C,) float32; w1 (4C,C), w2 (C,4C) of T; scratch acc (B,H,W,C)
// float32, yn (B,H,W,C) and h (B,H,W,4C) of T. All contiguous and 16-byte
// aligned, C a multiple of the vector width (4 fp32, 8 bf16). exact_gelu:
// 1 = erf, 0 = tanh. Launches four kernels on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 = ok).
extern "C" int convnext_block_forward(
    const void* x, const void* taps, const void* b_dw, const void* ln_s,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* gamma, void* acc, void* yn, void* h, void* y,
    int B, int H, int W, int C, int dtype, int exact_gelu, float eps,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (C % (dtype == 1 ? Vec<__nv_bfloat16>::N : Vec<float>::N))
    return (int)cudaErrorInvalidValue;
  const float* f_taps = static_cast<const float*>(taps);
  const float* f_bdw = static_cast<const float*>(b_dw);
  const float* f_lns = static_cast<const float*>(ln_s);
  const float* f_lnb = static_cast<const float*>(ln_b);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_gamma = static_cast<const float*>(gamma);
  float* f_acc = static_cast<float*>(acc);
  int err = dtype == 1
      ? launch_dw_ln<__nv_bfloat16>(x, f_taps, f_bdw, f_lns, f_lnb, f_acc, yn, B,
                                    H, W, C, eps, s)
      : launch_dw_ln<float>(x, f_taps, f_bdw, f_lns, f_lnb, f_acc, yn, B, H, W,
                            C, eps, s);
  if (err) return err;
  const long long P = (long long)B * H * W;
  return exact_gelu
      ? launch_products<true>(dtype, yn, w1, f_b1, w2, f_b2, f_gamma, x, h, y, P,
                              C, s)
      : launch_products<false>(dtype, yn, w1, f_b1, w2, f_b2, f_gamma, x, h, y,
                               P, C, s);
}

extern "C" const char* convnext_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
