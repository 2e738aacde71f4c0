// Fused correlation softmax + label propagation for Hopper (sm_90a).
//
// Replaces the TPU kernel `_corr_kernel`
// (unicorn_tpu/ops/pallas_correlation.py:24, called through
// `correlation_propagate_pallas` :72), which the SOT path runs once a frame.
//
// What it computes, for e0, e1 (B,N,C) and v (B,K,N), all float32:
//   out[b,k,j] = sum_i v[b,k,i] * softmax_i( e0[b,i,:] . e1[b,j,:] )
// without the N x N scores ever reaching device memory. With bf16_dots the
// embeddings are rounded to bf16 and a score is the fp32 sum of exact bf16
// products (tensor cores); without it the products are fp32 FMAs. Max, exp,
// denominator, the v * p sum and the output are fp32 in both settings.
//
// The TPU kernel's grid is (target blocks, source blocks) with the source
// axis sequential: the running max, denominator and numerator sit in VMEM
// scratch from one grid step to the next, and N is padded to the block
// sizes. On this card blocks run in no order and nothing carries between
// them, so one block owns BJ = 64 target columns and loops over the source
// tiles itself; nothing is padded: rows i >= N are masked to -1e30 and
// columns j >= N are not written.
//
// Bound on an H100 SXM at the served shape (N = 16000, C = 128, K = 1):
// 2*N*N*(C+K) = 66 GFLOP is 0.067 ms at 989 TFLOP/s in bf16 (0.99 ms at
// 67 TFLOP/s for the fp32 setting); the 16.5 MB of inputs and output are
// 0.005 ms at 3.35 TB/s. Operations bound it. Beside that bound, the
// N*N = 2.56e8 exponentials alone cost about as much again on the special
// function units. chip_smoke.py recomputes the bound from the shapes it runs.
//
// Design (simple and right first). A block of 256 threads keeps its e1 tile
// (64 x C) in shared memory for its whole life and streams e0 in tiles of
// BI = 128 rows (converted to bf16 as they are stored when bf16_dots). The
// 128 x 64 score tile is computed into shared memory: with nvcuda::wmma
// bf16 fragments and fp32 accumulators, each of the 8 warps taking 16 rows
// by 64 columns; or, for the fp32 setting, with plain FMAs on k-major tiles,
// each thread an 8 x 4 register tile. Then four threads per column each run
// an online softmax over their 32 rows of the tile, (max, denominator, K
// numerators) in registers; the four partial states of a column are merged
// once, after the last tile. Loads are not overlapped with compute, and the
// tensor cores go through wmma, not wgmma: both are for the change that
// makes this fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BJ = 64;                 // target columns per block
constexpr int BI = 128;                // source rows per tile
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / BJ;    // threads per column
constexpr int ROWS = BI / PARTS;       // rows of a tile per thread
constexpr int KMAX = 16;               // label maps per call
constexpr int SLD = BJ + 4;            // score tile row stride, floats
constexpr int EPAD = 8;                // bf16 tile row padding, elements
constexpr int TPAD = 4;                // k-major fp32 tile row padding
constexpr float NEG = -1e30f;
constexpr int MAX_SMEM = 232448;       // 227 KB, the most a block may ask for

__host__ __device__ inline size_t tile_bytes(bool bf16, int rows, int C) {
  return bf16 ? (size_t)rows * (C + EPAD) * 2 : (size_t)C * (rows + TPAD) * 4;
}

__host__ __device__ inline size_t smem_bytes(bool bf16, int C, int K) {
  return tile_bytes(bf16, BJ, C) + tile_bytes(bf16, BI, C) +
         (size_t)BI * SLD * 4 + (size_t)K * BI * 4;
}

// rows r0 .. r0+R of src (N, C) into a shared tile, zero beyond row N:
// bf16 row-major with stride C+EPAD, or fp32 k-major [c][r], stride R+TPAD
template <bool BF16, int R>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int r0,
                                          int N, int C, void* dst, int tid) {
  const int c4n = C / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < R * c4n; idx += THREADS) {
    if (BF16) {
      const int r = idx / c4n, c4 = idx % c4n;
      const float4 q = (r0 + r < N)
          ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * C) + c4)
          : zero;
      __nv_bfloat162 lo = __floats2bfloat162_rn(q.x, q.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(q.z, q.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dst) +
                                (size_t)r * (C + EPAD) + c4 * 4) = packed;
    } else {
      const int r = idx % R, c4 = idx / R;
      const float4 q = (r0 + r < N)
          ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * C) + c4)
          : zero;
      float* d = static_cast<float*>(dst) + (size_t)(c4 * 4) * (R + TPAD) + r;
      d[0] = q.x;
      d[R + TPAD] = q.y;
      d[2 * (R + TPAD)] = q.z;
      d[3 * (R + TPAD)] = q.w;
    }
  }
}

// grid: x = tiles of BJ target columns, y = batch
template <bool BF16, int KT>
__global__ void __launch_bounds__(THREADS)
corr_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
            const float* __restrict__ v, float* __restrict__ out, int N, int C,
            int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* e1s = smem;
  unsigned char* e0s = e1s + tile_bytes(BF16, BJ, C);
  float* S = reinterpret_cast<float*>(e0s + tile_bytes(BF16, BI, C));
  float* vs = S + BI * SLD;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  out += b * K * N;

  load_tile<BF16, BJ>(e1, j0, N, C, e1s, tid);

  const int col = tid % BJ;
  const int part = tid / BJ;
  float m_run = NEG, l_run = 0.f;
  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;

  for (int i0 = 0; i0 < N; i0 += BI) {
    __syncthreads();   // the tile before has been read to its end
    load_tile<BF16, BI>(e0, i0, N, C, e0s, tid);
    for (int idx = tid; idx < K * BI; idx += THREADS) {
      const int k = idx / BI, r = idx % BI;
      vs[idx] = (i0 + r < N) ? __ldg(v + (size_t)k * N + i0 + r) : 0.f;
    }
    __syncthreads();

    // scores S[i][j] = e0[i0+i] . e1[j0+j]
    if (BF16) {
      const int ld = C + EPAD;
      const __nv_bfloat16* a_base =
          reinterpret_cast<const __nv_bfloat16*>(e0s) + (size_t)(tid / 32) * 16 * ld;
      const __nv_bfloat16* b_base = reinterpret_cast<const __nv_bfloat16*>(e1s);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BJ / 16];
#pragma unroll
      for (int n = 0; n < BJ / 16; ++n) wmma::fill_fragment(c[n], 0.f);
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_base + k, ld);
#pragma unroll
        for (int n = 0; n < BJ / 16; ++n) {
          // B[k][j] = e1[j][k]: the row-major e1 tile read as column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, b_base + (size_t)n * 16 * ld + k, ld);
          wmma::mma_sync(c[n], a, bf, c[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BJ / 16; ++n)
        wmma::store_matrix_sync(S + (size_t)(tid / 32) * 16 * SLD + n * 16, c[n],
                                SLD, wmma::mem_row_major);
    } else {
      const int ti = tid / 16, tj = tid % 16;   // rows 8*ti.., columns 4*tj..
      const float* a_t = reinterpret_cast<const float*>(e0s) + 8 * ti;
      const float* b_t = reinterpret_cast<const float*>(e1s) + 4 * tj;
      float s[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_t + (size_t)c * (BI + TPAD));
        const float4 a1 = *reinterpret_cast<const float4*>(a_t + (size_t)c * (BI + TPAD) + 4);
        const float4 bq = *reinterpret_cast<const float4*>(b_t + (size_t)c * (BJ + TPAD));
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] = fmaf(a[r], bb[q], s[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(S + (size_t)(8 * ti + r) * SLD + 4 * tj) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

    // online softmax of this thread's ROWS rows of column col
    const float* sc = S + (size_t)part * ROWS * SLD + col;
    const int valid = N - i0 - part * ROWS;   // rows of mine that exist
    float tmax = NEG;
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r)
      tmax = fmaxf(tmax, r < valid ? sc[(size_t)r * SLD] : NEG);
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] *= alpha;
    const float* vp = vs + part * ROWS;
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) {
      const float p = expf((r < valid ? sc[(size_t)r * SLD] : NEG) - m_new);
      l_run += p;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (k < K) acc[k] = fmaf(vp[k * BI + r], p, acc[k]);
    }
    m_run = m_new;
  }

  // merge the PARTS partial states of each column (S is free now)
  __syncthreads();
  float* ms = S;
  float* ls = ms + THREADS;
  float* as = ls + THREADS;            // [k][part][col]
  ms[tid] = m_run;
  ls[tid] = l_run;
#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (k < K) as[k * THREADS + tid] = acc[k];
  __syncthreads();
  if (part == 0 && j0 + col < N) {
    float m = NEG;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) m = fmaxf(m, ms[p * BJ + col]);
    float scale[PARTS];
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      scale[p] = expf(ms[p * BJ + col] - m);
      l = fmaf(ls[p * BJ + col], scale[p], l);
    }
    for (int k = 0; k < K; ++k) {
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        a = fmaf(as[k * THREADS + p * BJ + col], scale[p], a);
      out[(size_t)k * N + j0 + col] = a / l;
    }
  }
}

template <bool BF16, int KT>
int launch(const float* e0, const float* e1, const float* v, float* out, int B,
           int N, int C, int K, cudaStream_t s) {
  const size_t smem = smem_bytes(BF16, C, K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      corr_kernel<BF16, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BJ - 1) / BJ, B);
  corr_kernel<BF16, KT><<<grid, THREADS, smem, s>>>(e0, e1, v, out, N, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. e0, e1 (B,N,C), v (B,K,N), out (B,K,N):
// contiguous float32, 16-byte aligned; any N >= 1; C a multiple of 16 whose
// tiles fit in shared memory (192 does for both settings); 1 <= K <= 16.
// bf16_dots: 1 = scores from bf16-rounded embeddings on the tensor cores,
// 0 = fp32 scores. Launches on `stream` and returns cudaGetLastError()
// (0 = ok).
extern "C" int correlation_forward(const void* e0, const void* e1,
                                   const void* v, void* out, int B, int N,
                                   int C, int K, int bf16_dots, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || C % 16 || K <= 0 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(e0);
  const float* b = static_cast<const float*>(e1);
  const float* c = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (bf16_dots)
    return K == 1 ? launch<true, 1>(a, b, c, o, B, N, C, K, s)
                  : launch<true, KMAX>(a, b, c, o, B, N, C, K, s);
  return K == 1 ? launch<false, 1>(a, b, c, o, B, N, C, K, s)
                : launch<false, KMAX>(a, b, c, o, B, N, C, K, s);
}

extern "C" const char* correlation_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
