// Multi-scale deformable attention sampling for Hopper (sm_90a): a gather.
//
// Replaces two TPU kernels of unicorn_tpu/ops/deform_attn.py, which the SOT
// path's deformable interaction runs once a frame:
//   `_msda_pallas_factored` (:294)  -> MODE_FACTORED (what "auto" serves)
//   `_msda_pallas`          (:204)  -> MODE_DIRECT   (method "pallas")
// The TPU cannot gather, so those kernels build a one-hot (H*W, queries)
// weight tile in VMEM and contract it with the value map on the MXU. None of
// that is carried over: this card gathers.
//
// What it computes, with T the value's dtype (float or bfloat16):
//   out[b,q,m,:] = round_T( sum_{l,p} sum_{4 corners}
//                           w(b,q,m,l,p,corner) * value[b,l,cy,cx,m,:] )
//   x = loc_x * W - 0.5, y = loc_y * H - 0.5, corners outside the map give 0
// (grid_sample: bilinear, zeros, align_corners=False). The sum is fp32. The
// two modes differ in where T rounds the corner weight:
//   factored: lx, ly rounded to T; per-axis weights (1 - frac, frac) in T,
//             zero outside; wy * attention weight in T; w = round_T(wy * wx)
//   direct:   w = round_T((x term * y term) * attention weight), fp32 inside
// One difference from the Pallas kernels stays: they round the SUM of the
// weights that land on one cell, a gather rounds each tap's weight. It shows
// only where two taps of one (query, head, level) hit the same cell, in bf16.
//
// Bound on an H100 SXM at the served shape (value (1,2,50,80,8,32) bf16,
// 8000 queries, 4 points): 4.1 MB of value, 4.1 MB of locations, 1.0 MB of
// weights and 4.1 MB of output, about 13 MB -> about 4 us at 3.35 TB/s;
// 66 M FMAs are about 2 us at 67 TFLOP/s. Bytes bound it, and at this size
// the launch and the dependent loads' latency are larger than either.
// chip_smoke.py recomputes the bound from the shapes it runs.
//
// Design (simple and right first). D is the contiguous axis of
// (B,L,H,W,M,D), so a thread owns one 16-byte vector of channels (8 bf16 or
// 4 fp32) of one (b, q, m): D/8 neighbouring threads read one 64-byte head
// row of a cell together, and the whole warp writes a contiguous run of the
// output. Each thread walks its L*P points, works out the four corner cells
// and weights, and accumulates in fp32; the value maps (4 MB) stay in L2.
// The threads of one (b, q, m) repeat the weight arithmetic, which is small
// beside the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MODE_FACTORED = 0;
constexpr int MODE_DIRECT = 1;

// one thread per (b, q, m, channel vector)
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
msda_kernel(const T* __restrict__ value, const float* __restrict__ locs,
            const void* __restrict__ attw, int attw_bf16, T* __restrict__ out,
            long long total, int L, int H, int W, int M, int D, int Lq,
            int P) {
  constexpr int V = Vec<T>::N;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int dv = D / V;
  const int v = (int)(idx % dv);
  const long long g = idx / dv;          // (b * Lq + q) * M + m
  const int m = (int)(g % M);
  const long long b = g / M / Lq;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;

  const float fW = (float)W, fH = (float)H;
  const long long cell = (long long)M * D;   // elements from one cell to the next
  for (int l = 0; l < L; ++l) {
    const T* vb = value + ((b * L + l) * H * W) * cell + (long long)m * D + v * V;
    for (int p = 0; p < P; ++p) {
      const long long t = (g * L + l) * P + p;
      const float aw = attw_bf16
          ? __bfloat162float(static_cast<const __nv_bfloat16*>(attw)[t])
          : static_cast<const float*>(attw)[t];
      const float2 loc = __ldg(reinterpret_cast<const float2*>(locs) + t);
      // separate roundings, as the plain version's multiply and subtract
      const float x = __fsub_rn(__fmul_rn(loc.x, fW), 0.5f);
      const float y = __fsub_rn(__fmul_rn(loc.y, fH), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float lx = __fsub_rn(x, x0), ly = __fsub_rn(y, y0);
      // float compares: a location far outside must not overflow an int
      const bool inx[2] = {x0 >= 0.f && x0 < fW, x0 + 1.f >= 0.f && x0 + 1.f < fW};
      const bool iny[2] = {y0 >= 0.f && y0 < fH, y0 + 1.f >= 0.f && y0 + 1.f < fH};
      if (!((inx[0] || inx[1]) && (iny[0] || iny[1]))) continue;
      const int ix = (int)x0, iy = (int)y0;   // in [-1, W-1] x [-1, H-1] here

      float w[2][2];
      if (MODE == MODE_FACTORED) {
        const float fx = Vec<T>::round(lx), fy = Vec<T>::round(ly);
        const float a = Vec<T>::round(aw);
        const float wx[2] = {inx[0] ? Vec<T>::round(__fsub_rn(1.f, fx)) : 0.f,
                             inx[1] ? fx : 0.f};
        const float wy[2] = {
            iny[0] ? Vec<T>::round(__fmul_rn(Vec<T>::round(__fsub_rn(1.f, fy)), a)) : 0.f,
            iny[1] ? Vec<T>::round(__fmul_rn(fy, a)) : 0.f};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            w[dy][dx] = Vec<T>::round(__fmul_rn(wy[dy], wx[dx]));
      } else {
        const float tx[2] = {__fsub_rn(1.f, lx), lx};
        const float ty[2] = {__fsub_rn(1.f, ly), ly};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            w[dy][dx] = (inx[dx] && iny[dy])
                ? Vec<T>::round(__fmul_rn(__fmul_rn(tx[dx], ty[dy]), aw))
                : 0.f;
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          if (!(inx[dx] && iny[dy])) continue;
          float val[V];
          Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(
                             vb + ((long long)(iy + dy) * W + (ix + dx)) * cell)),
                         val);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(w[dy][dx], val[k], acc[k]);
        }
    }
  }
  *reinterpret_cast<uint4*>(out + idx * V) = Vec<T>::pack(acc);
}

template <typename T>
int launch(const void* value, const float* locs, const void* attw,
           int attw_bf16, void* out, int B, int L, int H, int W, int M, int D,
           int Lq, int P, int mode, cudaStream_t s) {
  const long long total = (long long)B * Lq * M * (D / Vec<T>::N);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* v = static_cast<const T*>(value);
  T* o = static_cast<T*>(out);
  if (mode == MODE_FACTORED)
    msda_kernel<T, MODE_FACTORED><<<(unsigned)blocks, THREADS, 0, s>>>(
        v, locs, attw, attw_bf16, o, total, L, H, W, M, D, Lq, P);
  else
    msda_kernel<T, MODE_DIRECT><<<(unsigned)blocks, THREADS, 0, s>>>(
        v, locs, attw, attw_bf16, o, total, L, H, W, M, D, Lq, P);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. value (B,L,H,W,M,D) and out (B,Lq,M*D) of
// value_dtype (0 = float32, 1 = bfloat16), contiguous and 16-byte aligned,
// D a multiple of the vector width (4 fp32, 8 bf16); locs (B,Lq,M,L,P,2)
// float32; attw (B,Lq,M,L,P) of attw_dtype; mode 0 = factored, 1 = direct.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int msda_forward(const void* value, const void* locs,
                            const void* attw, void* out, int B, int L, int H,
                            int W, int M, int D, int Lq, int P,
                            int value_dtype, int attw_dtype, int mode,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || M <= 0 || D <= 0 || Lq <= 0 ||
      P <= 0 || (mode != MODE_FACTORED && mode != MODE_DIRECT) ||
      (attw_dtype != 0 && attw_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* lp = static_cast<const float*>(locs);
  if (value_dtype == 0 && D % Vec<float>::N == 0)
    return launch<float>(value, lp, attw, attw_dtype, out, B, L, H, W, M, D,
                         Lq, P, mode, s);
  if (value_dtype == 1 && D % Vec<__nv_bfloat16>::N == 0)
    return launch<__nv_bfloat16>(value, lp, attw, attw_dtype, out, B, L, H, W,
                                 M, D, Lq, P, mode, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* msda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
