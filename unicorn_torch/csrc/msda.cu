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
// Design. D is the contiguous axis of (B,L,H,W,M,D), so a head row of a
// cell is D/8 (bf16) or D/4 (fp32) 16-byte vectors, and a team of that
// many neighbouring lanes owns one (b, q, m): at D = 32 bf16 a warp is the 8
// heads of one query, and a block of 256 threads is 8 neighbouring queries
// (the served queries are the cells of both levels in raster order, so
// their samples share L1 lines). A block works in two phases:
//   1. one thread per (b, q, m, l, p) of the block loads the location and
//      attention weight and computes the four corner cells and weights
//      once, with the mode's roundings. A corner outside the map gets
//      weight 0 and a clamped cell, as the plain version's `corner_taps`
//      does (ops/deform_attn.py), so no load waits on a branch. Cells and
//      weights go to shared memory as one int4 and one float4 per point,
//      the block's queries contiguous (one row of points padded by one).
//   2. each lane reads its (q, m)'s corners (a broadcast within the team)
//      and issues the 8 corner loads of 2 points before their FMAs, in
//      the order (l, p, corner) of the plain version's sum.
// The split of the one-thread-per-vector design this replaces
// (csrc/variants.py msda) showed it losing more to its 4-8 times repeated
// weight arithmetic and the location loads in front of every corner than
// to the gather itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PB = 2;                    // points per batch of corner loads
constexpr int SMEM_MAX = 48 * 1024;      // phase 1's table, at most
constexpr int MODE_FACTORED = 0;
constexpr int MODE_DIRECT = 1;

// items: (b, q, m) per block; tpi: threads per item; istr = items + 1
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 4)
msda_kernel(const T* __restrict__ value, const float* __restrict__ locs,
            const void* __restrict__ attw, int attw_bf16, T* __restrict__ out,
            long long nitems, int L, int H, int W, int M, int D, int Lq,
            int P, int items, int tpi) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LP = L * P;
  const int istr = items + 1;
  int4* cells = reinterpret_cast<int4*>(smem);               // [LP][istr]
  float4* wts = reinterpret_cast<float4*>(smem) + LP * istr;  // [LP][istr]
  const long long g0 = (long long)blockIdx.x * items;
  const int nown = (int)min((long long)items, nitems - g0);
  const float fW = (float)W, fH = (float)H;

  // phase 1: the corners of each (item, l, p), once
  for (int e = threadIdx.x; e < nown * LP; e += blockDim.x) {
    const int it = e / LP;
    const int lp = e - it * LP;
    const int l = lp / P;
    const int slot = lp * istr + it;
    const long long t = (g0 + it) * LP + lp;
    const float aw = attw_bf16
        ? __bfloat162float(static_cast<const __nv_bfloat16*>(attw)[t])
        : static_cast<const float*>(attw)[t];
    const float2 loc = __ldg(reinterpret_cast<const float2*>(locs) + t);
    // separate roundings, as the plain version's multiply and subtract
    const float x = __fsub_rn(__fmul_rn(loc.x, fW), 0.5f);
    const float y = __fsub_rn(__fmul_rn(loc.y, fH), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    const float lx = __fsub_rn(x, x0), ly = __fsub_rn(y, y0);
    // float compares and clamps: a location far outside must not overflow
    const bool inx[2] = {x0 >= 0.f && x0 < fW, x0 + 1.f >= 0.f && x0 + 1.f < fW};
    const bool iny[2] = {y0 >= 0.f && y0 < fH, y0 + 1.f >= 0.f && y0 + 1.f < fH};
    int cx[2], cy[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      cx[d] = (int)fminf(fmaxf(x0 + d, 0.f), fW - 1.f);
      cy[d] = (int)fminf(fmaxf(y0 + d, 0.f), fH - 1.f);
    }
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
    const int r0 = (l * H + cy[0]) * W, r1 = (l * H + cy[1]) * W;
    cells[slot] = make_int4(r0 + cx[0], r0 + cx[1], r1 + cx[0], r1 + cx[1]);
    wts[slot] = make_float4(w[0][0], w[0][1], w[1][0], w[1][1]);
  }
  __syncthreads();

  // phase 2: tpi lanes per item, each one 16-byte channel vector at a time
  const int it = threadIdx.x / tpi;
  if (it >= nown) return;
  const long long gi = g0 + it;
  const int m = (int)(gi % M);
  const long long b = gi / M / Lq;
  const int dv = D / V;
  const long long cell = (long long)M * D;   // elements from one cell to the next
  const T* vb = value + b * L * H * W * cell + (long long)m * D;
  for (int v = threadIdx.x - it * tpi; v < dv; v += tpi) {
    const T* vv = vb + v * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int lp0 = 0; lp0 < LP; lp0 += PB) {
      uint4 q[PB][4];
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        if (lp0 + j < LP) {
          const int4 c = cells[(lp0 + j) * istr + it];
          q[j][0] = __ldg(reinterpret_cast<const uint4*>(vv + c.x * cell));
          q[j][1] = __ldg(reinterpret_cast<const uint4*>(vv + c.y * cell));
          q[j][2] = __ldg(reinterpret_cast<const uint4*>(vv + c.z * cell));
          q[j][3] = __ldg(reinterpret_cast<const uint4*>(vv + c.w * cell));
        }
      }
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        if (lp0 + j < LP) {
          const float4 wq = wts[(lp0 + j) * istr + it];
          const float wc[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float val[V];
            Vec<T>::unpack(q[j][n], val);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = fmaf(wc[n], val[k], acc[k]);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out + (gi * dv + v) * V) = Vec<T>::pack(acc);
  }
}

template <typename T>
int launch(const void* value, const float* locs, const void* attw,
           int attw_bf16, void* out, int B, int L, int H, int W, int M, int D,
           int Lq, int P, int mode, cudaStream_t s) {
  const long long nitems = (long long)B * Lq * M;
  const int dv = D / Vec<T>::N;
  const int tpi = dv < THREADS ? dv : THREADS;
  const int LP = L * P;
  // as many items as the threads hold, and phase 1's table fits
  int items = THREADS / tpi;
  const int fit = SMEM_MAX / (LP * 32) - 1;
  if (fit < items) items = fit;
  if (items <= 0 || (long long)B * L * H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (nitems + items - 1) / items;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)LP * (items + 1) * 32;
  const T* v = static_cast<const T*>(value);
  T* o = static_cast<T*>(out);
  if (mode == MODE_FACTORED)
    msda_kernel<T, MODE_FACTORED><<<(unsigned)blocks, items * tpi, smem, s>>>(
        v, locs, attw, attw_bf16, o, nitems, L, H, W, M, D, Lq, P, items,
        tpi);
  else
    msda_kernel<T, MODE_DIRECT><<<(unsigned)blocks, items * tpi, smem, s>>>(
        v, locs, attw, attw_bf16, o, nitems, L, H, W, M, D, Lq, P, items,
        tpi);
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
