// The depthwise 7x7 'SAME' strip kernel, NHWC, for Hopper (sm_90a): the
// design that csrc/dwconv7x7.cu describes, shared by dwconv7x7.cu (taps,
// bias and output in the compute dtype T) and convnext_block.cu (fp32 taps
// and bias, the fp32 sum stored unrounded).
//
// dw7x7::launch<T, TW, TO>: x (B,H,W,C) of T, taps (7,7,C) and bias (C,) of
// TW, y (B,H,W,C) of TO. Taps and bias are converted to fp32 once, into
// registers; the sum is fp32 and is rounded once to TO (not at all for a
// float TO). dw7x7::plan picks the tiling from (B, H, W, C) and the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {
namespace dw7x7 {

constexpr int KS = 7;
constexpr int PAD = 3;
constexpr int NC = 2;          // output columns per lane
constexpr int THREADS = 128;
constexpr int GROUP = 2 * KS;  // input rows per barrier; the ring holds two

// two channels of T: the word a lane loads, stores and converts
template <typename T>
struct Two;

template <>
struct Two<float> {
  using W = float2;
  static __device__ __forceinline__ void unpack(W w, float (&v)[2]) {
    v[0] = w.x;
    v[1] = w.y;
  }
  static __device__ __forceinline__ W pack(const float (&v)[2]) {
    return make_float2(v[0], v[1]);
  }
};

template <>
struct Two<__nv_bfloat16> {
  using W = uint32_t;
  static __device__ __forceinline__ void unpack(W w, float (&v)[2]) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ W pack(const float (&v)[2]) {
    return Vec<__nv_bfloat16>::pack2(v[0], v[1]);
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// the layout of a block of CG channel pairs
template <typename T, int CG>
struct Tile {
  using W = typename Two<T>::W;
  static constexpr int NG = THREADS / CG;          // column pairs
  static constexpr int TW = NG * NC;               // output columns
  static constexpr int PW = TW + KS - 1;           // input pixels of a row
  static constexpr int RUN = CG * (int)sizeof(W);  // bytes of a pixel's run
  static constexpr int CPP = RUN / 16;             // 16-byte copies a pixel
  // pixel stride: a bf16 warp of two 16-pair column groups reads pixels
  // 2 apart; 96 bytes puts the second group's words on the other 16 banks
  static constexpr int SB = (sizeof(W) == 4 && CG == 16) ? RUN + 32 : RUN;
  static constexpr int RB = PW * SB;               // bytes of a ring row
  static constexpr int SMEM = 2 * GROUP * RB;
};

// grid: x = column tiles, y = batch * strips, z = channel-pair groups
template <typename T, typename TW, typename TO, int CG>
__global__ void __launch_bounds__(THREADS, 2)
dw7x7_nhwc_kernel(const T* __restrict__ x, const TW* __restrict__ taps,
                  const TW* __restrict__ bias, TO* __restrict__ y, int H, int W,
                  int C, int SH, int nstrips) {
  using L = Tile<T, CG>;
  using Wd = typename Two<T>::W;
  using Wt = typename Two<TW>::W;
  using Wo = typename Two<TO>::W;
  extern __shared__ __align__(16) unsigned char ring[];

  const int tid = threadIdx.x;
  const int npair = C / 2;
  const int p0 = blockIdx.z * CG;
  const int x0 = blockIdx.x * L::TW;
  const int b = blockIdx.y / nstrips;
  const int r0 = (blockIdx.y - b * nstrips) * SH;
  const int nin = min(SH, H - r0) + KS - 1;   // input rows the strip reads
  const T* xb = x + (size_t)b * H * W * C;

  // input rows r0 - 3 + i for i in [i0, i0 + GROUP) into ring half h
  auto load_group = [&](int i0, int h) {
    const int n = min(GROUP, nin - i0) * L::PW * L::CPP;
    for (int c = tid; c < n; c += THREADS) {
      const int r = c / (L::PW * L::CPP);
      const int px = c / L::CPP - r * L::PW;
      const int part = c % L::CPP;
      const int gy = r0 - PAD + i0 + r;
      const int gx = x0 - PAD + px;
      const int pair = p0 + part * (16 / (int)sizeof(Wd));
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && pair < npair;
      cp16(ring + (h * GROUP + r) * L::RB + px * L::SB + part * 16,
           ok ? xb + ((size_t)gy * W + gx) * C + 2 * pair : xb, ok);
    }
    cp_commit();
  };
  load_group(0, 0);

  const int g = tid / CG;
  const int k = tid - g * CG;
  const int pair = p0 + k;
  const bool live = pair < npair;
  const int ox = x0 + g * NC;

  // the taps and bias, converted to fp32 once
  float w[KS][KS][2];
  float bv[2] = {0.f, 0.f};
  {
    const Wt* tw = reinterpret_cast<const Wt*>(taps) + pair;
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        Wt q{};
        if (live) q = __ldg(tw + (dy * KS + dx) * npair);
        Two<TW>::unpack(q, w[dy][dx]);
      }
    if (live) Two<TW>::unpack(__ldg(reinterpret_cast<const Wt*>(bias) + pair),
                              bv);
  }
  // output row i - 6 + d is in slot (d + i) % 7 while input row i is summed
  float acc[KS][NC][2];
#pragma unroll
  for (int d = 0; d < KS; ++d)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc[d][j][0] = bv[0];
      acc[d][j][1] = bv[1];
    }

  const unsigned char* mine = ring + g * NC * L::SB + k * (int)sizeof(Wd);
  Wo* yb = reinterpret_cast<Wo*>(y + (size_t)b * H * W * C) + pair;
  int i = 0;
#pragma unroll 1
  for (int q = 0; i < nin; ++q) {
    cp_wait_all();                   // group q has landed (this lane's part)
    __syncthreads();                 // ... everyone's; group q - 1 is done
    if (i + GROUP < nin) load_group(i + GROUP, (q + 1) & 1);
    const unsigned char* half = mine + (q & 1) * GROUP * L::RB;
#pragma unroll 1
    for (int u0 = 0; u0 < GROUP && i < nin; u0 += KS) {
#pragma unroll
      for (int u1 = 0; u1 < KS; ++u1) {   // i % 7 == u1
        const unsigned char* row = half + (u0 + u1) * L::RB;
        float v[NC + KS - 1][2];
#pragma unroll
        for (int p = 0; p < NC + KS - 1; ++p)
          Two<T>::unpack(*reinterpret_cast<const Wd*>(row + p * L::SB), v[p]);
        // input row i feeds output row i - dy through tap row dy
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const int s = (KS - 1 - dy + u1) % KS;
#pragma unroll
          for (int dx = 0; dx < KS; ++dx)
#pragma unroll
            for (int j = 0; j < NC; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                acc[s][j][h] = fmaf(v[j + dx][h], w[dy][dx][h], acc[s][j][h]);
        }
        // output row i - 6 is complete in slot i % 7: store it, then the
        // slot starts row i + 1 (rows before the strip only ever reach a
        // slot before its restart)
        if (i >= KS - 1 && live) {
          const int o = r0 + i - (KS - 1);
#pragma unroll
          for (int j = 0; j < NC; ++j)
            if (ox + j < W)
              yb[((size_t)o * W + ox + j) * npair] = Two<TO>::pack(acc[u1][j]);
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc[u1][j][0] = bv[0];
          acc[u1][j][1] = bv[1];
        }
        if (++i == nin) break;
      }
    }
  }
}

// The tiling of one call: channel pairs per block, columns per block, rows
// per strip, strips per image and the grid.
struct Plan {
  int cg, tw, sh, nstrips;
  dim3 grid;
};

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

Plan plan(int B, int H, int W, int C) {
  const int npair = C / 2;
  auto ceil_div = [](long long a, long long b) { return (a + b - 1) / b; };
  // channel pairs per block: the one that leaves fewer lanes idle, 32 on a tie
  const long long g32 = ceil_div(npair, 32), g16 = ceil_div(npair, 16);
  Plan p;
  p.cg = (g32 * 32 <= g16 * 16) ? 32 : 16;
  p.tw = THREADS / p.cg * NC;
  const long long groups = p.cg == 32 ? g32 : g16;
  const long long base = (long long)B * ceil_div(W, p.tw) * groups;
  const long long nsm = sm_count();
  // strips: least (blocks per SM, rounded up) * (input rows per strip), with
  // at least one block per SM if the map has rows enough
  long long best = -1, best_cost = 0;
  for (int n = 1; n <= H; ++n) {
    const int sh = (int)ceil_div(H, n);
    if (ceil_div(H, sh) != n) continue;         // the same strips as n - 1
    const long long blocks = base * n;
    if (blocks < nsm && n < H) continue;
    const long long cost = ceil_div(blocks, nsm) * (sh + KS - 1);
    if (best < 0 || cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  p.nstrips = (int)best;
  p.sh = (int)ceil_div(H, best);
  p.grid = dim3((unsigned)ceil_div(W, p.tw), (unsigned)(B * best),
                (unsigned)groups);
  return p;
}

template <typename T, typename TW, typename TO, int CG>
int launch_cg(const Plan& p, const void* x, const void* taps, const void* bias,
              void* y, int H, int W, int C, cudaStream_t s) {
  using L = Tile<T, CG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw7x7_nhwc_kernel<T, TW, TO, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dw7x7_nhwc_kernel<T, TW, TO, CG><<<p.grid, THREADS, L::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const TW*>(taps),
      static_cast<const TW*>(bias), static_cast<TO*>(y), H, W, C, p.sh,
      p.nstrips);
  return (int)cudaGetLastError();
}

// x (B,H,W,C) of T; taps (7,7,C) and bias (C,) of TW; y (B,H,W,C) of TO
template <typename T, typename TW, typename TO>
int launch(const void* x, const void* taps, const void* bias, void* y, int B,
           int H, int W, int C, cudaStream_t s) {
  const Plan p = plan(B, H, W, C);
  if ((long long)B * p.nstrips > 65535 || p.grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.cg == 32)
    return launch_cg<T, TW, TO, 32>(p, x, taps, bias, y, H, W, C, s);
  return launch_cg<T, TW, TO, 16>(p, x, taps, bias, y, H, W, C, s);
}

}  // namespace dw7x7
}  // namespace
