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
// Design: a rolling column strip. A lane owns one channel pair (two
// channels: one 32-bit word in bf16, 8 bytes in fp32) of NC = 2 adjacent
// output columns and walks down a strip of SH output rows. It converts its
// 49 x 2 taps to fp32 once, into registers. Each input row of the strip is
// read once from shared memory as NC + 6 pixels of its pair, converted
// once, and feeds every output row it touches (up to 7) over all 7 column
// offsets: 7 * 7 * NC * 2 = 196 FMAs per 8 converted words (bf16), against
// 2.8 FMAs a converted input in the one-tile design this replaces. The 7
// output rows' accumulators rotate through 7 register slots (the row loop
// is unrolled by 7, so every slot index is a constant): after input row i
// the slot of output row i - 6 is complete, stored, and restarted with the
// bias for row i + 1.
//
// A block of 128 threads covers CG channel pairs (16 or 32: a warp reads
// one 64- or 128-byte run of a pixel) by 128 / CG column pairs, TW = 16 or
// 8 columns. Its input rows, TW + 6 pixels wide, stream through a ring of
// two groups of 14 rows in shared memory filled by cp.async (zero-fill
// outside the map and past C): while a group is summed the next one lands,
// one barrier a group. So the halo is read once down a strip: (SH + 6) / SH
// of the rows, (TW + 6) / TW of the columns, the latter from L2. The host
// picks CG and SH from (B, H, W, C) and the card's SM count (`plan`): the
// strip count that minimises (blocks per SM, rounded up) * (SH + 6), with
// at least one block per SM where the map allows, so the small maps of the
// path get short strips and many blocks, and the large ones long strips.
//
// What bounds it (python3 -m unicorn_torch.csrc.variants dw7x7, --sass
// dwconv7x7): 74% of the main loop's instructions are FFMAs (80% in fp32);
// at 242 registers a lane two blocks, 8 warps, share an SM, and the loop
// issues at about 60% of its rate.
// Splitting the taps between two lanes (16 warps an SM, a shuffle a row),
// a shift instead of a rotation of the slots, one column a lane, another
// FMA order and prefetching the next row into registers were each tried
// and were no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

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
template <typename T, int CG>
__global__ void __launch_bounds__(THREADS, 2)
dw7x7_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ taps,
                  const T* __restrict__ bias, T* __restrict__ y, int H, int W,
                  int C, int SH, int nstrips) {
  using L = Tile<T, CG>;
  using Wd = typename Two<T>::W;
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
    const Wd* tw = reinterpret_cast<const Wd*>(taps) + pair;
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        Wd q{};
        if (live) q = __ldg(tw + (dy * KS + dx) * npair);
        Two<T>::unpack(q, w[dy][dx]);
      }
    if (live) Two<T>::unpack(__ldg(reinterpret_cast<const Wd*>(bias) + pair),
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
  Wd* yb = reinterpret_cast<Wd*>(y + (size_t)b * H * W * C) + pair;
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
              yb[((size_t)o * W + ox + j) * npair] = Two<T>::pack(acc[u1][j]);
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

template <typename T, int CG>
int launch_cg(const Plan& p, const void* x, const void* taps, const void* bias,
              void* y, int H, int W, int C, cudaStream_t s) {
  using L = Tile<T, CG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw7x7_nhwc_kernel<T, CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dw7x7_nhwc_kernel<T, CG><<<p.grid, THREADS, L::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps),
      static_cast<const T*>(bias), static_cast<T*>(y), H, W, C, p.sh,
      p.nstrips);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* taps, const void* bias, void* y, int B,
           int H, int W, int C, cudaStream_t s) {
  const Plan p = plan(B, H, W, C);
  if ((long long)B * p.nstrips > 65535 || p.grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.cg == 32) return launch_cg<T, 32>(p, x, taps, bias, y, H, W, C, s);
  return launch_cg<T, 16>(p, x, taps, bias, y, H, W, C, s);
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

// The tiling dwconv7x7_nhwc picks for (B, H, W, C) on the current device:
// out[0..6] = channel pairs per block, columns per block, rows per strip,
// strips per image, grid x, y, z. Returns 0, or an error for a bad shape.
extern "C" int dwconv7x7_plan(int B, int H, int W, int C, int* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 2)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, H, W, C);
  const int v[7] = {p.cg, p.tw, p.sh, p.nstrips, (int)p.grid.x,
                    (int)p.grid.y, (int)p.grid.z};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* dwconv7x7_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
