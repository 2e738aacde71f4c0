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
// fp32: bf16 on the tensor cores (wgmma), fp32 with plain FMAs (no TF32: the
// plain version and the TPU kernel are fp32).
//
// Bound on an H100 SXM for the 27 blocks of an 800x1280 frame (the seven
// shapes of ops/dwconv7x7.py PATH_SHAPES): the two products are 16*P*C^2
// operations, about 236 GFLOP, 0.24 ms at 989 TFLOP/s in bf16; the 49 dw
// taps 98*P*C fp32 operations, 0.09 ms at 67 TFLOP/s; x in, y out and the
// weights once are 2*P*C + 8*C^2 elements, 0.07 ms. Operations bound every
// shape: 0.3262 ms a frame in bf16, 3.609 ms in fp32 (products at 67
// TFLOP/s). Per shape (bf16, µs): 200x320x96 19, 100x160x192 14, 50x80x384
// 12, 25x40x768 11, 100x160x256 24, 50x80x256 6, 25x40x256 1.5, each the
// products plus the dw taps. chip_smoke.py recomputes both sides per shape.
//
// Design, bf16 (the dtype the model serves). The TPU kernel keeps a row
// slab and both weight matrices in VMEM; here W1 and W2 (up to 4.7 MB each)
// stream through shared memory, and a block is two or three launches:
//  (1) dw sums: the strip kernel of dw7x7_strip.cuh (the dwconv7x7
//      design) with fp32 taps and an unrounded fp32 store.
//  (2) mlp_kernel: a block owns M = 64 or 128 pixels, one consumer
//      warpgroup of 64 rows each, plus one producer warp. The consumers
//      read their rows' fp32 sums (L2, just written) as coalesced rows, 16
//      or 8 rows a warp in flight: mean, then centred variance from the
//      registers, the rows' sums reduced together (a butterfly that trades
//      half the partials each xor step), then the normalised rows rounded
//      to bf16 into the A tile in shared memory, in the 128-byte-swizzled
//      K-major layout that wgmma reads (generic-proxy stores, so
//      fence.proxy.async before the first wgmma). The producer streams W1
//      and W2 in 64 x 64 pieces (8 KB TMA boxes; K-major as stored; past the
//      matrix TMA fills zeros, so C and 4C need no padding) through a ring
//      of full / empty mbarriers. The block walks the hidden units in
//      chunks of 64: S = A . W1_chunk^T (wgmma m64n64k16, K = C in k16
//      steps), + b1 and the GELU on the accumulator fragments in fp32,
//      rounded to bf16 in registers, which are wgmma's A fragment as they
//      stand (the RS form, as flash attention 3 feeds P). Each K piece is
//      released as soon as the product after it is issued and it is done,
//      so that the ring keeps loading.
//      Fused route (C <= 192, where the map fills the card): Y += h .
//      W2_chunk^T with Y (64 x C a consumer) in registers, issued as n64
//      slices and an n32 one, so that C = 96 wastes nothing. Epilogue: +
//      b2, x gamma, + x in fp32 on the fragments, one rounding, staged in
//      the consumer's own A rows and stored as 16-byte rows. Two launches a
//      block, h never leaves the chip.
//      Split route (C > 192, and maps too small to fill the card): (2)
//      stores h (L2-resident) from a grid of M tiles x groups of hidden
//      chunks, as many groups as keep it to one wave (each group normalises
//      its rows again); (3) p2_kernel streams h and W2 through a TMA ring,
//      one or two consumers of 64 rows x 64 or 128 columns (wgmma
//      m64n64k16 slices), with the same epilogue. The plan
//      (ops/convnext_block.py `plan`) picks the route, the tiles, the ring
//      stages and the groups; the C entry sizes each launch's shared memory
//      from it and refuses a plan it cannot run.
// Design, fp32 (the op's dtype option; no path runs it): (1) as above with
// an fp32 input; (2) and (3) one FMA kernel, gemm_f32_kernel: a block of
// TM = 64 or 128 rows x 128 or 64 columns, each thread an 8 x 8 or 8 x 4
// register tile (correlation_train.cu's tiling), K streamed in chunks of
// 32 through a ring of three cp.async slots; in (2) the block computes its
// rows' mean and rstd first and normalises each landed A chunk in place
// (LayerNorm folded into the A load), h goes through device memory.
//
// Tried and dropped (python3 -m unicorn_torch.csrc.variants convnext_block
// and python3 convnext_plan_sweep.py, PERF.md §6): the fused route at C =
// 256 (its 128 accumulator registers a thread spill: 0.1665 / 0.1502 /
// 0.1452 ms against the split route's 0.1463 / 0.0496 / 0.0315 at the
// three C = 256 shapes on an H100 SXM at 700 W; removed), 64-row fused
// tiles (twice the weight traffic, no faster at C = 96, slower at 192),
// product 2 tiles of 64 x 128 and 64 x 256 (fewer blocks, slower), more
// hidden groups than one wave of blocks, a thread (two) per row for the
// LayerNorm (uncoalesced, several times slower at C >= 384).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dw7x7_strip.cuh"   // the dw sums
#include "tma_wgmma.cuh"     // mbarriers, TMA loads, wgmma, tensor maps
#include "vec16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;                     // threads of a warpgroup
constexpr int PIECE = 64;                   // rows and K columns of a piece
constexpr int PIECE_BYTES = PIECE * 128;    // a bf16 64 x 64 box
constexpr int MAX_NJ = 6;                   // fused Y: up to 6 x 32 columns
constexpr unsigned FULL = 0xffffffffu;

// the plan's fields, in the order ops/convnext_block.py `plan` writes them
enum {
  PL_ROUTE,     // 0 fused, 1 split
  PL_M1,        // rows a block of the first product
  PL_N1,        // hidden units a block of the first product
  PL_STAGES1,   // its ring stages
  PL_M2,        // rows a block of the second product (split)
  PL_N2,        // columns a block of the second product
  PL_STAGES2,   // its ring stages
  PL_LEN
};

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Dynamic shared memory a block takes, from the plan's tiles and stages
// (ops/convnext_block.py `plan` shows the same sums on the CPU). The first
// product: the A tile (and on the fused route the x tile beside it), the
// ring and its barriers, the x barrier, and the 1024-byte alignment of the
// swizzled tiles
inline int mlp_smem(int m, int C, int stages, bool fused) {
  return 1024 + (fused ? 2 : 1) * (int)cdiv(C, 64) * m * 128 +
         stages * (PIECE_BYTES + 16) + 16;
}

// the second product (split route): the ring of h and W2 boxes and its
// barriers, the staged output tile, its barrier, the alignment
inline int p2_smem(int m, int n, int stages) {
  return 1024 + stages * ((m + n) * 128 + 16) + (m / 64) * n * 128 + 16;
}

// fp32 products
constexpr int F_KC = 32;                    // K a chunk
constexpr int F_LD = F_KC + 4;              // row stride of a slot's tiles
constexpr int F_STAGES = 3;                 // slots of the ring
constexpr int F_G = 16;                     // threads along the columns

// the fp32 products: the cp.async slots, and the rows' mean and rstd
inline int f32_smem(int m, int n, bool ln) {
  return F_STAGES * (m + n) * F_LD * 4 + (ln ? 2 * m * 4 : 0);
}

template <bool EXACT>
__device__ __forceinline__ float gelu(float x) {
  if (EXACT) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return Vec<bf16>::pack2(lo, hi);
}

// named barrier over the 128 threads of one warpgroup
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(WG) : "memory");
}

// byte offset of (row r, column c) of a bf16 tile kept as 64-column chunks
// `cstride` bytes apart, rows of 128 bytes, the 16-byte units of row r
// xor-swizzled by r % 8 (what a TMA box with the 128-byte swizzle holds)
__device__ __forceinline__ int sw_off(int r, int c, int cstride) {
  return (c >> 6) * cstride + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// ------------------------------------------------ LayerNorm into the A tile
// The sums over the 32 lanes of N row partials v[0..N) at once: each xor
// step a lane keeps one half of its partials and trades the other half
// with its partner, so N rows take N - 1 + log2(32 / N) shuffles, not 5 N.
// Returns the total of row lane / (32 / N), which lanes k (32 / N) ..
// hold; v is overwritten.
template <int N, int OFF = 16>
__device__ __forceinline__ float fold_rows(float* v, int lane) {
  if constexpr (N == 1) {
    float x = v[0];
#pragma unroll
    for (int o = OFF; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
  } else {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    return fold_rows<N / 2, OFF / 2>(v, lane);
  }
}

// Rows m0 .. m0+M of the fp32 sums (P, C) -> the bf16 A tile: ceil(C/64)
// chunks of M rows x 128 bytes (sw_off layout). Warp w (0 .. M/16 - 1)
// takes rows 16 w .. 16 w + 15, R rows at a time: lane l loads float4 l +
// 32 i (i < NV, C <= 128 NV) of each, once, as coalesced rows; mean, then
// centred variance from the registers (the R rows reduced together), then
// the normalised values rounded to bf16, 8 bytes a lane. Rows >= P and
// columns >= C are zeros.
template <int M, int NV, int R>
__device__ __forceinline__ void ln_tile(const float* __restrict__ sums,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b,
                                        unsigned char* As, long long m0,
                                        long long P, int C, float eps,
                                        int warp, int lane) {
  static_assert(16 % R == 0, "rows a step divide a warp's 16 rows");
  constexpr int SPAN = 32 / R;                // lanes that end with a row
  const int n4 = C / 4;                       // float4 of a row
  const int k4 = (int)cdiv(C, 64) * 16;       // 4-channel groups to fill
  const int cstride = M * 128;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the lane's scale and shift: in registers across its rows where they
  // are few, else loaded again for each step of rows
  constexpr bool KEEP = NV <= 4;
  auto scale_shift = [&](int i, float4& g, float4& h) {
    const int c4 = lane + 32 * i;
    g = c4 < n4 ? __ldg(reinterpret_cast<const float4*>(ln_s) + c4) : zero;
    h = c4 < n4 ? __ldg(reinterpret_cast<const float4*>(ln_b) + c4) : zero;
  };
  float4 gk[KEEP ? NV : 1], hk[KEEP ? NV : 1];
  if constexpr (KEEP) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scale_shift(i, gk[i], hk[i]);
  }
#pragma unroll 1
  for (int r0 = warp * 16; r0 < warp * 16 + 16; r0 += R) {
    float4 v[R][NV];
    float part[R], mu[R], rstd[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long gm = m0 + r0 + k;
      const float4* row = reinterpret_cast<const float4*>(
          sums + (gm < P ? gm : 0) * C);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c4 = lane + 32 * i;
        v[k][i] = (gm < P && c4 < n4) ? __ldg(row + c4) : zero;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      part[k] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        part[k] += (v[k][i].x + v[k][i].y) + (v[k][i].z + v[k][i].w);
    }
    const float mu_row = fold_rows<R>(part, lane) / (float)C;
#pragma unroll
    for (int k = 0; k < R; ++k) mu[k] = __shfl_sync(FULL, mu_row, k * SPAN);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      part[k] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < n4) {
          const float a = v[k][i].x - mu[k], b = v[k][i].y - mu[k];
          const float c = v[k][i].z - mu[k], d = v[k][i].w - mu[k];
          part[k] += (a * a + b * b) + (c * c + d * d);
        }
      }
    }
    const float rstd_row = rsqrtf(fold_rows<R>(part, lane) / (float)C + eps);
#pragma unroll
    for (int k = 0; k < R; ++k) rstd[k] = __shfl_sync(FULL, rstd_row, k * SPAN);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c4 = lane + 32 * i;
      if (c4 >= k4) continue;
      float4 g, h;
      if constexpr (KEEP) {
        g = gk[i];
        h = hk[i];
      } else {
        scale_shift(i, g, h);
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = r0 + k;
        uint2 q = make_uint2(0u, 0u);
        if (c4 < n4 && m0 + r < P) {
          const float4 a = v[k][i];
          q = make_uint2(pack2((a.x - mu[k]) * rstd[k] * g.x + h.x,
                               (a.y - mu[k]) * rstd[k] * g.y + h.y),
                         pack2((a.z - mu[k]) * rstd[k] * g.z + h.z,
                               (a.w - mu[k]) * rstd[k] * g.w + h.w));
        }
        *reinterpret_cast<uint2*>(As + sw_off(r, 4 * c4, cstride)) = q;
      }
    }
  }
}

// ------------------------------------------- epilogue of the second product
// y = round(x + (Y + b2) * gamma) for the 64 rows of one consumer. Y holds
// columns col0 + [0, 32 NJ) in the accumulator layout (d[4c + e]: row
// 16 warp + lane / 4 + 8 (e / 2), column 8 c + 2 (lane % 4) + e % 2).
// `stage` holds this consumer's x tile (sw_off layout, `cstride`, loaded
// by TMA): each pair of x is read and its result written in its place,
// then the consumer stores the rows as 16-byte vectors.
template <int NJ>
__device__ __forceinline__ void residual_epilogue(
    const float (&Y)[NJ * 16], unsigned char* stage, int cstride,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    bf16* __restrict__ y, long long row0, int col0, long long P, int C,
    int wtid, int bar) {
  const int warp = wtid / 32, lane = wtid % 32;
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < NJ * 4; ++c) {
    const int col = 8 * c + cq;
    if (col0 + col < C) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col0 + col));
      const float2 gg = __ldg(reinterpret_cast<const float2*>(gamma + col0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* at = reinterpret_cast<uint32_t*>(
            stage + sw_off(rq + 8 * h, col, cstride));
        const uint32_t w = *at;
        const float o0 = __uint_as_float(w << 16) +
                         (Y[4 * c + 2 * h] + bb.x) * gg.x;
        const float o1 = __uint_as_float(w & 0xffff0000u) +
                         (Y[4 * c + 2 * h + 1] + bb.y) * gg.y;
        *at = pack2(o0, o1);
      }
    }
  }
  wg_sync(bar);
  const int ncol = min(32 * NJ, C - col0);
  const int nu = ncol / 8;
  for (int i = wtid; i < 64 * nu; i += WG) {
    const int r = i / nu, u = i - r * nu;
    const long long gm = row0 + r;
    if (gm < P)
      *reinterpret_cast<uint4*>(y + gm * C + col0 + 8 * u) =
          *reinterpret_cast<const uint4*>(stage + sw_off(r, 8 * u, cstride));
  }
}

// ------------------------------------------------- the first product (bf16)
// grid: x = tiles of M = 64 CONS rows, y = groups of `chunks` hidden chunks
// of 64 (one group on the fused route). NJ > 0: the fused route, Y (64 x
// 32 NJ a consumer) in registers, `out` = y (P, C); NJ = 0: h (P, 4C) is
// stored to `out`. w1_map: W1 (4C, C), w2_map: W2 (C, 4C), 64 x 64 boxes.
// WIDE (split route): C up to 1664, else 512.
template <int CONS, int NJ, bool EXACT, bool WIDE = false>
__global__ void __launch_bounds__(CONS * WG + 32, 1)
mlp_kernel(const __grid_constant__ CUtensorMap w1_map,
           const __grid_constant__ CUtensorMap w2_map,
           const __grid_constant__ CUtensorMap x_map,
           const float* __restrict__ sums, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, const float* __restrict__ b1,
           const float* __restrict__ b2, const float* __restrict__ gamma,
           bf16* __restrict__ out, long long P, int C, int chunks,
           int stages, float eps) {
  constexpr int M = CONS * 64;
  constexpr bool FUSED = NJ > 0;
  constexpr int NP = (NJ + 1) / 2;          // W2 pieces a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int KC = (C + 63) / 64;             // K pieces over C
  const int KS = (C + 15) / 16;             // k16 steps over C
  const int H4 = 4 * C;
  unsigned char* As = smem;                 // KC chunks x M rows x 128 B
  unsigned char* Xs = As + KC * M * 128;    // fused: x rows, A's layout
  unsigned char* ring = Xs + (FUSED ? KC * M * 128 : 0);   // stages x 8 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * PIECE_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* x_bar = empty + stages;
  const int nch = (H4 + 63) / 64;
  const int j0 = blockIdx.y * chunks;
  const int j1 = min(nch, j0 + chunks);
  const long long m0 = (long long)blockIdx.x * M;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * 4);       // one arrive a consumer warp
    }
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONS * WG) {
    // ---- producer warp: one thread keeps the ring full, in the order the
    // consumers take the pieces: each chunk's W1 pieces, then its W2 pieces
    if (tid == CONS * WG) {
      int t = 0;
      auto put = [&](const CUtensorMap* map, int cx, int cy) {
        const int s = t % stages;
        mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], PIECE_BYTES);
        tma_load(ring + s * PIECE_BYTES, map, cx, cy, &full[s]);
        ++t;
      };
      if (FUSED) {                          // the residual, for the epilogue
        mbar_expect_tx(x_bar, KC * M * 128);
        for (int k = 0; k < KC; ++k)
          tma_load(Xs + k * M * 128, &x_map, k * PIECE, (int)m0, x_bar);
      }
      for (int j = j0; j < j1; ++j) {
        for (int k = 0; k < KC; ++k) put(&w1_map, k * PIECE, j * PIECE);
        if (FUSED)
          for (int n = 0; n < NP; ++n) put(&w2_map, j * PIECE, n * PIECE);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows m0 + 64 wg .. + 64
  const int wg = tid / WG, wtid = tid % WG;
  const int warp = wtid / 32, lane = tid % 32;
  // the row loads of the LayerNorm: C <= 128 NV; R rows in flight (about
  // 64 floats a lane)
  constexpr int NV = FUSED ? (NJ <= 4 ? 1 : 2) : (WIDE ? 13 : 4);
  constexpr int R = NV == 1 ? 16 : (NV == 2 ? 8 : (NV == 4 ? 4 : 2));
  ln_tile<M, NV, R>(sums, ln_s, ln_b, As, m0, P, C, eps, tid / 32, lane);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg_sync(1 + wg);

  unsigned char* Aw = As + wg * 64 * 128;   // my rows of chunk 0
  const int rq = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const long long row0 = m0 + wg * 64;
  float S[32];
  float Y[FUSED ? NJ * 16 : 1];
#pragma unroll
  for (int i = 0; i < (FUSED ? NJ * 16 : 1); ++i) Y[i] = 0.f;
  uint32_t hq[4][4];
  // h is read by the asynchronous Y product until the next wait: keep the
  // compiler from giving its registers to anything else before then
  auto hold_h = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) asm volatile("" : "+r"(hq[q][m]) :: "memory");
  };
  auto release = [&](int pos) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pos % stages]);
  };

  // ring positions: chunk j's W1 pieces at base(j) .. + KC, then its W2
  // pieces .. + NP, as the producer issues them
  auto base = [&](int j) { return (j - j0) * (KC + NP); };
  // chunk j's b1 pairs of this thread's columns
  auto load_b1 = [&](int j, float2 (&bb)[8]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = j * 64 + 8 * c + cq;
      bb[c] = col < H4 ? __ldg(reinterpret_cast<const float2*>(b1 + col))
                       : make_float2(0.f, 0.f);
    }
  };
  // wgmmas of K piece k of chunk j: S (+)= A_k . W1_(j,k)^T
  auto mma_piece = [&](int j, int k) {
    const int pos = base(j) + k;
    mbar_wait(&full[pos % stages], (pos / stages) & 1);
    const uint64_t da = sw128_desc(Aw + k * M * 128);
    const uint64_t db = sw128_desc(ring + (pos % stages) * PIECE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (4 * k + kk < KS)
        wgmma_m64n64k16_ss<0>(S, da + 2 * kk, db + 2 * kk, 1);
  };
  // + b1, GELU in fp32, one rounding; then Y += h . W2_chunk^T (fused: one
  // commit group, waited for with the next chunk's product 1) or h stored
  auto finish = [&](int j, const float2 (&bb)[8]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      S[4 * c] = gelu<EXACT>(S[4 * c] + bb[c].x);
      S[4 * c + 1] = gelu<EXACT>(S[4 * c + 1] + bb[c].y);
      S[4 * c + 2] = gelu<EXACT>(S[4 * c + 2] + bb[c].x);
      S[4 * c + 3] = gelu<EXACT>(S[4 * c + 3] + bb[c].y);
    }
    if constexpr (FUSED) {
      // the accumulator pairs are the m16n8k16 A fragment of k16 step q
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          hq[q][m] = pack2(S[8 * q + 2 * m], S[8 * q + 2 * m + 1]);
      const int w2 = base(j) + KC;
      for (int n = 0; n < NP; ++n)
        mbar_wait(&full[(w2 + n) % stages], ((w2 + n) / stages) & 1);
      fence_acc(Y);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        static_for<0, NJ / 2>([&](auto i) {
          constexpr int I = decltype(i)::value;
          wgmma_m64n64k16_rs<32 * I>(
              Y, hq[q],
              sw128_desc(ring + ((w2 + I) % stages) * PIECE_BYTES) + 2 * q);
        });
        if constexpr (NJ % 2)
          wgmma_m64n32k16_rs<32 * (NJ / 2)>(
              Y, hq[q],
              sw128_desc(ring + ((w2 + NJ / 2) % stages) * PIECE_BYTES) +
                  2 * q);
      }
      wgmma_commit();
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = j * 64 + 8 * c + cq;
        if (col < H4) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long gm = row0 + rq + 8 * h;
            if (gm < P)
              *reinterpret_cast<uint32_t*>(out + gm * H4 + col) =
                  pack2(S[4 * c + 2 * h], S[4 * c + 2 * h + 1]);
          }
        }
      }
    }
  };
  auto release_w2 = [&](int j) {            // chunk j's Y product is done
    if (FUSED && j >= j0)
      for (int n = 0; n < NP; ++n) release(base(j) + KC + n);
  };

  // product 1 of a chunk: one commit group a K piece, each piece released
  // once the next one is issued and the one before it is done, so that the
  // ring keeps loading; the W2 pieces of the chunk before are released once
  // its Y product is done
  float2 bb[8];
  for (int j = j0; j < j1; ++j) {
    load_b1(j, bb);
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = 0.f;
    for (int k = 0; k < KC; ++k) {
      mma_piece(j, k);
      wgmma_commit();
      wgmma_wait<1>();          // all but this piece: the piece before, and
                                // the previous chunk's Y product
      if (k == 0) {
        hold_h();
        release_w2(j - 1);
      } else {
        release(base(j) + k - 1);
      }
    }
    wgmma_wait<0>();
    fence_acc(S);
    release(base(j) + KC - 1);
    finish(j, bb);
  }
  if constexpr (FUSED) {
    wgmma_wait<0>();
    hold_h();
    fence_acc(Y);
    mbar_wait(x_bar, 0);
    residual_epilogue<NJ>(Y, Xs + wg * 64 * 128, M * 128, b2, gamma, out,
                          row0, 0, P, C, wtid, 1 + wg);
  }
}

// ------------------------------------------ the second product, split route
// grid: x = tiles of MT = 64 CONS rows, y = tiles of NT = 64 NB columns of
// y; CONS consumer warpgroups of 64 rows share each W2 piece. h_map: h
// (P, 4C), boxes of MT rows x 64; w2_map: W2 (C, 4C), boxes of NT rows x 64.
template <int CONS, int NB>
__global__ void __launch_bounds__(CONS * WG + 32, 1)
p2_kernel(const __grid_constant__ CUtensorMap h_map,
          const __grid_constant__ CUtensorMap w2_map,
          const __grid_constant__ CUtensorMap x_map,
          const float* __restrict__ b2, const float* __restrict__ gamma,
          bf16* __restrict__ y, long long P, int C, int stages) {
  constexpr int MT = 64 * CONS, NT = 64 * NB;
  constexpr int STAGE = (MT + NT) * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = smem;                         // stages x STAGE
  unsigned char* stage_out = ring + stages * STAGE;   // x: CONS x NB chunks
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stage_out + CONS * NT * 128);
  uint64_t* empty = full + stages;
  uint64_t* x_bar = empty + stages;
  const int H4 = 4 * C;
  const int KP = (H4 + 63) / 64, KS = (H4 + 15) / 16;
  const long long m0 = (long long)blockIdx.x * MT;
  const int n0 = blockIdx.y * NT;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * 4);
    }
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONS * WG) {
    if (tid == CONS * WG) {
      // the residual's 64 x 64 boxes, for the epilogue
      mbar_expect_tx(x_bar, CONS * NT * 128);
      for (int w = 0; w < CONS; ++w)
        for (int b = 0; b < NB; ++b)
          tma_load(stage_out + (w * NB + b) * 64 * 128, &x_map, n0 + b * 64,
                   (int)m0 + w * 64, x_bar);
      for (int p = 0; p < KP; ++p) {
        const int s = p % stages;
        mbar_wait(&empty[s], ((p / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        tma_load(ring + s * STAGE, &h_map, p * PIECE, (int)m0, &full[s]);
        tma_load(ring + s * STAGE + MT * 128, &w2_map, p * PIECE, n0,
                 &full[s]);
      }
    }
    return;
  }

  const int wg = tid / WG, wtid = tid % WG, lane = tid % 32;
  float Y[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) Y[i] = 0.f;
  for (int p = 0; p < KP; ++p) {
    const int s = p % stages;
    mbar_wait(&full[s], (p / stages) & 1);
    const uint64_t da = sw128_desc(ring + s * STAGE + wg * 64 * 128);
    const uint64_t db = sw128_desc(ring + s * STAGE + MT * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (4 * p + kk < KS)
        static_for<0, NB>([&](auto i) {
          constexpr int I = decltype(i)::value;
          wgmma_m64n64k16_ss<32 * I>(Y, da + 2 * kk,
                                     db + ((I * 64 * 128) >> 4) + 2 * kk, 1);
        });
    wgmma_commit();
    wgmma_wait<1>();
    if (p > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(p - 1) % stages]);
    }
  }
  wgmma_wait<0>();
  fence_acc(Y);
  mbar_wait(x_bar, 0);
  residual_epilogue<2 * NB>(Y, stage_out + wg * NT * 128, 64 * 128, b2, gamma,
                            y, m0 + wg * 64, n0, P, C, wtid, 1 + wg);
}

// ------------------------------------------------------- the fp32 products
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Y (M, N) = epi(A (M, K) . Wt (N, K)^T), A and Wt row-major. A block of
// 2 TM threads, a (TM / 8) x 16 grid, owns TM rows x FN = 16 NQ columns:
// thread (to, ts) an 8 x NQ register tile, rows to + (TM / 8) r, columns
// ts + 16 q,
// read as float4 along K from row-major tiles of stride F_LD. K streams in
// chunks of F_KC through a ring of F_STAGES cp.async slots (A: TM x F_LD,
// Wt: FN x F_LD floats; zeros past M, N and K).
// EPI 0 (the first product): A holds the fp32 dw sums; the block takes its
// rows' mean and rstd first (a warp per 16 rows, two passes) and normalises
// each landed A chunk in place with ln_s, ln_b; Y = gelu(acc + bias).
// EPI 1: Y = res + (acc + bias) * gamma.
template <int TM, int NQ, int EPI, bool EXACT>
__global__ void __launch_bounds__(2 * TM, NQ == 4 ? 2 : 1)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                const float* __restrict__ bias, const float* __restrict__ gamma,
                const float* __restrict__ res, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, float* __restrict__ Y,
                long long M, int N, int K, float eps) {
  constexpr int NT = 2 * TM;
  constexpr int RS = TM / 8;
  constexpr int FN = 16 * NQ;
  constexpr int SLOT = (TM + FN) * F_LD;
  constexpr bool LN = EPI == 0;
  extern __shared__ __align__(16) float fs[];
  float* mus = fs + F_STAGES * SLOT;        // LN: [TM] mean, [TM] rstd
  float* rss = mus + TM;
  const int tid = threadIdx.x;
  const int to = tid / F_G, ts = tid % F_G;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * FN;
  const int nk = (K + F_KC - 1) / F_KC;

  // chunk kc into its slot; a commit group even when kc >= nk
  auto load = [&](int kc) {
    if (kc < nk) {
      float* d = fs + (kc % F_STAGES) * SLOT;
      const int k0 = kc * F_KC;
      for (int i = tid; i < (TM + FN) * (F_KC / 4); i += NT) {
        const int r = i / (F_KC / 4), c = 4 * (i % (F_KC / 4));
        const bool is_a = r < TM;
        const long long gr = is_a ? m0 + r : (long long)n0 + (r - TM);
        const bool ok = (is_a ? gr < M : gr < N) && k0 + c < K;
        const float* src = (is_a ? A : Wt) + gr * K + k0 + c;
        dw7x7::cp16(d + r * F_LD + c, ok ? src : A, ok);
      }
    }
    dw7x7::cp_commit();
  };
  load(0);
  load(1);

  if (LN) {
    // warp w takes rows 16 w .. 16 w + 15, their loads of one column step
    // in flight together; mean, then centred variance (two passes)
    const int warp = tid / 32, lane = tid % 32;
    const int n4 = K / 4;
    const float4* rows[16];
    bool live[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const long long gm = m0 + warp * 16 + k;
      live[k] = gm < M;
      rows[k] = reinterpret_cast<const float4*>(A + (live[k] ? gm : 0) * K);
    }
    float s[16], mu[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = 0.f;
    for (int c4 = lane; c4 < n4; c4 += 32) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (live[k]) {
          const float4 q = __ldg(rows[k] + c4);
          s[k] += (q.x + q.y) + (q.z + q.w);
        }
      }
    }
    const float mu_row = fold_rows<16>(s, lane) / (float)K;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      mu[k] = __shfl_sync(FULL, mu_row, 2 * k);
      s[k] = 0.f;
    }
    for (int c4 = lane; c4 < n4; c4 += 32) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (live[k]) {
          const float4 q = __ldg(rows[k] + c4);
          const float a = q.x - mu[k], b = q.y - mu[k];
          const float c = q.z - mu[k], d = q.w - mu[k];
          s[k] += (a * a + b * b) + (c * c + d * d);
        }
      }
    }
    const float var_row = fold_rows<16>(s, lane) / (float)K;
    if (lane % 2 == 0) {      // lanes 2k, 2k + 1 hold row k
      mus[warp * 16 + lane / 2] = mu_row;
      rss[warp * 16 + lane / 2] = rsqrtf(var_row + eps);
    }
  }

  float acc[8][NQ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    cp_wait1();                 // chunk kc has landed (this thread's part)
    __syncthreads();            // ... everyone's; chunk kc - 1 is done
    load(kc + 2);
    float* a_t = fs + (kc % F_STAGES) * SLOT;
    const float* b_t = a_t + TM * F_LD;
    if (LN) {
      for (int i = tid; i < TM * (F_KC / 4); i += NT) {
        const int r = i / (F_KC / 4), c = 4 * (i % (F_KC / 4));
        const int k = kc * F_KC + c;
        if (k < K) {
          float4 q = *reinterpret_cast<float4*>(a_t + r * F_LD + c);
          const float4 g = __ldg(reinterpret_cast<const float4*>(ln_s + k));
          const float4 h = __ldg(reinterpret_cast<const float4*>(ln_b + k));
          const float mu = mus[r], rs = rss[r];
          q.x = (q.x - mu) * rs * g.x + h.x;
          q.y = (q.y - mu) * rs * g.y + h.y;
          q.z = (q.z - mu) * rs * g.z + h.z;
          q.w = (q.w - mu) * rs * g.w + h.w;
          *reinterpret_cast<float4*>(a_t + r * F_LD + c) = q;
        }
      }
      __syncthreads();
    }
#pragma unroll 2
    for (int c = 0; c < F_KC; c += 4) {
      float4 av[8], bv[NQ];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        av[r] = *reinterpret_cast<const float4*>(a_t + (to + RS * r) * F_LD + c);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        bv[q] = *reinterpret_cast<const float4*>(b_t + (ts + F_G * q) * F_LD + c);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float v = acc[r][q];
          v = fmaf(av[r].x, bv[q].x, v);
          v = fmaf(av[r].y, bv[q].y, v);
          v = fmaf(av[r].z, bv[q].z, v);
          v = fmaf(av[r].w, bv[q].w, v);
          acc[r][q] = v;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long gm = m0 + to + RS * r;
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int gn = n0 + ts + F_G * q;
      if (gn < N) {
        const float t = acc[r][q] + __ldg(bias + gn);
        Y[gm * N + gn] = EPI == 0 ? gelu<EXACT>(t)
                                  : __ldg(res + gm * N + gn) + t * __ldg(gamma + gn);
      }
    }
  }
}

// ------------------------------------------------------------ host side
// set once per kernel instantiation: the most dynamic shared memory a
// block may take
template <auto KERNEL>
int allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  return (int)err;
}

// Whether the kernels run the plan pl: tiles they are built for, stages
// the ring needs, and shared memory within a block's 227 KB.
bool plan_ok(const int* pl, long long P, int C, int dtype) {
  const long long nch = cdiv(4LL * C, 64);
  for (int i = 0; i < PL_LEN; ++i)
    if (pl[i] < 0) return false;
  if (dtype == 0) {
    const bool m_ok = (pl[PL_M1] == 64 || pl[PL_M1] == 128) &&
                      (pl[PL_M2] == 64 || pl[PL_M2] == 128);
    const bool n_ok = (pl[PL_N1] == 64 || pl[PL_N1] == 128) &&
                      (pl[PL_N2] == 64 || pl[PL_N2] == 128);
    return pl[PL_ROUTE] == 1 && m_ok && n_ok && pl[PL_STAGES1] == F_STAGES &&
           pl[PL_STAGES2] == F_STAGES &&
           f32_smem(pl[PL_M1], pl[PL_N1], true) <= MAX_SMEM &&
           cdiv(4LL * C, pl[PL_N1]) <= 65535 && cdiv(C, pl[PL_N2]) <= 65535;
  }
  if (pl[PL_ROUTE] == 0) {
    const int nj = (int)cdiv(C, 32), np = (nj + 1) / 2;
    return nj <= MAX_NJ && pl[PL_M1] == 128 && pl[PL_N1] == 64 * nch &&
           pl[PL_STAGES1] >= np + 1 &&
           mlp_smem(128, C, pl[PL_STAGES1], true) <= MAX_SMEM &&
           pl[PL_M2] == 0 && pl[PL_N2] == 0 && pl[PL_STAGES2] == 0;
  }
  const int n2 = pl[PL_N2];
  return pl[PL_ROUTE] == 1 && (pl[PL_M1] == 64 || pl[PL_M1] == 128) &&
         pl[PL_N1] > 0 && pl[PL_N1] % 64 == 0 && pl[PL_STAGES1] >= 2 &&
         mlp_smem(pl[PL_M1], C, pl[PL_STAGES1], false) <= MAX_SMEM &&
         cdiv(nch, pl[PL_N1] / 64) <= 65535 &&
         (pl[PL_M2] == 64 || pl[PL_M2] == 128) && (n2 == 64 || n2 == 128) &&
         pl[PL_STAGES2] >= 2 &&
         p2_smem(pl[PL_M2], n2, pl[PL_STAGES2]) <= MAX_SMEM &&
         cdiv(C, n2) <= 65535;
}

template <int CONS, int NJ, bool EXACT, bool WIDE = false>
int launch_mlp(const CUtensorMap& w1_map, const CUtensorMap& w2_map,
               const CUtensorMap& x_map, const float* sums, const float* ln_s,
               const float* ln_b, const float* b1, const float* b2,
               const float* gamma, bf16* out, long long P, int C,
               const int* pl, float eps, cudaStream_t s) {
  auto kernel = mlp_kernel<CONS, NJ, EXACT, WIDE>;
  int err = allow_smem<mlp_kernel<CONS, NJ, EXACT, WIDE>>();
  if (err) return err;
  const int chunks = pl[PL_N1] / 64;
  const dim3 grid((unsigned)cdiv(P, pl[PL_M1]),
                  (unsigned)cdiv(cdiv(4LL * C, 64), chunks));
  const int smem = mlp_smem(CONS * 64, C, pl[PL_STAGES1], NJ > 0);
  kernel<<<grid, CONS * WG + 32, smem, s>>>(
      w1_map, w2_map, x_map, sums, ln_s, ln_b, b1, b2, gamma, out, P, C,
      chunks, pl[PL_STAGES1], eps);
  return (int)cudaGetLastError();
}

template <bool EXACT>
int launch_fused(const CUtensorMap& w1_map, const CUtensorMap& w2_map,
                 const CUtensorMap& x_map, const float* sums,
                 const float* ln_s, const float* ln_b, const float* b1,
                 const float* b2, const float* gamma, bf16* y, long long P,
                 int C, const int* pl, float eps, cudaStream_t s) {
#define CB_FUSED(NJ)                                                       \
  case NJ:                                                                 \
    return launch_mlp<2, NJ, EXACT>(w1_map, w2_map, x_map, sums, ln_s,    \
                                    ln_b, b1, b2, gamma, y, P, C, pl, eps, \
                                    s);
  switch ((C + 31) / 32) {
    CB_FUSED(1) CB_FUSED(2) CB_FUSED(3)
    CB_FUSED(4) CB_FUSED(5) CB_FUSED(6)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CB_FUSED
}

template <int CONS, int NB>
int launch_p2(const CUtensorMap& h_map, const CUtensorMap& w2_map,
              const CUtensorMap& x_map, const float* b2, const float* gamma,
              bf16* y, long long P, int C, const int* pl, cudaStream_t s) {
  auto kernel = p2_kernel<CONS, NB>;
  int err = allow_smem<p2_kernel<CONS, NB>>();
  if (err) return err;
  const dim3 grid((unsigned)cdiv(P, 64 * CONS), (unsigned)cdiv(C, 64 * NB));
  const int smem = p2_smem(64 * CONS, 64 * NB, pl[PL_STAGES2]);
  kernel<<<grid, CONS * WG + 32, smem, s>>>(
      h_map, w2_map, x_map, b2, gamma, y, P, C, pl[PL_STAGES2]);
  return (int)cudaGetLastError();
}

// a bf16 map with the 128-byte swizzle: rows x cols, boxes box_rows x 64
int bf16_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
             uint32_t box_rows) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(base), rows, cols, box_rows, PIECE,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool EXACT>
int launch_bf16(const float* sums, const float* ln_s, const float* ln_b,
                const void* w1, const float* b1, const void* w2,
                const float* b2, const float* gamma, const void* x, void* h,
                void* y, long long P, int C, const int* pl, float eps,
                cudaStream_t s) {
  bf16* yb = static_cast<bf16*>(y);
  CUtensorMap w1_map, w2_map, x_map;
  int rc = bf16_map(&w1_map, w1, 4ULL * C, C, PIECE);
  if (!rc) rc = bf16_map(&w2_map, w2, C, 4ULL * C, PIECE);
  // the residual x: boxes of a block's rows on the fused route, 64 rows on
  // the split route's second product
  if (!rc) rc = bf16_map(&x_map, x, P, C, pl[PL_ROUTE] == 0 ? pl[PL_M1] : 64);
  if (rc) return rc;
  if (pl[PL_ROUTE] == 0)
    return launch_fused<EXACT>(w1_map, w2_map, x_map, sums, ln_s, ln_b, b1,
                               b2, gamma, yb, P, C, pl, eps, s);
  bf16* hb = static_cast<bf16*>(h);
#define CB_SPLIT(CONS, WIDE)                                               \
  launch_mlp<CONS, 0, EXACT, WIDE>(w1_map, w2_map, x_map, sums, ln_s,     \
                                   ln_b, b1, b2, gamma, hb, P, C, pl, eps, \
                                   s)
  if (C > 512)
    rc = pl[PL_M1] == 128 ? CB_SPLIT(2, true) : CB_SPLIT(1, true);
  else
    rc = pl[PL_M1] == 128 ? CB_SPLIT(2, false) : CB_SPLIT(1, false);
#undef CB_SPLIT
  if (rc) return rc;
  CUtensorMap h_map, w2p_map;
  rc = bf16_map(&h_map, hb, P, 4ULL * C, pl[PL_M2]);
  if (!rc) rc = bf16_map(&w2p_map, w2, C, 4ULL * C, pl[PL_N2]);
  if (rc) return rc;
#define CB_P2(CONS, NB) \
  launch_p2<CONS, NB>(h_map, w2p_map, x_map, b2, gamma, yb, P, C, pl, s)
  if (pl[PL_M2] == 128)
    return pl[PL_N2] == 64 ? CB_P2(2, 1) : CB_P2(2, 2);
  return pl[PL_N2] == 64 ? CB_P2(1, 1) : CB_P2(1, 2);
#undef CB_P2
}

template <int TM, int NQ, int EPI, bool EXACT>
int launch_gemm_f32(const float* A, const float* Wt, const float* bias,
                    const float* gamma, const float* res, const float* ln_s,
                    const float* ln_b, float* Y, long long M, int N, int K,
                    float eps, cudaStream_t s) {
  auto kernel = gemm_f32_kernel<TM, NQ, EPI, EXACT>;
  int err = allow_smem<gemm_f32_kernel<TM, NQ, EPI, EXACT>>();
  if (err) return err;
  const dim3 grid((unsigned)cdiv(M, TM), (unsigned)cdiv(N, 16 * NQ));
  kernel<<<grid, 2 * TM, f32_smem(TM, 16 * NQ, EPI == 0), s>>>(
      A, Wt, bias, gamma, res, ln_s, ln_b, Y, M, N, K, eps);
  return (int)cudaGetLastError();
}

// one fp32 product with the tile (m, n) of the plan
template <int EPI, bool EXACT>
int launch_product_f32(int m, int n, const float* A, const float* Wt,
                       const float* bias, const float* gamma,
                       const float* res, const float* ln_s, const float* ln_b,
                       float* Y, long long M, int N, int K, float eps,
                       cudaStream_t s) {
#define CB_F32(TM, NQ)                                                     \
  launch_gemm_f32<TM, NQ, EPI, EXACT>(A, Wt, bias, gamma, res, ln_s, ln_b, \
                                      Y, M, N, K, eps, s)
  if (m == 128) return n == 128 ? CB_F32(128, 8) : CB_F32(128, 4);
  return n == 128 ? CB_F32(64, 8) : CB_F32(64, 4);
#undef CB_F32
}

template <bool EXACT>
int launch_f32(const float* sums, const float* ln_s, const float* ln_b,
               const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const float* x, float* h,
               float* y, long long P, int C, const int* pl, float eps,
               cudaStream_t s) {
  const int err = launch_product_f32<0, EXACT>(
      pl[PL_M1], pl[PL_N1], sums, w1, b1, nullptr, nullptr, ln_s, ln_b, h, P,
      4 * C, C, eps, s);
  if (err) return err;
  return launch_product_f32<1, false>(pl[PL_M2], pl[PL_N2], h, w2, b2, gamma,
                                      x, nullptr, nullptr, y, P, C, 4 * C,
                                      eps, s);
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16 (T below).
// x, y (B,H,W,C) of T; taps (7,7,C), b_dw, ln_s, ln_b (C,), b1 (4C,), b2,
// gamma (C,) float32; w1 (4C,C), w2 (C,4C) of T; scratch: sums (B,H,W,C)
// float32, h (B,H,W,4C) of T on the split route (null on the fused one).
// All contiguous and 16-byte aligned, C a multiple of the vector width (4
// fp32, 8 bf16). exact_gelu: 1 = erf, 0 = tanh. plan: PL_LEN ints from
// ops/convnext_block.py `plan`; a plan this entry cannot run (or a shape it
// does not take) returns cudaErrorInvalidValue before any launch. Launches
// two kernels (the fused route) or three on `stream` and returns the first
// error that is not 0 (0 = ok).
extern "C" int convnext_block_forward(
    const void* x, const void* taps, const void* b_dw, const void* ln_s,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* gamma, void* sums, void* h, void* y, int B,
    int H, int W, int C, int dtype, int exact_gelu, float eps,
    const int* plan, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || !plan)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (C % (dtype == 1 ? Vec<bf16>::N : Vec<float>::N))
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)B * H * W;
  if (!plan_ok(plan, P, C, dtype)) return (int)cudaErrorInvalidValue;
  if (plan[PL_ROUTE] == 1 && !h) return (int)cudaErrorInvalidValue;
  const float* f_lns = static_cast<const float*>(ln_s);
  const float* f_lnb = static_cast<const float*>(ln_b);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_gamma = static_cast<const float*>(gamma);
  float* f_sums = static_cast<float*>(sums);
  int err = dtype == 1
      ? dw7x7::launch<bf16, float, float>(x, taps, b_dw, sums, B, H, W, C, s)
      : dw7x7::launch<float, float, float>(x, taps, b_dw, sums, B, H, W, C, s);
  if (err) return err;
  if (dtype == 1)
    return exact_gelu
        ? launch_bf16<true>(f_sums, f_lns, f_lnb, w1, f_b1, w2, f_b2, f_gamma,
                            x, h, y, P, C, plan, eps, s)
        : launch_bf16<false>(f_sums, f_lns, f_lnb, w1, f_b1, w2, f_b2,
                             f_gamma, x, h, y, P, C, plan, eps, s);
  const float* fx = static_cast<const float*>(x);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fw2 = static_cast<const float*>(w2);
  return exact_gelu
      ? launch_f32<true>(f_sums, f_lns, f_lnb, fw1, f_b1, fw2, f_b2, f_gamma,
                         fx, static_cast<float*>(h), static_cast<float*>(y), P,
                         C, plan, eps, s)
      : launch_f32<false>(f_sums, f_lns, f_lnb, fw1, f_b1, fw2, f_b2, f_gamma,
                          fx, static_cast<float*>(h), static_cast<float*>(y),
                          P, C, plan, eps, s);
}

extern "C" const char* convnext_block_error_string(int err) {
  if (err >= ENCODE_ERR) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
