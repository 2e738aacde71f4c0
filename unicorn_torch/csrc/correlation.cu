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
// denominator, the v * p sum and the output are fp32 in both settings; P is
// never rounded to bf16.
//
// The TPU kernel's grid is (target blocks, source blocks) with the source
// axis sequential: the running max, denominator and numerator sit in VMEM
// scratch from one grid step to the next. On this card blocks run in no
// order and nothing carries between them, so a block owns a tile of target
// rows and loops over the source tiles itself.
//
// Bound on an H100 SXM at the served shape (N = 16000, C = 128, K = 1):
// 2*N*N*(C+K) = 66 GFLOP is 0.067 ms at 989 TFLOP/s in bf16 (0.99 ms at
// 67 TFLOP/s for the fp32 setting); the 16.5 MB of inputs and output are
// 0.005 ms at 3.35 TB/s. Operations bound it. Beside that bound, the
// N*N = 2.56e8 exponentials take about as long again on the special
// function units (16 a clock per SM), and with one label map they cannot
// hide behind a wide value product as they do in attention.
// chip_smoke.py recomputes the bound from the shapes it runs.
//
// Design of the bf16 route (three parts of one call):
// 1. prep_kernel writes bf16 copies of e0 and e1 once, C zero-padded to a
//    multiple of 64 (one 128-byte swizzle row; zero channels add exact
//    zeros to every score) and N to a multiple of 128 rows, and an fp32 copy
//    of v padded the same way, into a workspace the wrapper allocates. Each
//    block then streams bf16 that no block converts again: at the served
//    shape 125 blocks x 4.1 MB from L2, against 250 x 8.2 MB of fp32 before.
// 2. corr_tc_kernel: 2 consumer warpgroups and 1 producer warp a block.
//    The block owns 128 target rows (64 a consumer, the wgmma M). One
//    producer thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//    swizzle) of the block's e1 rows once and of e0 / v tiles of 128 source
//    rows into a ring of 3-4 stages guarded by full / empty mbarriers, so
//    loads run ahead of compute. TMA rather than cp.async: one thread moves
//    a whole tile, the hardware writes the swizzled layout wgmma reads, and
//    its writes and wgmma's reads are both in the async proxy, so no proxy
//    fence is needed. The tensor maps come from cuTensorMapEncodeTiled
//    through cudaGetDriverEntryPoint, so the build links no libcuda.
//    A consumer computes its 64 x 128 score tile S = e1 . e0^T with
//    wgmma.m64n128k16 (bf16 in, fp32 accumulator in registers, both operands
//    read from swizzled shared memory), then runs the online softmax on the
//    accumulator fragments: a row's maximum over its thread's 32 columns and
//    a quad shuffle, exp2 of scores pre-scaled by log2 e, the denominator
//    and the K numerators as fp32 FMAs against v staged as fp32 in shared
//    memory. The quad's partial sums are reduced once, after the last tile.
//    The two consumers of a block share each e0 tile and interleave on the
//    SM, so one's softmax runs while the other's product does. A consumer
//    that also overlapped its own softmax with its next product (two
//    accumulators, registers moved to it with setmaxnreg) was no faster:
//    the softmax alone takes longer than the products alone (PERF.md).
// 3. Filling the card: at B = 1, N = 16000 there are 250 tiles of 64 target
//    rows. Two consumers a block give 125 blocks on 132 SMs (7 idle, 5%);
//    one consumer a block with two blocks an SM fills the same 125 SMs and
//    streams e0 twice, and a split of the source axis recovers the 5% only
//    from about ten splits on (a merge pass and ten reloads of e1). So the
//    block keeps two consumers and the source axis whole.
// Source rows i >= N (zero padding) are masked to -1e30 before the
// exponential; target rows j >= N are computed and not written. One call of
// the op is two launches: prep_kernel and corr_tc_kernel.
//
// The fp32 route (bf16_dots = 0, no caller on a served path) is the plain
// FMA kernel: 256 threads own 64 target columns, e0 streams in k-major fp32
// tiles of 128 rows, each thread an 8 x 4 register tile of scores; four
// threads per column run the online softmax over 32 rows each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_wgmma.cuh"   // mbarriers, TMA loads, wgmma, tensor maps

namespace {

constexpr int KMAX = 16;               // label maps per call
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ================================================================ bf16 route
constexpr int WG = 128;                // threads of a warpgroup
constexpr int CONSUMERS = 2;           // consumer warpgroups a block
constexpr int ROWS_WG = 64;            // target rows a consumer (wgmma M)
constexpr int BJT = CONSUMERS * ROWS_WG;   // target rows a block
constexpr int BIT = 128;               // source rows a tile (wgmma N)
constexpr int TC_THREADS = CONSUMERS * WG + 32;   // + one producer warp
constexpr int CHUNK = 64;              // bf16 channels of one 128-byte row
constexpr int ROW_PAD = 128;           // N is padded to a multiple of this

static_assert(BJT == ROW_PAD && BIT == ROW_PAD, "one padding serves both tiles");

inline int pad_to(int x, int m) { return (x + m - 1) / m * m; }

inline size_t emb_bytes(int B, int Np, int Cp) {
  return (size_t)2 * B * Np * Cp * sizeof(__nv_bfloat16);
}

inline size_t workspace_bytes(int B, int N, int C, int K) {
  const int Np = pad_to(N, ROW_PAD);
  return emb_bytes(B, Np, pad_to(C, CHUNK)) + (size_t)B * K * Np * sizeof(float);
}

template <int NCH>
struct TcLayout {                      // the dynamic shared memory of a block
  static constexpr int STAGES = NCH == 3 ? 3 : 4;
  static constexpr int E1_BYTES = NCH * BJT * 128;   // NCH column chunks
  static constexpr int E0_BYTES = NCH * BIT * 128;   // one stage of e0
  static size_t bytes(int K) {
    return 1024 + E1_BYTES + (size_t)STAGES * (E0_BYTES + K * BIT * 4) +
           (2 * STAGES + 1) * sizeof(uint64_t);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// eb: 2*B*Np rows of Cp bf16 (e0's B*Np rows, then e1's); vp: B*K rows of
// Np fp32. Zero beyond N and C.
__global__ void prep_kernel(const float* __restrict__ e0,
                            const float* __restrict__ e1,
                            const float* __restrict__ v,
                            uint4* __restrict__ eb, float* __restrict__ vp,
                            int B, int N, int Np, int C, int Cp, int K) {
  const int g8 = Cp / 8;                              // 16-byte groups a row
  const size_t half = (size_t)B * Np;
  const size_t n_emb = 2 * half * g8;
  const size_t n_all = n_emb + (size_t)B * K * Np;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n_all;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_emb) {
      const size_t row = idx / g8;
      const int c = (int)(idx % g8) * 8;
      const float* src = row < half ? e0 : e1;
      const size_t r = row < half ? row : row - half;
      const size_t b = r / Np;
      const int n = (int)(r % Np);
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && c < C) {            // C % 16 == 0: all 8 channels exist
        const float4* s =
            reinterpret_cast<const float4*>(src + (b * N + n) * C + c);
        const float4 x = __ldg(s), y = __ldg(s + 1);
        q = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                       pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
      }
      eb[idx] = q;
    } else {
      const size_t i = idx - n_emb;
      const size_t bk = i / Np;
      const int n = (int)(i % Np);
      vp[i] = n < N ? __ldg(v + bk * N + n) : 0.f;
    }
  }
}

// grid: x = tiles of BJT target rows, y = batch. NCH = Cp / 64 column
// chunks; KT = 1 or KMAX label maps held in registers.
// Accumulator fragment of thread (warp w, lane l) of a consumer: d[4c + e]
// is row 16 w + l / 4 + 8 (e / 2), column 8 c + 2 (l % 4) + e % 2.
template <int NCH, int KT>
__global__ void __launch_bounds__(TC_THREADS, 1)
corr_tc_kernel(const __grid_constant__ CUtensorMap emb_map,
               const __grid_constant__ CUtensorMap v_map,
               float* __restrict__ out, int B, int N, int Np, int K) {
  using L = TcLayout<NCH>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* e1s = smem;                          // NCH x BJT x 128 B
  unsigned char* e0s = e1s + L::E1_BYTES;             // STAGES x E0_BYTES
  float* vs = reinterpret_cast<float*>(e0s + STAGES * L::E0_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * K * BIT);
  uint64_t* empty = full + STAGES;
  uint64_t* e1_bar = empty + STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * BJT;
  const int ntiles = Np / BIT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);            // one arrive a warp
    }
    mbar_init(e1_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * WG) {
    // ---- producer warp: one thread keeps the ring full
    if (tid == CONSUMERS * WG) {
      mbar_expect_tx(e1_bar, L::E1_BYTES);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load(e1s + ch * BJT * 128, &emb_map, ch * CHUNK, (B + b) * Np + j0,
                 e1_bar);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::E0_BYTES + K * BIT * 4);
        for (int ch = 0; ch < NCH; ++ch)
          tma_load(e0s + s * L::E0_BYTES + ch * BIT * 128, &emb_map,
                   ch * CHUNK, b * Np + t * BIT, &full[s]);
        tma_load(vs + s * K * BIT, &v_map, t * BIT, b * K, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: target rows j0 + 64 wg .. + 64
  const int wg = tid / WG;
  const int warp = (tid % WG) / 32, lane = tid % 32;
  const int cq = 2 * (lane % 4);                      // first column of a pair
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[2][KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[0][k] = acc[1][k] = 0.f;
  const uint64_t a_desc = sw128_desc(e1s + wg * ROWS_WG * 128);

  // the online softmax of tile t, whose scores are in d; frees its stage.
  // `last` (std::true_type in the last tile) masks rows >= N to NEG.
  auto softmax = [&](int t, auto last) {
    const int s = t % STAGES;
    const int valid = N - t * BIT - cq;  // columns of mine that exist
    auto sc = [&](int i) {               // score i of my fragment
      if constexpr (decltype(last)::value)
        return (8 * (i / 4) + i % 2 < valid) ? d[i] : NEG;
      else
        return d[i];
    };
    float mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = NEG;
#pragma unroll
      for (int c = 0; c < BIT / 8; ++c)
        tmax = fmaxf(tmax, fmaxf(sc(4 * c + 2 * h), sc(4 * c + 2 * h + 1)));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      const float alpha = ex2((m[h] - m_new) * LOG2E);
      l[h] *= alpha;
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[h][k] *= alpha;
      m[h] = m_new;
      mb[h] = m_new * LOG2E;
    }
    const float* vt = vs + s * K * BIT + cq;
#pragma unroll
    for (int c = 0; c < BIT / 8; ++c) {
      const float p00 = ex2(fmaf(sc(4 * c), LOG2E, -mb[0]));
      const float p01 = ex2(fmaf(sc(4 * c + 1), LOG2E, -mb[0]));
      const float p10 = ex2(fmaf(sc(4 * c + 2), LOG2E, -mb[1]));
      const float p11 = ex2(fmaf(sc(4 * c + 3), LOG2E, -mb[1]));
      l[0] += p00 + p01;
      l[1] += p10 + p11;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k < K) {
          const float2 vv = *reinterpret_cast<const float2*>(vt + k * BIT + 8 * c);
          acc[0][k] = fmaf(vv.y, p01, fmaf(vv.x, p00, acc[0][k]));
          acc[1][k] = fmaf(vv.y, p11, fmaf(vv.x, p10, acc[1][k]));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);            // this warp is done
  };

  mbar_wait(e1_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint64_t b_desc = sw128_desc(e0s + s * L::E0_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4 * NCH; ++ks) {
      // chunk ks / 4, 16 channels (32 bytes) further for each step inside it
      const int ch = ks / 4, kk = ks % 4;
      wgmma_m64n128k16(d, a_desc + ((ch * BJT * 128 + kk * 32) >> 4),
                       b_desc + ((ch * BIT * 128 + kk * 32) >> 4), ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if ((t + 1) * BIT > N) softmax(t, std::true_type{});
    else softmax(t, std::false_type{});
  }

  // the quad's partial sums (its lanes share the row's running max)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        acc[h][k] += __shfl_xor_sync(0xffffffffu, acc[h][k], 1);
        acc[h][k] += __shfl_xor_sync(0xffffffffu, acc[h][k], 2);
      }
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + wg * ROWS_WG + warp * 16 + lane / 4 + 8 * h;
      if (j < N) {
#pragma unroll
        for (int k = 0; k < KT; ++k)
          if (k < K) out[((size_t)b * K + k) * N + j] = acc[h][k] / l[h];
      }
    }
  }
}

template <int NCH, int KT>
int launch_tc(const float* e0, const float* e1, const float* v, float* out,
              void* ws, int B, int N, int C, int K, cudaStream_t s) {
  using L = TcLayout<NCH>;
  const int Np = pad_to(N, ROW_PAD), Cp = NCH * CHUNK;
  uint4* eb = static_cast<uint4*>(ws);
  float* vp = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) +
                                       emb_bytes(B, Np, Cp));
  const size_t work = emb_bytes(B, Np, Cp) / 16 + (size_t)B * K * Np;
  const int blocks = (int)((work + 255) / 256 < 4096 ? (work + 255) / 256 : 4096);
  prep_kernel<<<blocks, 256, 0, s>>>(e0, e1, v, eb, vp, B, N, Np, C, Cp, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap emb_map, v_map;
  int rc = make_map(&emb_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, eb,
                    (uint64_t)2 * B * Np, Cp, ROW_PAD, CHUNK,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = make_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vp,
                (uint64_t)B * K, Np, K, BIT, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc) return rc;

  const size_t smem = L::bytes(K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(corr_tc_kernel<NCH, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Np / BJT, B);
  corr_tc_kernel<NCH, KT><<<grid, TC_THREADS, smem, s>>>(emb_map, v_map, out,
                                                         B, N, Np, K);
  return (int)cudaGetLastError();
}

template <int KT>
int dispatch_tc(const float* e0, const float* e1, const float* v, float* out,
                void* ws, int B, int N, int C, int K, cudaStream_t s) {
  switch ((C + CHUNK - 1) / CHUNK) {
    case 1: return launch_tc<1, KT>(e0, e1, v, out, ws, B, N, C, K, s);
    case 2: return launch_tc<2, KT>(e0, e1, v, out, ws, B, N, C, K, s);
    case 3: return launch_tc<3, KT>(e0, e1, v, out, ws, B, N, C, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ================================================================ fp32 route
constexpr int BJ = 64;                 // target columns per block
constexpr int BI = 128;                // source rows per tile
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / BJ;    // threads per column
constexpr int ROWS = BI / PARTS;       // rows of a tile per thread
constexpr int SLD = BJ + 4;            // score tile row stride, floats
constexpr int TPAD = 4;                // k-major tile row padding

inline size_t fma_smem_bytes(int C, int K) {
  return (size_t)C * (BJ + TPAD) * 4 + (size_t)C * (BI + TPAD) * 4 +
         (size_t)BI * SLD * 4 + (size_t)K * BI * 4;
}

// rows r0 .. r0+R of src (N, C) into a k-major fp32 tile [c][r] of row
// stride R + TPAD, zero beyond row N
template <int R>
__device__ __forceinline__ void load_tile_kmajor(const float* __restrict__ src,
                                                 int r0, int N, int C,
                                                 float* dst, int tid) {
  const int c4n = C / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < R * c4n; idx += THREADS) {
    const int r = idx % R, c4 = idx / R;
    const float4 q = (r0 + r < N)
        ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * C) + c4)
        : zero;
    float* d = dst + (size_t)(c4 * 4) * (R + TPAD) + r;
    d[0] = q.x;
    d[R + TPAD] = q.y;
    d[2 * (R + TPAD)] = q.z;
    d[3 * (R + TPAD)] = q.w;
  }
}

// grid: x = tiles of BJ target columns, y = batch
template <int KT>
__global__ void __launch_bounds__(THREADS)
corr_fma_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
                const float* __restrict__ v, float* __restrict__ out, int N,
                int C, int K) {
  extern __shared__ __align__(16) float fsmem[];
  float* e1s = fsmem;                               // [C][BJ + TPAD]
  float* e0s = e1s + (size_t)C * (BJ + TPAD);       // [C][BI + TPAD]
  float* S = e0s + (size_t)C * (BI + TPAD);
  float* vs = S + BI * SLD;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BJ;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  out += b * K * N;

  load_tile_kmajor<BJ>(e1, j0, N, C, e1s, tid);

  const int col = tid % BJ;
  const int part = tid / BJ;
  float m_run = NEG, l_run = 0.f;
  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;

  for (int i0 = 0; i0 < N; i0 += BI) {
    __syncthreads();   // the tile before has been read to its end
    load_tile_kmajor<BI>(e0, i0, N, C, e0s, tid);
    for (int idx = tid; idx < K * BI; idx += THREADS) {
      const int k = idx / BI, r = idx % BI;
      vs[idx] = (i0 + r < N) ? __ldg(v + (size_t)k * N + i0 + r) : 0.f;
    }
    __syncthreads();

    // scores S[i][j] = e0[i0+i] . e1[j0+j], an 8 x 4 register tile a thread
    {
      const int ti = tid / 16, tj = tid % 16;   // rows 8*ti.., columns 4*tj..
      const float* a_t = e0s + 8 * ti;
      const float* b_t = e1s + 4 * tj;
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

template <int KT>
int launch_fma(const float* e0, const float* e1, const float* v, float* out,
               int B, int N, int C, int K, cudaStream_t s) {
  const size_t smem = fma_smem_bytes(C, K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      corr_fma_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BJ - 1) / BJ, B);
  corr_fma_kernel<KT><<<grid, THREADS, smem, s>>>(e0, e1, v, out, N, C, K);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int N, int C, int K) {
  return B <= 0 || B > 65535 || N <= 0 || C <= 0 || C % 16 || C > 3 * CHUNK ||
         K <= 0 || K > KMAX;
}

}  // namespace

// Plain C interface for ctypes. e0, e1 (B,N,C), v (B,K,N), out (B,K,N):
// contiguous float32, 16-byte aligned; any N >= 1; C a multiple of 16 up to
// 192; 1 <= K <= 16. bf16_dots: 1 = scores from bf16-rounded embeddings on
// the tensor cores, 0 = fp32 scores. `workspace`: device memory of
// correlation_workspace_bytes(...) bytes, 16-byte aligned (unused, and may
// be null, for fp32 scores). Launches on `stream` and returns 0 or an error
// code for correlation_error_string.
extern "C" size_t correlation_workspace_bytes(int B, int N, int C, int K,
                                              int bf16_dots) {
  if (bad_shape(B, N, C, K) || !bf16_dots) return 0;
  return workspace_bytes(B, N, C, K);
}

extern "C" int correlation_forward(const void* e0, const void* e1,
                                   const void* v, void* out, void* workspace,
                                   int B, int N, int C, int K, int bf16_dots,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_shape(B, N, C, K)) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(e0);
  const float* b = static_cast<const float*>(e1);
  const float* c = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (bf16_dots) {
    if (!workspace || reinterpret_cast<uintptr_t>(workspace) % 16)
      return (int)cudaErrorInvalidValue;
    return K == 1 ? dispatch_tc<1>(a, b, c, o, workspace, B, N, C, K, s)
                  : dispatch_tc<KMAX>(a, b, c, o, workspace, B, N, C, K, s);
  }
  return K == 1 ? launch_fma<1>(a, b, c, o, B, N, C, K, s)
                : launch_fma<KMAX>(a, b, c, o, B, N, C, K, s);
}

extern "C" const char* correlation_error_string(int err) {
  if (err >= ENCODE_ERR) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
