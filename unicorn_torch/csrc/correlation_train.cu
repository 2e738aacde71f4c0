// Correlation label propagation for TRAINING on Hopper (sm_90a): the forward
// that also emits the column logsumexp, and the two backward passes.
//
// Replaces the three TPU kernels behind `correlation_propagate_pallas_vjp`
// (unicorn_tpu/ops/pallas_correlation.py:277), which the uni-stage training
// step reaches through `build_sot_priors`:
//   `_corr_fwd_lse_kernel` (:156)  -> correlation_fwd_lse
//   `_corr_bwd_i_kernel`   (:191)  -> correlation_bwd_i
//   `_corr_bwd_j_kernel`   (:231)  -> correlation_bwd_j
//
// What they compute, for e0, e1 (B,N,C) and v (B,K,N), all float32, with
// S[i,j] = e0[i,:] . e1[j,:] (i a source pixel, j a target pixel):
//   forward  out[k,j] = sum_i v[k,i] softmax_i(S[i,j]),
//            lse[j]   = log sum_i exp(S[i,j])
//   backward P = exp(S - lse), dP[i,j] = sum_k v[k,i] dO[k,j],
//            dS = P * (dP - c[j])   with c[j] = sum_k out[k,j] dO[k,j]
//            (taken outside, as the JAX package takes it),
//   bwd_i    dE0[i,:] = sum_j dS[i,j] e1[j,:],  dV[k,i] = sum_j P[i,j] dO[k,j]
//   bwd_j    dE1[j,:] = sum_i dS[i,j] e0[i,:]
// Every product is an fp32 FMA with an fp32 sum, as the TPU kernels cast all
// of their inputs to fp32; the N x N matrices S, P and dS never reach device
// memory. All three kernels form S with the same FMAs in the same channel
// order, and both backward kernels read the lse the forward wrote, so their
// P is the same bit for bit.
//
// The TPU grids pad N to the block sizes and carry their sums in VMEM from
// one grid step to the next along a sequential axis. On this card blocks run
// in no order, so a block owns TO = 128 rows of the axis whose result it
// writes (target rows for the forward and bwd_j, source rows for bwd_i) and
// loops over the other axis itself: no atomics, and the same bits on every
// run. Nothing is padded: a streamed source row i >= N gets P = 0, a streamed
// target row j >= N adds nothing, and no row >= N is written.
//
// Bound on an H100 SXM at the training shape (N = 16000, C = 128, K = 1),
// per sample: forward 2*N*N*(C+K) = 66 GFLOP, bwd_i 2*N*N*(2C+2K) = 133
// GFLOP, bwd_j 2*N*N*(2C+K) = 132 GFLOP, at 67 TFLOP/s of fp32 outside the
// tensor cores; the 16 to 25 MB each kernel moves take under 0.01 ms at
// 3.35 TB/s. Operations bound all three; the N*N exponentials ride on the
// special function units beside them. chip_smoke.py recomputes the bounds
// from the shapes it runs.
//
// Design, shared by the three kernels. A block owns 128 rows (its e rows and
// per-row vectors loaded once with cp.async) and streams the other side's
// rows in half tiles of TH = 64 through a ring of three shared-memory slots
// filled with cp.async, so that the next tile's halves land while this tile
// is computed. A tile is two halves (128 streamed rows). Each of the 256
// threads (a 16 x 16 grid) holds an 8 x 8 register tile of scores: own rows
// to + 16 r against streamed rows ts + 16 q, read as float4 along C from
// row-major tiles of stride C + 4 (the interleaved rows keep the lanes of a
// quarter-warp on distinct banks). Exponentials are ex2 of base-2 arguments.
// A second product over the streamed rows (dE0 in bwd_i, dE1 in bwd_j)
// takes dS through a 128 x 64 shared tile one half at a time (a 128 x 128
// tile beside the ring would not fit in 227 KB), its odd rows xor-swizzled
// by 16 columns so the two half-warps of a warp use distinct banks, into
// an 8 x 8 register tile of own rows to + 16 r at channels 4 ts + 64 qc +
// (0..3). One block an SM with up to 255 registers a thread; the tensor
// cores are not used (TF32 would not be the TPU kernels' fp32).
//   fwd_lse  own e1 rows; streams e0 and v. Online softmax in base 2: the
//            row maximum of the tile (one xor-shuffle reduction over the 16
//            lanes of a row), one rescale per 128-row tile, P = ex2(S log2 e
//            - m); the lane's share of the denominator and, for K = 1, of
//            P . v stay in registers and are summed over the 16 lanes once,
//            at the end. For K > 1 the tile's P goes through the shared tile
//            and lane ts takes label map ts (16 maps of 8 rows would not fit
//            in registers beside the scores).
//   bwd_i    own e0 rows and v; streams e1, lse, c and dO. dV's share stays
//            in registers for K = 1 and is summed into shared memory for
//            K > 1.
//   bwd_j    own e1 rows, dO, lse and c; streams e0 and v. P, dP and dS stay
//            in registers; there is no dV.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 16;                  // the thread grid is G x G
constexpr int TO = 128;                // own rows a block
constexpr int TH = 64;                 // streamed rows a half tile
constexpr int RO = TO / G;             // own rows a thread (8)
constexpr int RQ = 2 * TH / G;         // streamed rows a thread (8: 4 a half)
constexpr int SLOTS = 3;               // ring of half tiles
constexpr int KMAX = 16;               // label maps per call
constexpr int CMAX = 128;              // embedding width
constexpr int PAD = 4;                 // floats of padding per tile row
constexpr int VLD = TH + PAD;          // row stride of the forward's v in a slot
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_SMEM = 232448;       // 227 KB, the most a block may ask for
constexpr unsigned FULL = 0xffffffffu;

// sum over the 16 lanes that share `to` (xor offsets below 16 stay inside
// the half-warp); every lane gets the sum
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// asynchronous copies into shared memory; ok = false writes zeros
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows r0 .. r0+ROWS of src (N, C) into a row-major tile of stride C + PAD:
// warp w copies rows w, w + 8, ..., lane l the l-th 16 bytes of each (C is
// at most 128 = 32 lanes x 4 floats, and no thread divides by C)
template <int ROWS>
__device__ __forceinline__ void async_rows(const float* __restrict__ src,
                                           int r0, int N, int C, float* dst,
                                           int tid) {
  const int c = 4 * (tid % 32);
  if (c >= C) return;
  for (int r = tid / 32; r < ROWS; r += THREADS / 32) {
    const bool ok = r0 + r < N;
    cp16(dst + r * (C + PAD) + c, ok ? src + (size_t)(r0 + r) * C + c : src,
         ok);
  }
}

// src[r0 .. r0+len] into dst, zero beyond N
__device__ __forceinline__ void async_vec(const float* __restrict__ src,
                                          int r0, int N, int len, float* dst,
                                          int tid) {
  for (int idx = tid; idx < len; idx += THREADS) {
    const bool ok = r0 + idx < N;
    cp4(dst + idx, ok ? src + r0 + idx : src, ok);
  }
}

// p[r][q] = own row (to + G r) . streamed row (ts + G (q % 4)) of half q / 4:
// fp32 FMAs in channel order. h0, h1: the two halves' rows (stride C + PAD).
__device__ __forceinline__ void score_tile(const float* own, const float* h0,
                                           const float* h1, int C, int to,
                                           int ts, float (&p)[RO][RQ]) {
  const int ld = C + PAD;
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int q = 0; q < RQ; ++q) p[r][q] = 0.f;
  const float* a_p = own + to * ld;
  const float* b_p[2] = {h0 + ts * ld, h1 + ts * ld};
#pragma unroll 1
  for (int c = 0; c < C; c += 4) {
    float4 a[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r)
      a[r] = *reinterpret_cast<const float4*>(a_p + r * G * ld + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 bq[RQ / 2];
#pragma unroll
      for (int q = 0; q < RQ / 2; ++q)
        bq[q] = *reinterpret_cast<const float4*>(b_p[h] + q * G * ld + c);
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int q = 0; q < RQ / 2; ++q) {
          float x = p[r][4 * h + q];
          x = fmaf(a[r].x, bq[q].x, x);
          x = fmaf(a[r].y, bq[q].y, x);
          x = fmaf(a[r].z, bq[q].z, x);
          x = fmaf(a[r].w, bq[q].w, x);
          p[r][4 * h + q] = x;
        }
    }
  }
}

// half h of the thread's 8 x 8 tile into the shared [TO][TH] tile, odd rows
// xor-swizzled by 16 columns (swz)
__device__ __forceinline__ void park_half(float* tile, const float (&p)[RO][RQ],
                                          int h, int to, int ts, int swz) {
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int q = 0; q < RQ / 2; ++q)
      tile[(to + G * r) * TH + ((ts + G * q) ^ swz)] = p[r][4 * h + q];
}

// acc[r][4 qc + x] += sum over the TH rows j of a half: tile[to + G r][j] *
// rows[j][4 ts + 64 qc + x]. Channels at or beyond C are computed from
// whatever follows the rows in their slot (never past its end) and not
// stored: no branch in the loop.
template <int CQ>
__device__ __forceinline__ void ds_product(const float* tile,
                                           const float* rows, int ld, int to,
                                           int ts, int swz,
                                           float (&acc)[RO][4 * CQ]) {
  const float* e = rows + 4 * ts;
#pragma unroll 2
  for (int j = 0; j < TH; j += 4) {
    float4 d4[RO], ev[4][CQ];
#pragma unroll
    for (int r = 0; r < RO; ++r)
      d4[r] = *reinterpret_cast<const float4*>(tile + (to + G * r) * TH + (j ^ swz));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int qc = 0; qc < CQ; ++qc)
        ev[jj][qc] = *reinterpret_cast<const float4*>(e + (j + jj) * ld + 64 * qc);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int qc = 0; qc < CQ; ++qc) {
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          const float d = jj == 0 ? d4[r].x
                        : jj == 1 ? d4[r].y
                        : jj == 2 ? d4[r].z : d4[r].w;
          acc[r][4 * qc + 0] = fmaf(d, ev[jj][qc].x, acc[r][4 * qc + 0]);
          acc[r][4 * qc + 1] = fmaf(d, ev[jj][qc].y, acc[r][4 * qc + 1]);
          acc[r][4 * qc + 2] = fmaf(d, ev[jj][qc].z, acc[r][4 * qc + 2]);
          acc[r][4 * qc + 3] = fmaf(d, ev[jj][qc].w, acc[r][4 * qc + 3]);
        }
      }
    }
  }
}

// the own rows' accumulators, channels 4 ts + 64 qc + (0..3), rows < N
template <int CQ>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[RO][4 * CQ],
                                           int o0, int N, int C, int to,
                                           int ts) {
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int o = o0 + to + G * r;
#pragma unroll
    for (int qc = 0; qc < CQ; ++qc) {
      const int cc = 4 * ts + 64 * qc;
      if (o < N && cc < C)
        *reinterpret_cast<float4*>(dst + (size_t)o * C + cc) =
            make_float4(acc[r][4 * qc], acc[r][4 * qc + 1], acc[r][4 * qc + 2],
                        acc[r][4 * qc + 3]);
    }
  }
}

// ---------------------------------------------------------------- forward
// grid: x = tiles of TO target rows, y = batch. KT = 1: P . v in registers;
// KT = KMAX: through the shared tile, label map ts on lane ts.
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
fwd_lse_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int N, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                           // e1 rows, [TO][ld]
  float* psm = own + TO * ld;                  // KT > 1: a P half, [TO][TH]
  float* ring = psm + (KT > 1 ? TO * TH : 0);
  const int slot_floats = TH * ld + K * VLD;
  // slot: e0 rows [TH][ld], then v [K][VLD]

  const int tid = threadIdx.x;
  const int to = tid / G, ts = tid % G;
  const int swz = (to & 1) << 4;               // P column swizzle of my rows
  const int o0 = blockIdx.x * TO;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  out += b * K * N;
  lse += b * N;

  auto load_half = [&](int h) {
    float* d = ring + (h % SLOTS) * slot_floats;
    const int i = h * TH;
    async_rows<TH>(e0, i, N, C, d, tid);
    for (int k = 0; k < K; ++k)
      async_vec(v + (size_t)k * N, i, N, TH, d + TH * ld + k * VLD, tid);
    cp_commit();
  };

  async_rows<TO>(e1, o0, N, C, own, tid);
  cp_commit();
  const int ntiles = (N + 2 * TH - 1) / (2 * TH);
  load_half(0);
  load_half(1);
  cp_wait_all();
  __syncthreads();

  // per own row: the running maximum of S log2 e (the same on the row's 16
  // lanes), this lane's share of the denominator, and of P . v (KT = 1) or
  // the whole of P . v for label map ts (KT > 1), all scaled by 2^-m
  float m[RO], l[RO], acc[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
    acc[r] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const float* hs[2] = {ring + ((2 * t) % SLOTS) * slot_floats,
                          ring + ((2 * t + 1) % SLOTS) * slot_floats};
    if (t + 1 < ntiles) load_half(2 * t + 2);

    float p[RO][RQ];
    score_tile(own, hs[0], hs[1], C, to, ts, p);
    float vq[RQ];
    bool inside[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const int sl = ts + G * (q % 4);
      inside[q] = (2 * t + q / 4) * TH + sl < N;
      vq[q] = KT == 1 ? hs[q / 4][TH * ld + sl] : 0.f;
    }
    if (KT == 1) {
      __syncthreads();     // the first half's slot is free
      if (t + 1 < ntiles) load_half(2 * t + 3);
    }

    // online softmax in base 2: one rescale per tile; source rows >= N out
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      float tmax = NEG;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        if (!inside[q]) p[r][q] = NEG;
        tmax = fmaxf(tmax, p[r][q]);
      }
      const float m_new = fmaxf(m[r], max16(tmax) * LOG2E);
      const float alpha = ex2(m[r] - m_new);
      l[r] *= alpha;
      acc[r] *= alpha;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float x = ex2(fmaf(p[r][q], LOG2E, -m_new));
        l[r] += x;
        if (KT == 1) acc[r] = fmaf(x, vq[q], acc[r]);
        p[r][q] = x;
      }
      m[r] = m_new;
    }

    if (KT > 1) {
      // acc[r] += sum over the tile's source rows i of P[to + G r][i] *
      // v[ts][i], one half at a time through the shared tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        park_half(psm, p, h, to, ts, swz);
        __syncthreads();
        if (ts < K) {
          const float* vk = hs[h] + TH * ld + ts * VLD;
#pragma unroll 4
          for (int i = 0; i < TH; i += 4) {
            const float4 w = *reinterpret_cast<const float4*>(vk + i);
#pragma unroll
            for (int r = 0; r < RO; ++r) {
              const float4 d = *reinterpret_cast<const float4*>(
                  psm + (to + G * r) * TH + (i ^ swz));
              acc[r] = fmaf(d.x, w.x, acc[r]);
              acc[r] = fmaf(d.y, w.y, acc[r]);
              acc[r] = fmaf(d.z, w.z, acc[r]);
              acc[r] = fmaf(d.w, w.w, acc[r]);
            }
          }
        }
        __syncthreads();   // psm, and after h = 0 the first half's slot, free
        if (h == 0 && t + 1 < ntiles) load_half(2 * t + 3);
      }
    }
    cp_wait_all();         // the next tile's halves have landed
    __syncthreads();       // for every thread; this tile's slots free
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const float lsum = sum16(l[r]);
    const int j = o0 + to + G * r;
    if (KT == 1) {
      const float a = sum16(acc[r]);
      if (ts == 0 && j < N) out[j] = a / lsum;
    } else if (ts < K && j < N) {
      out[(size_t)ts * N + j] = acc[r] / lsum;
    }
    if (ts == 0 && j < N) lse[j] = fmaf(m[r], LN2, logf(lsum));
  }
}

// ------------------------------------------------------------------ bwd_j
// grid: x = tiles of TO target rows, y = batch. CQ = ceil(C / 64).
template <int KT, int CQ>
__global__ void __launch_bounds__(THREADS, 1)
bwd_j_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
             const float* __restrict__ v, const float* __restrict__ lse,
             const float* __restrict__ dout, const float* __restrict__ cvec,
             float* __restrict__ de1, int N, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                           // e1 rows, [TO][ld]
  float* dos = own + TO * ld;                  // dO of the own rows, [K][TO]
  float* lses = dos + K * TO;                  // lse of the own rows, [TO]
  float* cs = lses + TO;                       // c of the own rows, [TO]
  float* dsm = cs + TO;                        // a dS half, [TO][TH], swizzled
  float* ring = dsm + TO * TH;
  const int slot_floats = TH * ld + K * TH;
  // slot: e0 rows [TH][ld], then v [K][TH]

  const int tid = threadIdx.x;
  const int to = tid / G, ts = tid % G;
  const int swz = (to & 1) << 4;               // dS column swizzle of my rows
  const int o0 = blockIdx.x * TO;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  lse += b * N;
  dout += b * K * N;
  cvec += b * N;
  de1 += b * N * C;

  auto load_half = [&](int h) {
    float* d = ring + (h % SLOTS) * slot_floats;
    const int i = h * TH;
    async_rows<TH>(e0, i, N, C, d, tid);
    for (int k = 0; k < K; ++k)
      async_vec(v + (size_t)k * N, i, N, TH, d + TH * ld + k * TH, tid);
    cp_commit();
  };

  async_rows<TO>(e1, o0, N, C, own, tid);
  for (int k = 0; k < K; ++k)
    async_vec(dout + (size_t)k * N, o0, N, TO, dos + k * TO, tid);
  async_vec(lse, o0, N, TO, lses, tid);
  async_vec(cvec, o0, N, TO, cs, tid);
  cp_commit();
  const int ntiles = (N + 2 * TH - 1) / (2 * TH);
  load_half(0);
  load_half(1);
  cp_wait_all();
  __syncthreads();

  float acc[RO][4 * CQ];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int x = 0; x < 4 * CQ; ++x) acc[r][x] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const float* hs[2] = {ring + ((2 * t) % SLOTS) * slot_floats,
                          ring + ((2 * t + 1) % SLOTS) * slot_floats};
    if (t + 1 < ntiles) load_half(2 * t + 2);

    // scores: p[r][q] of own row to + G r, source row ts + G (q % 4) of half
    // q / 4; then P = exp(S - lse[j]) in place (0 for sources i >= N)
    float p[RO][RQ];
    score_tile(own, hs[0], hs[1], C, to, ts, p);
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float lr = lses[to + G * r];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const bool inside = (2 * t + q / 4) * TH + ts + G * (q % 4) < N;
        p[r][q] = inside ? ex2((p[r][q] - lr) * LOG2E) : 0.f;
      }
    }
    // dS = P (dP - c[j]) in place, dP[i][j] = sum_k v[k][i] dO[k][j]
    if (KT == 1) {
      float vq[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q)
        vq[q] = hs[q / 4][TH * ld + ts + G * (q % 4)];
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float dr = dos[to + G * r], cr = cs[to + G * r];
#pragma unroll
        for (int q = 0; q < RQ; ++q) p[r][q] *= fmaf(dr, vq[q], -cr);
      }
    } else {
      float dp[RO][RQ];
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int q = 0; q < RQ; ++q) dp[r][q] = 0.f;
      for (int k = 0; k < K; ++k) {
        float dk[RO], vk[RQ];
#pragma unroll
        for (int r = 0; r < RO; ++r) dk[r] = dos[k * TO + to + G * r];
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          vk[q] = hs[q / 4][TH * ld + k * TH + ts + G * (q % 4)];
#pragma unroll
        for (int r = 0; r < RO; ++r)
#pragma unroll
          for (int q = 0; q < RQ; ++q) dp[r][q] = fmaf(dk[r], vk[q], dp[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float cr = cs[to + G * r];
#pragma unroll
        for (int q = 0; q < RQ; ++q) p[r][q] *= dp[r][q] - cr;
      }
    }

    // dE1 += dS . e0, one half at a time through the shared dS tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      park_half(dsm, p, h, to, ts, swz);
      __syncthreads();
      ds_product<CQ>(dsm, hs[h], ld, to, ts, swz, acc);
      if (h == 0) {
        __syncthreads();   // dsm and the first half's slot are free
        if (t + 1 < ntiles) load_half(2 * t + 3);
      }
    }
    cp_wait_all();         // the next tile's halves have landed
    __syncthreads();       // for every thread; dsm and this tile's slots free
  }
  store_rows<CQ>(de1, acc, o0, N, C, to, ts);
}

// ------------------------------------------------------------------ bwd_i
// grid: x = tiles of TO source rows, y = batch. KT = 1: dV's share in
// registers; KT = KMAX: reduced into shared memory after each tile. CQ =
// ceil(C / 64).
template <int KT, int CQ>
__global__ void __launch_bounds__(THREADS, 1)
bwd_i_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
             const float* __restrict__ v, const float* __restrict__ lse,
             const float* __restrict__ dout, const float* __restrict__ cvec,
             float* __restrict__ de0, float* __restrict__ dv, int N, int C,
             int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                           // e0 rows, [TO][ld]
  float* vs = own + TO * ld;                   // v of the own rows, [K][TO]
  float* dvs = vs + K * TO;                    // dV (KT > 1), [K][TO]
  float* dsm = dvs + (KT > 1 ? K * TO : 0);    // a dS half, [TO][TH], swizzled
  float* ring = dsm + TO * TH;
  const int slot_floats = TH * ld + (K + 2) * TH;
  // slot: e1 rows [TH][ld], then lse [TH], c [TH], dO [K][TH]

  const int tid = threadIdx.x;
  const int to = tid / G, ts = tid % G;
  const int swz = (to & 1) << 4;               // dS column swizzle of my rows
  const int o0 = blockIdx.x * TO;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  lse += b * N;
  dout += b * K * N;
  cvec += b * N;
  de0 += b * N * C;
  dv += b * K * N;

  auto load_half = [&](int h) {
    float* d = ring + (h % SLOTS) * slot_floats;
    const int j = h * TH;
    async_rows<TH>(e1, j, N, C, d, tid);
    d += TH * ld;
    async_vec(lse, j, N, TH, d, tid);
    async_vec(cvec, j, N, TH, d + TH, tid);
    for (int k = 0; k < K; ++k)
      async_vec(dout + (size_t)k * N, j, N, TH, d + (2 + k) * TH, tid);
    cp_commit();
  };

  async_rows<TO>(e0, o0, N, C, own, tid);
  for (int k = 0; k < K; ++k)
    async_vec(v + (size_t)k * N, o0, N, TO, vs + k * TO, tid);
  cp_commit();
  if (KT > 1)
    for (int idx = tid; idx < K * TO; idx += THREADS) dvs[idx] = 0.f;
  const int ntiles = (N + 2 * TH - 1) / (2 * TH);
  load_half(0);
  load_half(1);
  cp_wait_all();
  __syncthreads();

  float acc[RO][4 * CQ];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int x = 0; x < 4 * CQ; ++x) acc[r][x] = 0.f;
  float dvp[RO];                       // KT = 1: dV's share of my rows
#pragma unroll
  for (int r = 0; r < RO; ++r) dvp[r] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const float* hs[2] = {ring + ((2 * t) % SLOTS) * slot_floats,
                          ring + ((2 * t + 1) % SLOTS) * slot_floats};
    if (t + 1 < ntiles) load_half(2 * t + 2);

    // scores: p[r][q] of own row to + G r, target row ts + G (q % 4) of
    // half q / 4
    float p[RO][RQ];
    score_tile(own, hs[0], hs[1], C, to, ts, p);

    // P = exp(S - lse[j]) (0 for targets j >= N), dV's share, dS in place
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      const float* vec = hs[q / 4] + TH * ld;        // lse, c, dO of the half
      const int sl = ts + G * (q % 4);
      const bool inside = (2 * t + q / 4) * TH + sl < N;
      const float lq = vec[sl];
#pragma unroll
      for (int r = 0; r < RO; ++r)
        p[r][q] = inside ? ex2((p[r][q] - lq) * LOG2E) : 0.f;
    }
    // dV[k][i] += sum_j P[i][j] dO[k][j], and dS = P (dP - c[j]) in place
    // with dP[i][j] = sum_k v[k][i] dO[k][j]
    if (KT == 1) {
      float cq[RQ], dq[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float* vec = hs[q / 4] + TH * ld + ts + G * (q % 4);
        cq[q] = vec[TH];
        dq[q] = vec[2 * TH];
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float vr = vs[to + G * r];
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          dvp[r] = fmaf(p[r][q], dq[q], dvp[r]);
          p[r][q] *= fmaf(vr, dq[q], -cq[q]);
        }
      }
    } else {
      // dV: a lane's 8 terms, the sum over the 16 lanes of the row, added
      // to shared memory by lane ts == r
      for (int k = 0; k < K; ++k) {
        float dq[RQ];
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          dq[q] = hs[q / 4][TH * ld + (2 + k) * TH + ts + G * (q % 4)];
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          float x = 0.f;
#pragma unroll
          for (int q = 0; q < RQ; ++q) x = fmaf(p[r][q], dq[q], x);
          x = sum16(x);
          if (ts == r) dvs[k * TO + to + G * r] += x;
        }
      }
      float dp[RO][RQ];
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int q = 0; q < RQ; ++q) dp[r][q] = 0.f;
      for (int k = 0; k < K; ++k) {
        float vk[RO], dq[RQ];
#pragma unroll
        for (int r = 0; r < RO; ++r) vk[r] = vs[k * TO + to + G * r];
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          dq[q] = hs[q / 4][TH * ld + (2 + k) * TH + ts + G * (q % 4)];
#pragma unroll
        for (int r = 0; r < RO; ++r)
#pragma unroll
          for (int q = 0; q < RQ; ++q) dp[r][q] = fmaf(vk[r], dq[q], dp[r][q]);
      }
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float cq = hs[q / 4][TH * ld + TH + ts + G * (q % 4)];
#pragma unroll
        for (int r = 0; r < RO; ++r) p[r][q] *= dp[r][q] - cq;
      }
    }

    // dE0 += dS . e1, one half at a time through the shared dS tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      park_half(dsm, p, h, to, ts, swz);
      __syncthreads();
      ds_product<CQ>(dsm, hs[h], ld, to, ts, swz, acc);
      if (h == 0) {
        __syncthreads();   // dsm and the first half's slot are free
        if (t + 1 < ntiles) load_half(2 * t + 3);
      }
    }
    cp_wait_all();         // the next tile's halves have landed
    __syncthreads();       // for every thread; dsm and this tile's slots free
  }

  store_rows<CQ>(de0, acc, o0, N, C, to, ts);
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int o = o0 + to + G * r;
    if (KT == 1) {
      const float a = sum16(dvp[r]);
      if (ts == 0 && o < N) dv[o] = a;
    }
  }
  if (KT > 1)
    for (int idx = tid; idx < K * TO; idx += THREADS) {
      const int o = o0 + idx % TO;
      if (o < N) dv[(size_t)(idx / TO) * N + o] = dvs[idx];
    }
}

// ------------------------------------------------------------------ launch
// shared memory of each kernel, in floats: own rows, per-row vectors, the
// shared P or dS half, and the ring
inline size_t fwd_smem(int C, int K, bool p_shared) {
  return ((size_t)TO * (C + PAD) + (p_shared ? (size_t)TO * TH : 0) +
          (size_t)SLOTS * (TH * (C + PAD) + K * VLD)) * sizeof(float);
}

inline size_t bwd_j_smem(int C, int K) {
  return ((size_t)TO * (C + PAD) + (size_t)(K + 2) * TO + (size_t)TO * TH +
          (size_t)SLOTS * (TH * (C + PAD) + K * TH)) * sizeof(float);
}

inline size_t bwd_i_smem(int C, int K, bool dv_shared) {
  return ((size_t)TO * (C + PAD) + (size_t)(dv_shared ? 2 : 1) * K * TO +
          (size_t)TO * TH + (size_t)SLOTS * (TH * (C + PAD) + (K + 2) * TH)) *
         sizeof(float);
}

inline bool bad_shape(int B, int N, int C, int K) {
  return B <= 0 || B > 65535 || N <= 0 || C <= 0 || C % 4 || C > CMAX ||
         K <= 0 || K > KMAX;
}

// set the kernel's shared-memory size and launch it on a grid of TO-row
// tiles by batch
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, size_t smem, int B, int N, cudaStream_t s,
                 Args... args) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TO - 1) / TO, B);
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. All tensors contiguous float32, 16-byte
// aligned: e0, e1, de0, de1 (B,N,C); v, out, dout, dv (B,K,N); lse, c
// (B,1,N). Any N >= 1; C a multiple of 4 up to 128; 1 <= K <= 16. Each
// function launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int correlation_fwd_lse(const void* e0, const void* e1,
                                   const void* v, void* out, void* lse, int B,
                                   int N, int C, int K, void* stream) {
  if (bad_shape(B, N, C, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(e0);
  const float* a1 = static_cast<const float*>(e1);
  const float* a2 = static_cast<const float*>(v);
  float* o0 = static_cast<float*>(out);
  float* o1 = static_cast<float*>(lse);
  return K == 1
      ? launch_tiles(fwd_lse_kernel<1>, fwd_smem(C, K, false), B, N, s, a0, a1,
                     a2, o0, o1, N, C, K)
      : launch_tiles(fwd_lse_kernel<KMAX>, fwd_smem(C, K, true), B, N, s, a0,
                     a1, a2, o0, o1, N, C, K);
}

extern "C" int correlation_bwd_i(const void* e0, const void* e1, const void* v,
                                 const void* lse, const void* dout,
                                 const void* c, void* de0, void* dv, int B,
                                 int N, int C, int K, void* stream) {
  if (bad_shape(B, N, C, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(e0);
  const float* a1 = static_cast<const float*>(e1);
  const float* a2 = static_cast<const float*>(v);
  const float* a3 = static_cast<const float*>(lse);
  const float* a4 = static_cast<const float*>(dout);
  const float* a5 = static_cast<const float*>(c);
  float* o0 = static_cast<float*>(de0);
  float* o1 = static_cast<float*>(dv);
  const size_t smem = bwd_i_smem(C, K, K > 1);
  if (K == 1)
    return C <= 64
        ? launch_tiles(bwd_i_kernel<1, 1>, smem, B, N, s, a0, a1, a2, a3, a4,
                       a5, o0, o1, N, C, K)
        : launch_tiles(bwd_i_kernel<1, 2>, smem, B, N, s, a0, a1, a2, a3, a4,
                       a5, o0, o1, N, C, K);
  return C <= 64
      ? launch_tiles(bwd_i_kernel<KMAX, 1>, smem, B, N, s, a0, a1, a2, a3, a4,
                     a5, o0, o1, N, C, K)
      : launch_tiles(bwd_i_kernel<KMAX, 2>, smem, B, N, s, a0, a1, a2, a3, a4,
                     a5, o0, o1, N, C, K);
}

extern "C" int correlation_bwd_j(const void* e0, const void* e1, const void* v,
                                 const void* lse, const void* dout,
                                 const void* c, void* de1, int B, int N, int C,
                                 int K, void* stream) {
  if (bad_shape(B, N, C, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(e0);
  const float* a1 = static_cast<const float*>(e1);
  const float* a2 = static_cast<const float*>(v);
  const float* a3 = static_cast<const float*>(lse);
  const float* a4 = static_cast<const float*>(dout);
  const float* a5 = static_cast<const float*>(c);
  float* o0 = static_cast<float*>(de1);
  const size_t smem = bwd_j_smem(C, K);
  if (K == 1)
    return C <= 64
        ? launch_tiles(bwd_j_kernel<1, 1>, smem, B, N, s, a0, a1, a2, a3, a4,
                       a5, o0, N, C, K)
        : launch_tiles(bwd_j_kernel<1, 2>, smem, B, N, s, a0, a1, a2, a3, a4,
                       a5, o0, N, C, K);
  return C <= 64
      ? launch_tiles(bwd_j_kernel<KMAX, 1>, smem, B, N, s, a0, a1, a2, a3, a4,
                     a5, o0, N, C, K)
      : launch_tiles(bwd_j_kernel<KMAX, 2>, smem, B, N, s, a0, a1, a2, a3, a4,
                     a5, o0, N, C, K);
}

extern "C" const char* correlation_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
