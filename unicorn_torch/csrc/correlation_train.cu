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
// memory. Both backward kernels read the lse the forward wrote, so their P
// is the forward's softmax bit for bit.
//
// The TPU grids pad N to the block sizes and carry their sums in VMEM from
// one grid step to the next along a sequential axis. On this card blocks run
// in no order, so a block owns one tile of T = 64 rows of the axis whose
// result it writes (target columns for the forward and bwd_j, source rows
// for bwd_i) and loops over the other axis itself: no atomics, and the same
// bits on every run. Nothing is padded: a source row i >= N is masked to
// -1e30 before the exponential (P = 0 there), a target column j >= N adds
// nothing, and neither is written.
//
// Bound on an H100 SXM at the training shape (N = 16000, C = 128, K = 1),
// per sample: forward 2*N*N*(C+K) = 66 GFLOP, bwd_i 2*N*N*(2C+2K) = 133
// GFLOP, bwd_j 2*N*N*(2C+K) = 132 GFLOP, at 67 TFLOP/s of fp32 outside the
// tensor cores; the 16 to 25 MB each kernel moves take under 0.01 ms at
// 3.35 TB/s. Operations bound all three; the N*N exponentials ride on the
// special function units beside them. chip_smoke.py recomputes the bounds
// from the shapes it runs.
//
// Design of fwd_lse and bwd_j (simple and right first). 256 threads form a
// 16 x 16 grid. The block's own tile and the streamed tile lie row-major in
// shared memory with a row stride of C + 4 floats. Thread (to, ts) computes
// the 4 x 4 scores of own rows to + 16 r against streamed rows ts + 16 q
// with float4 reads along C: the interleaved rows keep the 16 lanes of a
// half-warp on distinct banks. The forward then runs the online softmax on
// those registers (the column maximum is one xor-shuffle reduction over the
// 16 lanes; the denominators and numerators stay per lane and are reduced
// once, after the last tile). bwd_j turns the scores into dS in registers,
// parks the 64 x 64 dS tile in shared memory and takes the second product
// dS . streamed tile into a 4 x (C/16) register tile per thread. Their loads
// are not overlapped with compute.
//
// Design of bwd_i (bwd_i_kernel). A block owns 128 source rows (e0 and v
// loaded once) and streams e1, dO, lse and c in half tiles of 64 target
// rows through a ring of three shared-memory slots filled with cp.async, so
// that the next tile's two halves land while this tile is computed; it
// halves the streaming of e1 from L2 against 64-row blocks. A tile is two
// halves (128 target rows). Each of the 256 threads (a 16 x 16 grid) holds
// an 8 x 8 register tile in both products: the scores of own rows to + 16 r
// against target rows ts + 16 q, and dE0 of own rows to + 16 r at channels
// 4 ts + 64 qc + (0..3). P = exp2((S - lse) log2 e), dP, dS and dV's share
// stay in registers; dS goes through a 128 x 64 shared tile one half at a
// time (a 128 x 128 tile beside the ring would not fit in 227 KB), its rows
// xor-swizzled so the two half-warps of a warp read distinct banks. One
// block an SM with up to 255 registers a thread; every product stays an
// fp32 FMA, and the tensor cores are not used (TF32 would not be the TPU
// kernels' fp32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;                  // rows of a tile, own and streamed
constexpr int THREADS = 256;
constexpr int G = 16;                  // the thread grid is G x G
constexpr int R = T / G;               // own rows, and streamed rows, per thread
constexpr int KMAX = 16;               // label maps per call
constexpr int CMAX = 128;              // embedding width
constexpr int PAD = 4;                 // floats of padding per tile row
constexpr int DLD = T + PAD;           // row stride of the dS tile
constexpr float NEG = -1e30f;
constexpr int MAX_SMEM = 232448;       // 227 KB, the most a block may ask for
constexpr unsigned FULL = 0xffffffffu;

// rows r0 .. r0+T of src (N, C) into a row-major tile of stride C + PAD,
// zero beyond row N
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int r0,
                                          int N, int C, float* dst, int tid) {
  const int c4n = C / 4;
  const int ld = C + PAD;
  for (int idx = tid; idx < T * c4n; idx += THREADS) {
    const int r = idx / c4n, c4 = idx % c4n;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N)
      q = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * C) + c4);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c4) = q;
  }
}

// K vectors of T entries: dst[k*T + r] = src[k*N + r0 + r], zero beyond N
__device__ __forceinline__ void load_vecs(const float* __restrict__ src, int r0,
                                          int N, int K, float* dst, int tid) {
  for (int idx = tid; idx < K * T; idx += THREADS) {
    const int k = idx / T, r = idx % T;
    dst[idx] = (r0 + r < N) ? __ldg(src + (size_t)k * N + r0 + r) : 0.f;
  }
}

// s[r][q] = own row (to + G r) . streamed row (ts + G q)
__device__ __forceinline__ void score_tile(const float* own, const float* str,
                                           int C, int to, int ts,
                                           float (&s)[R][R]) {
  const int ld = C + PAD;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < R; ++q) s[r][q] = 0.f;
  const float* a_p = own + to * ld;
  const float* b_p = str + ts * ld;
#pragma unroll 2
  for (int c = 0; c < C; c += 4) {
    float4 a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[r] = *reinterpret_cast<const float4*>(a_p + r * G * ld + c);
#pragma unroll
    for (int q = 0; q < R; ++q)
      b[q] = *reinterpret_cast<const float4*>(b_p + q * G * ld + c);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float t = s[r][q];
        t = fmaf(a[r].x, b[q].x, t);
        t = fmaf(a[r].y, b[q].y, t);
        t = fmaf(a[r].z, b[q].z, t);
        t = fmaf(a[r].w, b[q].w, t);
        s[r][q] = t;
      }
  }
}

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

// ---------------------------------------------------------------- forward
// grid: x = tiles of T target columns, y = batch. The block owns e1 rows
// j0 .. j0+T and streams e0.
template <int KT>
__global__ void __launch_bounds__(THREADS)
fwd_lse_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int N, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                  // e1 tile
  float* str = own + T * ld;          // e0 tile
  float* vs = str + T * ld;           // v of the streamed rows, K x T

  const int tid = threadIdx.x;
  const int to = tid / G, ts = tid % G;
  const int j0 = blockIdx.x * T;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  out += b * K * N;
  lse += b * N;

  load_rows(e1, j0, N, C, own, tid);

  float m[R], l[R], acc[KT][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k][r] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += T) {
    __syncthreads();   // the tile before has been read to its end
    load_rows(e0, i0, N, C, str, tid);
    load_vecs(v, i0, N, K, vs, tid);
    __syncthreads();

    float s[R][R];
    score_tile(own, str, C, to, ts, s);

    // online softmax of column (to + G r) over this lane's 4 source rows;
    // the running maximum is shared by the 16 lanes of the column
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float tmax = NEG;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (i0 + ts + G * q >= N) s[r][q] = NEG;
        tmax = fmaxf(tmax, s[r][q]);
      }
      tmax = max16(tmax);
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k][r] *= alpha;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float p = expf(s[r][q] - m_new);
        l[r] += p;
#pragma unroll
        for (int k = 0; k < KT; ++k)
          if (k < K) acc[k][r] = fmaf(vs[k * T + ts + G * q], p, acc[k][r]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lsum = sum16(l[r]);
    const int j = j0 + to + G * r;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        const float a = sum16(acc[k][r]);
        if (ts == 0 && j < N) out[(size_t)k * N + j] = a / lsum;
      }
    }
    if (ts == 0 && j < N) lse[j] = m[r] + logf(lsum);
  }
}

// ------------------------------------------------------------------ bwd_j
// grid: x = tiles of T target columns, y = batch. The block owns e1 rows
// and streams e0, writing dE1. CQ = ceil(C / 64): a thread keeps channels
// 4 ts + 64 qc + (0..3). With one label map the registers are held to 128,
// so that two blocks share an SM.
template <int KT, int CQ>
__global__ void __launch_bounds__(THREADS, KT == 1 ? 2 : 1)
bwd_j_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
             const float* __restrict__ v, const float* __restrict__ lse,
             const float* __restrict__ dout, const float* __restrict__ cvec,
             float* __restrict__ de1, int N, int C, int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                  // the block's e1 tile
  float* str = own + T * ld;          // the streamed e0 tile
  float* ds = str + T * ld;           // dS, [own column][streamed row]
  float* vs = ds + T * DLD;           // v of the tile's source rows, K x T
  float* dos = vs + K * T;            // dO of the own columns, K x T
  float* lses = dos + K * T;          // lse of the own columns
  float* cs = lses + T;               // c of the own columns

  const int tid = threadIdx.x;
  const int to = tid / G, ts = tid % G;
  const int o0 = blockIdx.x * T;
  const size_t b = blockIdx.y;
  e0 += b * N * C;
  e1 += b * N * C;
  v += b * K * N;
  lse += b * N;
  dout += b * K * N;
  cvec += b * N;
  de1 += b * N * C;

  load_rows(e1, o0, N, C, own, tid);
  load_vecs(dout, o0, N, K, dos, tid);
  load_vecs(lse, o0, N, 1, lses, tid);
  load_vecs(cvec, o0, N, 1, cs, tid);

  float acc[R][4 * CQ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int x = 0; x < 4 * CQ; ++x) acc[r][x] = 0.f;

  for (int s0 = 0; s0 < N; s0 += T) {
    __syncthreads();   // the tiles before have been read to their end
    load_rows(e0, s0, N, C, str, tid);
    load_vecs(v, s0, N, K, vs, tid);
    __syncthreads();

    // scores -> P, in place: p[r][q] of own column to + G r, streamed row
    // ts + G q
    float p[R][R];
    score_tile(own, str, C, to, ts, p);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int ol = to + G * r, sl = ts + G * q;
        const bool inside = (o0 + ol < N) && (s0 + sl < N);
        p[r][q] = inside ? expf(p[r][q] - lses[ol]) : 0.f;
      }

    // dP[i][j] = sum_k v[k][i] dO[k][j]
    float dp[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) dp[r][q] = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k < K) {
        float vo[R], vq[R];           // the k-th factor of own and streamed rows
#pragma unroll
        for (int r = 0; r < R; ++r) {
          vo[r] = dos[k * T + to + G * r];
          vq[r] = vs[k * T + ts + G * r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) dp[r][q] = fmaf(vo[r], vq[q], dp[r][q]);
      }
    }

    // dS = P * (dP - c[j]) into shared memory
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int ol = to + G * r, sl = ts + G * q;
        ds[ol * DLD + sl] = p[r][q] * (dp[r][q] - cs[ol]);
      }
    __syncthreads();

    // acc[own column][channel] += sum over streamed rows dS * streamed tile
    for (int j = 0; j < T; j += 4) {
      float4 d4[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        d4[r] = *reinterpret_cast<const float4*>(ds + (to + G * r) * DLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int qc = 0; qc < CQ; ++qc) {
          const int cc = 4 * ts + 64 * qc;
          if (cc < C) {
            const float4 e =
                *reinterpret_cast<const float4*>(str + (j + jj) * ld + cc);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float d = jj == 0 ? d4[r].x
                            : jj == 1 ? d4[r].y
                            : jj == 2 ? d4[r].z : d4[r].w;
              acc[r][4 * qc + 0] = fmaf(d, e.x, acc[r][4 * qc + 0]);
              acc[r][4 * qc + 1] = fmaf(d, e.y, acc[r][4 * qc + 1]);
              acc[r][4 * qc + 2] = fmaf(d, e.z, acc[r][4 * qc + 2]);
              acc[r][4 * qc + 3] = fmaf(d, e.w, acc[r][4 * qc + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = o0 + to + G * r;
#pragma unroll
    for (int qc = 0; qc < CQ; ++qc) {
      const int cc = 4 * ts + 64 * qc;
      if (o < N && cc < C)
        *reinterpret_cast<float4*>(de1 + (size_t)o * C + cc) =
            make_float4(acc[r][4 * qc], acc[r][4 * qc + 1], acc[r][4 * qc + 2],
                        acc[r][4 * qc + 3]);
    }
  }
}

// ------------------------------------------------------------------ bwd_i
constexpr int TO = 128;                // own source rows a block
constexpr int TH = 64;                 // target rows a streamed half tile
constexpr int RO = TO / G;             // own rows a thread (8)
constexpr int RQ = 2 * TH / G;         // target rows a thread (8: 4 a half)
constexpr int SLOTS = 3;               // ring of half tiles
constexpr float LOG2E = 1.4426950408889634f;

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

// rows r0 .. r0+ROWS of src (N, C) into a row-major tile of stride C + PAD
template <int ROWS>
__device__ __forceinline__ void async_rows(const float* __restrict__ src,
                                           int r0, int N, int C, float* dst,
                                           int tid) {
  const int c4n = C / 4;
  for (int idx = tid; idx < ROWS * c4n; idx += THREADS) {
    const int r = idx / c4n, c4 = idx % c4n;
    const bool ok = r0 + r < N;
    cp16(dst + r * (C + PAD) + 4 * c4,
         ok ? src + (size_t)(r0 + r) * C + 4 * c4 : src, ok);
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
#pragma unroll
    for (int r = 0; r < RO; ++r)
#pragma unroll
      for (int q = 0; q < RQ; ++q) p[r][q] = 0.f;
    {
      const float* a_p = own + to * ld;
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
            bq[q] = *reinterpret_cast<const float4*>(hs[h] + (ts + G * q) * ld + c);
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
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int q = 0; q < RQ / 2; ++q)
          dsm[(to + G * r) * TH + ((ts + G * q) ^ swz)] = p[r][4 * h + q];
      __syncthreads();
      // channels at or beyond C are computed from whatever follows in the
      // slot (never past its end) and not stored: no branch in the loop
      const float* e = hs[h] + 4 * ts;
#pragma unroll 2
      for (int j = 0; j < TH; j += 4) {
        float4 d4[RO], ev[4][CQ];
#pragma unroll
        for (int r = 0; r < RO; ++r)
          d4[r] = *reinterpret_cast<const float4*>(dsm + (to + G * r) * TH + (j ^ swz));
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
      if (h == 0) {
        __syncthreads();   // dsm and the first half's slot are free
        if (t + 1 < ntiles) load_half(2 * t + 3);
      }
    }
    cp_wait_all();         // the next tile's halves have landed
    __syncthreads();       // for every thread; dsm and this tile's slots free
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int o = o0 + to + G * r;
#pragma unroll
    for (int qc = 0; qc < CQ; ++qc) {
      const int cc = 4 * ts + 64 * qc;
      if (o < N && cc < C)
        *reinterpret_cast<float4*>(de0 + (size_t)o * C + cc) =
            make_float4(acc[r][4 * qc], acc[r][4 * qc + 1], acc[r][4 * qc + 2],
                        acc[r][4 * qc + 3]);
    }
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
inline size_t fwd_smem(int C, int K) {
  return ((size_t)2 * T * (C + PAD) + (size_t)K * T) * sizeof(float);
}

inline size_t bwd_j_smem(int C, int K) {
  return ((size_t)2 * T * (C + PAD) + (size_t)T * DLD + (size_t)2 * K * T +
          2 * T) * sizeof(float);
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

template <int KT>
int launch_fwd(const float* e0, const float* e1, const float* v, float* out,
               float* lse, int B, int N, int C, int K, cudaStream_t s) {
  const size_t smem = fwd_smem(C, K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_lse_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T - 1) / T, B);
  fwd_lse_kernel<KT><<<grid, THREADS, smem, s>>>(e0, e1, v, out, lse, N, C, K);
  return (int)cudaGetLastError();
}

template <int KT, int CQ>
int launch_bwd_j(const float* e0, const float* e1, const float* v,
                 const float* lse, const float* dout, const float* c,
                 float* de1, int B, int N, int C, int K, cudaStream_t s) {
  const size_t smem = bwd_j_smem(C, K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_j_kernel<KT, CQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T - 1) / T, B);
  bwd_j_kernel<KT, CQ><<<grid, THREADS, smem, s>>>(e0, e1, v, lse, dout, c,
                                                   de1, N, C, K);
  return (int)cudaGetLastError();
}

template <int KT, int CQ>
int launch_bwd_i(const float* e0, const float* e1, const float* v,
                 const float* lse, const float* dout, const float* c,
                 float* de0, float* dv, int B, int N, int C, int K,
                 cudaStream_t s) {
  const size_t smem = bwd_i_smem(C, K, KT > 1);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_i_kernel<KT, CQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TO - 1) / TO, B);
  bwd_i_kernel<KT, CQ><<<grid, THREADS, smem, s>>>(e0, e1, v, lse, dout, c,
                                                   de0, dv, N, C, K);
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
  return K == 1 ? launch_fwd<1>(a0, a1, a2, o0, o1, B, N, C, K, s)
                : launch_fwd<KMAX>(a0, a1, a2, o0, o1, B, N, C, K, s);
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
  if (K == 1)
    return C <= 64
        ? launch_bwd_i<1, 1>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s)
        : launch_bwd_i<1, 2>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s);
  return C <= 64
      ? launch_bwd_i<KMAX, 1>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s)
      : launch_bwd_i<KMAX, 2>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s);
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
  if (K == 1)
    return C <= 64
        ? launch_bwd_j<1, 1>(a0, a1, a2, a3, a4, a5, o0, B, N, C, K, s)
        : launch_bwd_j<1, 2>(a0, a1, a2, a3, a4, a5, o0, B, N, C, K, s);
  return C <= 64
      ? launch_bwd_j<KMAX, 1>(a0, a1, a2, a3, a4, a5, o0, B, N, C, K, s)
      : launch_bwd_j<KMAX, 2>(a0, a1, a2, a3, a4, a5, o0, B, N, C, K, s);
}

extern "C" const char* correlation_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
