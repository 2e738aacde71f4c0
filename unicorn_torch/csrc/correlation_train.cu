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
// Design (simple and right first). 256 threads form a 16 x 16 grid. The
// block's own tile and the streamed tile lie row-major in shared memory with
// a row stride of C + 4 floats. Thread (to, ts) computes the 4 x 4 scores of
// own rows to + 16 r against streamed rows ts + 16 q with float4 reads along
// C: the interleaved rows keep the 16 lanes of a half-warp on distinct
// banks. The forward then runs the online softmax on those registers (the
// column maximum is one xor-shuffle reduction over the 16 lanes; the
// denominators and numerators stay per lane and are reduced once, after the
// last tile). The backward kernels turn the scores into dS in registers,
// park the 64 x 64 dS tile in shared memory and take the second product
// dS . streamed tile into a 4 x (C/16) register tile per thread. Loads are
// not overlapped with compute and the tensor cores are not used (TF32 would
// not be the TPU kernels' fp32): both are for the change that makes these
// fast.

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

// --------------------------------------------------------------- backward
// grid: x = tiles of T own rows, y = batch. OWN_I: the block owns source
// rows (e0) and streams target columns (e1), writing dE0 and dV; else it
// owns target columns (e1) and streams source rows (e0), writing dE1.
// CQ = ceil(C / 64): a thread keeps channels 4 ts + 64 qc + (0..3). With one
// label map the registers are held to 128, so that two blocks share an SM.
template <bool OWN_I, int KT, int CQ>
__global__ void __launch_bounds__(THREADS, KT == 1 ? 2 : 1)
bwd_kernel(const float* __restrict__ e0, const float* __restrict__ e1,
           const float* __restrict__ v, const float* __restrict__ lse,
           const float* __restrict__ dout, const float* __restrict__ cvec,
           float* __restrict__ d_own, float* __restrict__ dv, int N, int C,
           int K) {
  extern __shared__ __align__(16) float smem[];
  const int ld = C + PAD;
  float* own = smem;                  // the block's tile
  float* str = own + T * ld;          // the streamed tile
  float* ds = str + T * ld;           // dS, [own row][streamed row]
  float* vs = ds + T * DLD;           // v of the tile's source rows, K x T
  float* dos = vs + K * T;            // dO of the tile's target columns, K x T
  float* lses = dos + K * T;          // lse of the target columns
  float* cs = lses + T;               // c of the target columns

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
  d_own += b * N * C;
  if (OWN_I) dv += b * K * N;
  const float* own_src = OWN_I ? e0 : e1;
  const float* str_src = OWN_I ? e1 : e0;

  load_rows(own_src, o0, N, C, own, tid);
  if (OWN_I) {
    load_vecs(v, o0, N, K, vs, tid);
  } else {
    load_vecs(dout, o0, N, K, dos, tid);
    load_vecs(lse, o0, N, 1, lses, tid);
    load_vecs(cvec, o0, N, 1, cs, tid);
  }

  float acc[R][4 * CQ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int x = 0; x < 4 * CQ; ++x) acc[r][x] = 0.f;
  float dvp[KT][R];                   // OWN_I: this lane's share of dV
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) dvp[k][r] = 0.f;

  for (int s0 = 0; s0 < N; s0 += T) {
    __syncthreads();   // the tiles before have been read to their end
    load_rows(str_src, s0, N, C, str, tid);
    if (OWN_I) {
      load_vecs(dout, s0, N, K, dos, tid);
      load_vecs(lse, s0, N, 1, lses, tid);
      load_vecs(cvec, s0, N, 1, cs, tid);
    } else {
      load_vecs(v, s0, N, K, vs, tid);
    }
    __syncthreads();

    // scores -> P, in place: p[r][q] of own row to + G r, streamed row
    // ts + G q
    float p[R][R];
    score_tile(own, str, C, to, ts, p);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int ol = to + G * r, sl = ts + G * q;
        const int jl = OWN_I ? sl : ol;
        const bool inside = (o0 + ol < N) && (s0 + sl < N);
        p[r][q] = inside ? expf(p[r][q] - lses[jl]) : 0.f;
      }

    // dP[i][j] = sum_k v[k][i] dO[k][j]; dV's share of this tile
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
          vo[r] = (OWN_I ? vs : dos)[k * T + to + G * r];
          vq[r] = (OWN_I ? dos : vs)[k * T + ts + G * r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) {
            dp[r][q] = fmaf(vo[r], vq[q], dp[r][q]);
            if (OWN_I) dvp[k][r] = fmaf(p[r][q], vq[q], dvp[k][r]);
          }
      }
    }

    // dS = P * (dP - c[j]) into shared memory
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int ol = to + G * r, sl = ts + G * q;
        const float cj = cs[OWN_I ? sl : ol];
        ds[ol * DLD + sl] = p[r][q] * (dp[r][q] - cj);
      }
    __syncthreads();

    // acc[own row][channel] += sum over streamed rows dS * streamed tile
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
        *reinterpret_cast<float4*>(d_own + (size_t)o * C + cc) =
            make_float4(acc[r][4 * qc], acc[r][4 * qc + 1], acc[r][4 * qc + 2],
                        acc[r][4 * qc + 3]);
    }
    if (OWN_I) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k < K) {
          const float a = sum16(dvp[k][r]);
          if (ts == 0 && o < N) dv[(size_t)k * N + o] = a;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
inline size_t fwd_smem(int C, int K) {
  return ((size_t)2 * T * (C + PAD) + (size_t)K * T) * sizeof(float);
}

inline size_t bwd_smem(int C, int K) {
  return ((size_t)2 * T * (C + PAD) + (size_t)T * DLD + (size_t)2 * K * T +
          2 * T) * sizeof(float);
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

template <bool OWN_I, int KT, int CQ>
int launch_bwd(const float* e0, const float* e1, const float* v,
               const float* lse, const float* dout, const float* c,
               float* d_own, float* dv, int B, int N, int C, int K,
               cudaStream_t s) {
  const size_t smem = bwd_smem(C, K);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<OWN_I, KT, CQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + T - 1) / T, B);
  bwd_kernel<OWN_I, KT, CQ><<<grid, THREADS, smem, s>>>(
      e0, e1, v, lse, dout, c, d_own, dv, N, C, K);
  return (int)cudaGetLastError();
}

template <bool OWN_I>
int dispatch_bwd(const void* e0, const void* e1, const void* v, const void* lse,
                 const void* dout, const void* c, void* d_own, void* dv, int B,
                 int N, int C, int K, void* stream) {
  if (bad_shape(B, N, C, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(e0);
  const float* a1 = static_cast<const float*>(e1);
  const float* a2 = static_cast<const float*>(v);
  const float* a3 = static_cast<const float*>(lse);
  const float* a4 = static_cast<const float*>(dout);
  const float* a5 = static_cast<const float*>(c);
  float* o0 = static_cast<float*>(d_own);
  float* o1 = static_cast<float*>(dv);
  if (K == 1)
    return C <= 64
        ? launch_bwd<OWN_I, 1, 1>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s)
        : launch_bwd<OWN_I, 1, 2>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s);
  return C <= 64
      ? launch_bwd<OWN_I, KMAX, 1>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s)
      : launch_bwd<OWN_I, KMAX, 2>(a0, a1, a2, a3, a4, a5, o0, o1, B, N, C, K, s);
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
  return dispatch_bwd<true>(e0, e1, v, lse, dout, c, de0, dv, B, N, C, K,
                            stream);
}

extern "C" int correlation_bwd_j(const void* e0, const void* e1, const void* v,
                                 const void* lse, const void* dout,
                                 const void* c, void* de1, int B, int N, int C,
                                 int K, void* stream) {
  return dispatch_bwd<false>(e0, e1, v, lse, dout, c, de1, nullptr, B, N, C, K,
                             stream);
}

extern "C" const char* correlation_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
