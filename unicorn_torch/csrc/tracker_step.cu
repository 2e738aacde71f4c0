// The device tracker's BYTE association step, one launch a frame, for
// Hopper (sm_90a): `tracker_step` of unicorn_torch/tracker/device_tracker.py
// on CUDA tensors.
//
// It replaces no Pallas kernel: the JAX tracker (unicorn_tpu/tracker/
// jax_tracker.py) is jnp code whose auctions are `lax.while_loop`s on the
// device. The plain PyTorch form (`tracker_step_plain`) issues several
// hundred small launches a frame and reads each auction's loop condition on
// the host between blocks of rounds; this kernel keeps every loop on the
// card, so a frame's step costs one launch and no host synchronisation.
//
// What it computes, per stream (one thread block a stream, the streams never
// mix), in the plain form's order:
//   1. Kalman predict of the tracked and lost slots (lost slots zero their
//      h-velocity first); unconfirmed slots keep their mean and covariance.
//   2. IoU (inclusive-pixel) of every live slot's predicted box against every
//      detection, into a global scratch row per slot (L2-resident).
//   3. Three auctions: activated-or-lost slots against high detections on
//      the fused cost 1 - iou * score (limit match_thresh); the remaining
//      tracked slots against low detections on 1 - iou (limit 0.5); the
//      unconfirmed slots against the high detections auction 1 left (fused
//      cost, limit 0.7).
//   4. The Kalman update of matched slots (a 4x4 fp32 system a slot), the
//      slot states (unmatched tracked -> lost, unmatched unconfirmed ->
//      removed, lost past max_time_lost -> removed), new tracks from the
//      unmatched strong detections placed in the free slots by prefix sums,
//      and the tracked-versus-lost de-duplication (IoU > 0.85, the younger is
//      dropped).
//
// Exactness. The auctions reproduce the plain form's matchings: each is a
// Jacobi auction (every unassigned row of the stream bids in a round, then
// each column takes its best bid), run inside the block until no row of the
// stream can bid, at most 20000 rounds (the plain form's max_iter; a round
// without a bidder changes nothing, so stopping per stream is the batched
// loop's result). A row's best column is the first maximum (a strict > scan
// in column order, reduced across the warp by (value, lowest index)); the
// second value includes "stay unassigned" (0); a column's winner is the
// first row with the highest bid, by atomicMax on a 64-bit key (the bid's
// bits, which order as unsigned integers since bids are positive, then the
// row's complement). A row whose best value is <= 0 never bids again (prices
// only rise), so it is skipped. The costs, IoUs, predicted means and
// covariances, the box conversions and the new tracks' Kalman initiation
// are the plain form's fp32 operations in its order, bit for bit: this file
// is built with --fmad=false (csrc/build.py), so no multiply-add is
// contracted, and divisions are IEEE. The update's solve and products
// differ from cuBLAS / cuSOLVER by fp32 rounding only.
//
// What bounds it: latency, not bytes or operations. A frame at S = 8,
// T = 256, D = 256 reads ~0.2 MB and does ~10 M simple operations, a few
// µs of the card's rates. Each auction round is two block barriers, a scan
// of the bidding rows' IoU rows from L2 and shared-memory atomics; the
// rounds run one after another, so the step costs the launch plus roughly
// (rounds x a round's latency) + the phases between them. On an H100 80GB
// HBM3 (700 W): 1.47 ms a frame over chip_smoke.py's crowded clip at S 8
// (31 objects a stream, ~227 rounds a stream in the first auction, ~6 us a
// round), against 335-368 ms for the plain form; 0.62 ms a tick, launch
// and synchronisation included, in the benchmark's mot.tiny.s8.
//
// Design. A block of 256 threads a stream. Detections, prices, owners, bid
// keys and the slot table live in shared memory (41 D + 44 T bytes, 21 KB at
// T = D = 256); means and covariances go straight to the output tensors,
// written by a slot's own thread in the predict and read back by it in the
// update. In the auctions a warp owns rows 32 at a time: a ballot picks its
// active rows, and the warp's lanes scan a row's columns together. Slots and
// detections are otherwise a thread each, strided over the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int NW = NT / 32;
constexpr int MAX_T = 1024, MAX_D = 1024;
constexpr int MAX_ITER = 20000;
constexpr float EPS = 2e-4f;
constexpr int S_EMPTY = 0, S_TRACKED = 1, S_LOST = 2;
constexpr unsigned FULL = 0xffffffffu;

// device_tracker.py's standard deviations, the Python floats rounded to fp32
// as PyTorch rounds a scalar operand
constexpr float STD_POS = (float)(1.0 / 20);
constexpr float STD_VEL = (float)(1.0 / 160);
constexpr float STD_POS2 = (float)(2 * (1.0 / 20));
constexpr float STD_VEL10 = (float)(10 * (1.0 / 160));

// detection flags
constexpr uint8_t F_HIGH = 1, F_LOW = 2, F_USED1 = 4, F_USED = 8,
                  F_NEW = 16;
// auction row status
constexpr uint8_t R_IDLE = 0, R_ACTIVE = 1, R_ASSIGNED = 2, R_DEAD = 3;

struct Args {
  // the TrackState in, in its field order
  const float* mean;          // (S, T, 8)
  const float* cov;           // (S, T, 8, 8)
  const int* state;           // (S, T)
  const uint8_t* activated;   // (S, T)
  const int* track_id;
  const float* score;
  const int* last_frame;
  const int* start_frame;
  const int* next_id;         // (S,)
  const int* frame_id;        // (S,)
  const float* dets;          // (S, D, 5)
  const uint8_t* det_valid;   // (S, D)
  // the TrackState out, the same layout
  float* o_mean;
  float* o_cov;
  int* o_state;
  uint8_t* o_activated;
  int* o_track_id;
  float* o_score;
  int* o_last;
  int* o_start;
  int* o_next_id;
  int* o_frame_id;
  float* out;                 // (S, T, 6)
  uint8_t* out_valid;         // (S, T)
  float* iou;                 // (S, T, D) scratch
  unsigned long long* rounds; // (3,) rounds run, summed over streams
  int T, D, max_time_lost;
  float track_thresh, match_thresh, det_thresh;
};
constexpr int N_PTRS = 26;

struct Smem {
  unsigned long long* key;                        // D
  float *dx1, *dy1, *dx2, *dy2, *dsc, *price;     // D
  int *owner, *rank;                              // D
  float *tx1, *ty1, *tx2, *ty2, *sscore;          // T
  int *match, *slast, *sstart, *sid, *free_slot;  // T
  uint8_t* dflag;                                 // D
  uint8_t *sstate, *sact, *rstat, *drop;          // T
};

__host__ __device__ size_t smem_bytes(int T, int D) {
  return 8 * (size_t)D + 4 * (8 * (size_t)D + 10 * (size_t)T) + D + 4 * T;
}

__device__ Smem carve(unsigned char* p, int T, int D) {
  Smem s;
  s.key = reinterpret_cast<unsigned long long*>(p);
  p += 8 * (size_t)D;
  float** fd[6] = {&s.dx1, &s.dy1, &s.dx2, &s.dy2, &s.dsc, &s.price};
  for (float** f : fd) { *f = reinterpret_cast<float*>(p); p += 4 * D; }
  int** id[2] = {&s.owner, &s.rank};
  for (int** f : id) { *f = reinterpret_cast<int*>(p); p += 4 * D; }
  float** ft[5] = {&s.tx1, &s.ty1, &s.tx2, &s.ty2, &s.sscore};
  for (float** f : ft) { *f = reinterpret_cast<float*>(p); p += 4 * T; }
  int** it[5] = {&s.match, &s.slast, &s.sstart, &s.sid, &s.free_slot};
  for (int** f : it) { *f = reinterpret_cast<int*>(p); p += 4 * T; }
  s.dflag = p;
  p += D;
  uint8_t** bt[4] = {&s.sstate, &s.sact, &s.rstat, &s.drop};
  for (uint8_t** f : bt) { *f = p; p += T; }
  return s;
}

// iou_xyxy(inclusive=True) of device_tracker.py, operation by operation
__device__ __forceinline__ float iou_incl(float ax1, float ay1, float ax2,
                                          float ay2, float bx1, float by1,
                                          float bx2, float by2) {
  const float iw = fmaxf((fminf(ax2, bx2) - fmaxf(ax1, bx1)) + 1.0f, 0.0f);
  const float ih = fmaxf((fminf(ay2, by2) - fmaxf(ay1, by1)) + 1.0f, 0.0f);
  const float inter = iw * ih;
  const float area_a = fmaxf((ax2 - ax1) + 1.0f, 0.0f) *
                       fmaxf((ay2 - ay1) + 1.0f, 0.0f);
  const float area_b = fmaxf((bx2 - bx1) + 1.0f, 0.0f) *
                       fmaxf((by2 - by1) + 1.0f, 0.0f);
  return inter / (((area_a + area_b) - inter) + 1e-9f);
}

// mean_to_tlbr: (cx, cy, a, h) -> (x1, y1, x2, y2)
__device__ __forceinline__ void tlbr(const float* m, float& x1, float& y1,
                                     float& x2, float& y2) {
  const float w = m[2] * m[3];
  x1 = m[0] - w / 2.0f;
  y1 = m[1] - m[3] / 2.0f;
  x2 = m[0] + w / 2.0f;
  y2 = m[1] + m[3] / 2.0f;
}

// xyxy_to_xyah
__device__ __forceinline__ void xyah(float x1, float y1, float x2, float y2,
                                     float* m) {
  const float w = x2 - x1, h = y2 - y1;
  m[0] = (x1 + x2) / 2.0f;
  m[1] = (y1 + y2) / 2.0f;
  m[2] = w / fmaxf(h, 1e-6f);
  m[3] = h;
}

// Exclusive ranks of the set flags among i < n, over the whole block: calls
// emit(i, rank) for each set i and returns their count. Every thread calls
// it (it holds barriers).
template <class Flag, class Emit>
__device__ int block_rank(int n, Flag flag, Emit emit, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    const bool f = i < n && flag(i);
    const unsigned m = __ballot_sync(FULL, f);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int off = carry, total = 0;
    for (int w = 0; w < NW; ++w) {
      const int c = wsum[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (f) emit(i, off + __popc(m & ((1u << lane) - 1u)));
    carry += total;
    __syncthreads();
  }
  return carry;
}

__device__ __forceinline__ bool in_pool(int kind, const Smem& s, int t) {
  const int st = s.sstate[t];
  const bool live = st != S_EMPTY, act = s.sact[t] != 0;
  if (kind == 1) return live && (act || st == S_LOST);
  if (kind == 2) return st == S_TRACKED && act && s.match[t] < 0;
  return st == S_TRACKED && !act;
}

__device__ __forceinline__ bool col_ok(int kind, uint8_t f) {
  if (kind == 2) return f & F_LOW;
  if (kind == 1) return f & F_HIGH;
  return (f & F_HIGH) && !(f & F_USED1);
}

// One auction of `kind` (1, 2, 3) over the stream's rows and columns; writes
// the matched column into s.match of the pool's rows (which hold -1 on
// entry) and marks the matched detections used.
__device__ void auction(int kind, float thresh, const Smem& s,
                        const float* iou, int T, int D,
                        unsigned long long* rounds_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < D; j += NT) {
    s.price[j] = 0.0f;
    s.owner[j] = -1;
    s.key[j] = 0ull;
  }
  for (int t = threadIdx.x; t < T; t += NT)
    s.rstat[t] = in_pool(kind, s, t) ? R_ACTIVE : R_IDLE;
  __syncthreads();
  int rounds = 0;
  while (rounds < MAX_ITER) {
    // bids: every active row of the stream, a warp a row at a time
    int bid = 0;
    for (int base = warp * 32; base < T; base += NT) {
      const int rr = base + lane;
      unsigned act = __ballot_sync(FULL, rr < T && s.rstat[rr] == R_ACTIVE);
      while (act) {
        const int r = base + __ffs(act) - 1;
        act &= act - 1;
        const float* row = iou + (size_t)r * D;
        float b1 = 0.0f, b2 = 0.0f;  // best and second value; 0 = unassigned
        int i1 = -1;
        for (int j = lane; j < D; j += 32) {
          if (!col_ok(kind, s.dflag[j])) continue;
          const float io = row[j];
          const float cost = kind == 2 ? 1.0f - io : 1.0f - io * s.dsc[j];
          const float v = (thresh - cost) - s.price[j];
          if (v > b1) {
            b2 = b1;
            b1 = v;
            i1 = j;
          } else if (v > b2) {
            b2 = v;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float c1 = __shfl_xor_sync(FULL, b1, o);
          const float c2 = __shfl_xor_sync(FULL, b2, o);
          const int k1 = __shfl_xor_sync(FULL, i1, o);
          if (k1 >= 0 && (i1 < 0 || c1 > b1 || (c1 == b1 && k1 < i1))) {
            b2 = fmaxf(b1, c2);
            b1 = c1;
            i1 = k1;
          } else {
            b2 = fmaxf(b2, c1);
          }
        }
        if (lane == 0) {
          if (i1 < 0) {
            s.rstat[r] = R_DEAD;
          } else {
            const float b = (s.price[i1] + (b1 - b2)) + EPS;
            atomicMax(&s.key[i1],
                      ((unsigned long long)__float_as_uint(b) << 32) |
                          (0xffffffffu - (unsigned)r));
          }
        }
        bid |= i1 >= 0;
      }
    }
    if (!__syncthreads_or(bid)) break;
    ++rounds;
    // each column takes its best bid; its former owner is evicted
    for (int j = threadIdx.x; j < D; j += NT) {
      const unsigned long long k = s.key[j];
      if (!k) continue;
      s.key[j] = 0ull;
      const int r = (int)(0xffffffffu - (unsigned)(k & 0xffffffffull));
      s.price[j] = __uint_as_float((unsigned)(k >> 32));
      const int o = s.owner[j];
      if (o >= 0) {
        s.match[o] = -1;
        s.rstat[o] = R_ACTIVE;
      }
      s.owner[j] = r;
      s.match[r] = j;
      s.rstat[r] = R_ASSIGNED;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(&rounds_out[kind - 1],
                                  (unsigned long long)rounds);
  const uint8_t used = kind == 1 ? (F_USED | F_USED1) : F_USED;
  for (int j = threadIdx.x; j < D; j += NT)
    if (s.owner[j] >= 0) s.dflag[j] |= used;
  __syncthreads();
}

// kalman_update of device_tracker.py for one slot, in place on m (8) and the
// slot's covariance c (8x8, row-major, global). The 4x4 system is solved by
// Gaussian elimination (it is symmetric positive definite).
__device__ void kalman_update(float* m, float* c, const float* meas) {
  const float h = m[3];
  const float r[4] = {STD_POS * h, STD_POS * h, 1e-1f, STD_POS * h};
  float S[4][4], A[4][4], X[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      S[i][j] = c[i * 8 + j] + (i == j ? r[i] * r[i] : 0.0f);
#pragma unroll
    for (int j = 0; j < 8; ++j) X[i][j] = c[i * 8 + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) A[i][j] = S[i][j];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = k + 1; i < 4; ++i) {
      const float f = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 4; ++j) A[i][j] = A[i][j] - f * A[k][j];
#pragma unroll
      for (int j = 0; j < 8; ++j) X[i][j] = X[i][j] - f * X[k][j];
    }
#pragma unroll
  for (int k = 3; k >= 0; --k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = X[k][j];
#pragma unroll
      for (int i = k + 1; i < 4; ++i) x = x - A[k][i] * X[i][j];
      X[k][j] = x / A[k][k];
    }
  // K = X^T (8x4); mean += K innov; cov -= (K S) K^T
  float innov[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) innov[k] = meas[k] - m[k];
  float KS[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float dm = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) dm = dm + X[k][i] * innov[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v = v + X[q][i] * S[q][k];
      KS[i][k] = v;
    }
    m[i] = m[i] + dm;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) v = v + KS[i][k] * X[k][j];
      c[i * 8 + j] = c[i * 8 + j] - v;
    }
}

__global__ void __launch_bounds__(NT) tracker_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wsum[NW];
  const int T = a.T, D = a.D;
  const Smem s = carve(smem_raw, T, D);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t sT = (size_t)b * T, sD = (size_t)b * D;
  const int fid = a.frame_id[b] + 1;
  float* iou = a.iou + sT * D;

  // detections and their flags
  for (int j = threadIdx.x; j < D; j += NT) {
    const float* d = a.dets + (sD + j) * 5;
    s.dx1[j] = d[0];
    s.dy1[j] = d[1];
    s.dx2[j] = d[2];
    s.dy2[j] = d[3];
    const float sc = d[4];
    s.dsc[j] = sc;
    const bool valid = a.det_valid[sD + j] != 0;
    uint8_t f = 0;
    if (valid && sc > a.track_thresh) f |= F_HIGH;
    if (valid && sc > 0.1f && sc < a.track_thresh) f |= F_LOW;
    s.dflag[j] = f;
  }
  // the slot table, and the Kalman predict of the tracked + lost pool into
  // the output mean and covariance
  for (int t = threadIdx.x; t < T; t += NT) {
    const int st = a.state[sT + t];
    const bool act = a.activated[sT + t] != 0;
    s.sstate[t] = (uint8_t)st;
    s.sact[t] = act;
    s.sid[t] = a.track_id[sT + t];
    s.sscore[t] = a.score[sT + t];
    s.slast[t] = a.last_frame[sT + t];
    s.sstart[t] = a.start_frame[sT + t];
    s.match[t] = -1;
    const float* mi = a.mean + (sT + t) * 8;
    const float* ci = a.cov + (sT + t) * 64;
    float* mo = a.o_mean + (sT + t) * 8;
    float* co = a.o_cov + (sT + t) * 64;
    float m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = mi[i];
    const bool lost = st == S_LOST;
    if (st != S_EMPTY && (act || lost)) {
      if (lost) m[7] = 0.0f;
      const float h = m[3];
      const float q[8] = {STD_POS * h, STD_POS * h, 1e-2f, STD_POS * h,
                          STD_VEL * h, STD_VEL * h, 1e-5f, STD_VEL * h};
      // (F cov) F^T + diag(q^2), F = [[I, I], [0, I]]: sums with exact zeros
      float A[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int l = 0; l < 8; ++l)
          A[i][l] = i < 4 ? ci[i * 8 + l] + ci[(i + 4) * 8 + l]
                          : ci[i * 8 + l];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = j < 4 ? A[i][j] + A[i][j + 4] : A[i][j];
          if (i == j) v = v + q[i] * q[i];
          co[i * 8 + j] = v;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = m[i] + m[i + 4];
    } else {
      for (int i = 0; i < 64; ++i) co[i] = ci[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) mo[i] = m[i];
    tlbr(m, s.tx1[t], s.ty1[t], s.tx2[t], s.ty2[t]);
  }
  __syncthreads();

  // IoU of every live slot against every detection
  for (int r = warp; r < T; r += NW) {
    if (s.sstate[r] == S_EMPTY) continue;
    const float x1 = s.tx1[r], y1 = s.ty1[r], x2 = s.tx2[r], y2 = s.ty2[r];
    for (int j = lane; j < D; j += 32)
      iou[(size_t)r * D + j] = iou_incl(x1, y1, x2, y2, s.dx1[j], s.dy1[j],
                                        s.dx2[j], s.dy2[j]);
  }
  __syncthreads();

  auction(1, a.match_thresh, s, iou, T, D, a.rounds);
  auction(2, 0.5f, s, iou, T, D, a.rounds);
  auction(3, 0.7f, s, iou, T, D, a.rounds);

  // the update of matched slots and the slot states
  for (int t = threadIdx.x; t < T; t += NT) {
    const int j = s.match[t];
    int st = s.sstate[t];
    const bool act = s.sact[t] != 0;
    if (j >= 0) {
      float m[8], meas[4];
      float* mo = a.o_mean + (sT + t) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = mo[i];
      xyah(s.dx1[j], s.dy1[j], s.dx2[j], s.dy2[j], meas);
      kalman_update(m, a.o_cov + (sT + t) * 64, meas);
#pragma unroll
      for (int i = 0; i < 8; ++i) mo[i] = m[i];
      s.sscore[t] = s.dsc[j];
      s.sact[t] = 1;
      s.slast[t] = fid;
      st = S_TRACKED;
    } else if (st == S_TRACKED) {
      st = act ? S_LOST : S_EMPTY;
    }
    if (st == S_LOST && fid - s.slast[t] > a.max_time_lost) st = S_EMPTY;
    s.sstate[t] = (uint8_t)st;
  }
  __syncthreads();

  // new tracks: the k-th unmatched strong detection into the k-th free slot
  const int n_new_det = block_rank(
      D,
      [&](int j) {
        const uint8_t f = s.dflag[j];
        return (f & F_HIGH) && !(f & F_USED) && s.dsc[j] >= a.det_thresh;
      },
      [&](int j, int k) {
        s.rank[j] = k;
        s.dflag[j] |= F_NEW;
      },
      wsum);
  const int n_free = block_rank(
      T, [&](int t) { return s.sstate[t] == S_EMPTY; },
      [&](int t, int k) { s.free_slot[k] = t; }, wsum);
  const int next_id = a.next_id[b];
  for (int j = threadIdx.x; j < D; j += NT) {
    if (!(s.dflag[j] & F_NEW) || s.rank[j] >= n_free) continue;
    const int t = s.free_slot[s.rank[j]];
    float m[8];
    xyah(s.dx1[j], s.dy1[j], s.dx2[j], s.dy2[j], m);
    const float h = m[3];
    const float q[8] = {STD_POS2 * h, STD_POS2 * h, 1e-2f, STD_POS2 * h,
                        STD_VEL10 * h, STD_VEL10 * h, 1e-5f, STD_VEL10 * h};
    float* mo = a.o_mean + (sT + t) * 8;
    float* co = a.o_cov + (sT + t) * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mo[i] = i < 4 ? m[i] : 0.0f;
#pragma unroll
      for (int l = 0; l < 8; ++l) co[i * 8 + l] = i == l ? q[i] * q[i] : 0.0f;
    }
    s.sscore[t] = s.dsc[j];
    s.sstate[t] = S_TRACKED;
    s.sact[t] = fid == 1;
    s.slast[t] = fid;
    s.sstart[t] = fid;
    s.sid[t] = next_id + s.rank[j];
  }
  __syncthreads();

  // de-duplicate tracked against lost: of a pair with IoU > 0.85 the
  // younger is dropped
  for (int t = threadIdx.x; t < T; t += NT) {
    tlbr(a.o_mean + (sT + t) * 8, s.tx1[t], s.ty1[t], s.tx2[t], s.ty2[t]);
    s.drop[t] = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += NT) {
    if (s.sstate[t] != S_TRACKED) continue;
    const int age_t = s.slast[t] - s.sstart[t];
    for (int l = 0; l < T; ++l) {
      if (s.sstate[l] != S_LOST) continue;
      if (!(iou_incl(s.tx1[t], s.ty1[t], s.tx2[t], s.ty2[t], s.tx1[l],
                     s.ty1[l], s.tx2[l], s.ty2[l]) > 0.85f))
        continue;
      if (age_t <= s.slast[l] - s.sstart[l])
        s.drop[t] = 1;
      else
        s.drop[l] = 1;
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < T; t += NT) {
    const int st = s.drop[t] ? S_EMPTY : s.sstate[t];
    const size_t g = sT + t;
    a.o_state[g] = st;
    a.o_activated[g] = s.sact[t];
    a.o_track_id[g] = s.sid[t];
    a.o_score[g] = s.sscore[t];
    a.o_last[g] = s.slast[t];
    a.o_start[g] = s.sstart[t];
    float* o = a.out + g * 6;
    o[0] = s.tx1[t];
    o[1] = s.ty1[t];
    o[2] = s.tx2[t];
    o[3] = s.ty2[t];
    o[4] = s.sscore[t];
    o[5] = (float)s.sid[t];
    a.out_valid[g] = st == S_TRACKED && s.sact[t];
  }
  if (threadIdx.x == 0) {
    a.o_next_id[b] = next_id + min(n_new_det, n_free);
    a.o_frame_id[b] = fid;
  }
}

}  // namespace

// Plain C interface for ctypes. ptrs: the N_PTRS device pointers in the
// order of `Args` (the input TrackState's ten fields, dets, det_valid, the
// output TrackState's ten fields, out, out_valid, the IoU scratch, the
// rounds counter), all contiguous. One block a stream on `stream`; returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a shape past the
// limits (1 <= T <= 1024, 1 <= D <= 1024, S >= 1).
extern "C" int tracker_step_launch(void* const* ptrs, int S, int T, int D,
                                   float track_thresh, float match_thresh,
                                   float det_thresh, int max_time_lost,
                                   void* stream) {
  if (S < 1 || T < 1 || T > MAX_T || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  Args a;
  void** dst[N_PTRS] = {
      (void**)&a.mean,      (void**)&a.cov,       (void**)&a.state,
      (void**)&a.activated, (void**)&a.track_id,  (void**)&a.score,
      (void**)&a.last_frame, (void**)&a.start_frame, (void**)&a.next_id,
      (void**)&a.frame_id,  (void**)&a.dets,      (void**)&a.det_valid,
      (void**)&a.o_mean,    (void**)&a.o_cov,     (void**)&a.o_state,
      (void**)&a.o_activated, (void**)&a.o_track_id, (void**)&a.o_score,
      (void**)&a.o_last,    (void**)&a.o_start,   (void**)&a.o_next_id,
      (void**)&a.o_frame_id, (void**)&a.out,      (void**)&a.out_valid,
      (void**)&a.iou,       (void**)&a.rounds};
  for (int i = 0; i < N_PTRS; ++i) *dst[i] = ptrs[i];
  a.T = T;
  a.D = D;
  a.max_time_lost = max_time_lost;
  a.track_thresh = track_thresh;
  a.match_thresh = match_thresh;
  a.det_thresh = det_thresh;
  const size_t smem = smem_bytes(T, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tracker_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tracker_step_kernel<<<S, NT, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

extern "C" const char* tracker_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
