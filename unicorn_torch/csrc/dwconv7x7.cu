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
// Design (the kernel, its tiling and its launcher are in dw7x7_strip.cuh,
// which convnext_block.cu shares for its fp32 sums): a rolling column
// strip. A lane owns one channel pair (two
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

#include "dw7x7_strip.cuh"   // the kernel, its tiling and its launcher
#include "vec16.cuh"

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
    return dw7x7::launch<float, float, float>(x, taps, bias, y, B, H, W, C, s);
  if (dtype == 1 && C % Vec<__nv_bfloat16>::N == 0)
    return dw7x7::launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, taps, bias, y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The tiling dwconv7x7_nhwc picks for (B, H, W, C) on the current device:
// out[0..6] = channel pairs per block, columns per block, rows per strip,
// strips per image, grid x, y, z. Returns 0, or an error for a bad shape.
extern "C" int dwconv7x7_plan(int B, int H, int W, int C, int* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 2)
    return (int)cudaErrorInvalidValue;
  const dw7x7::Plan p = dw7x7::plan(B, H, W, C);
  const int v[7] = {p.cg, p.tw, p.sh, p.nstrips, (int)p.grid.x,
                    (int)p.grid.y, (int)p.grid.z};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* dwconv7x7_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
