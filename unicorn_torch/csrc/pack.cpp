// Host-side 4x4 space-to-depth frame packing (the serving ingest path; a
// copy of unicorn_tpu/csrc/pack.cpp).
//
// (N, H, W, C) uint8 -> (N, H/4, W/4, 16*C), patch-major (dy, dx, c) order,
// as unicorn_torch.drivers.stream.pack_frames_plain and the ConvNeXt stem's
// patch decomposition. The kernel walks each output row once, copying
// 4-row x 4-col x C pixel blocks with sequential writes (the output is the
// contiguous side, so writes stream; the 4 input rows stay in L1/L2 across
// a whole output row). H and W must be multiples of 4 (checked by the
// caller, csrc/native.py).
#include <cstdint>
#include <cstring>

extern "C" void pack_frames_s2d4(const uint8_t* src, int64_t n, int64_t h,
                                 int64_t w, int64_t c, uint8_t* dst) {
    const int64_t h4 = h / 4, w4 = w / 4;
    const int64_t in_row = w * c;         // one input row
    const int64_t out_px = 16 * c;        // one packed output pixel
    for (int64_t img = 0; img < n; ++img) {
        const uint8_t* sbase = src + img * h * in_row;
        uint8_t* dbase = dst + img * h4 * w4 * out_px;
        for (int64_t oy = 0; oy < h4; ++oy) {
            const uint8_t* rows[4];
            for (int64_t dy = 0; dy < 4; ++dy)
                rows[dy] = sbase + (oy * 4 + dy) * in_row;
            uint8_t* d = dbase + oy * w4 * out_px;
            for (int64_t ox = 0; ox < w4; ++ox) {
                const int64_t xoff = ox * 4 * c;
                for (int64_t dy = 0; dy < 4; ++dy) {
                    // 4 pixels x C channels contiguous in the input row
                    std::memcpy(d, rows[dy] + xoff, 4 * c);
                    d += 4 * c;
                }
            }
        }
    }
}
