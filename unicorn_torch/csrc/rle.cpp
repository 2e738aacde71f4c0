// Native COCO RLE mask codec of the port's evaluators (a copy of
// unicorn_tpu/csrc/rle.cpp), bound by unicorn_torch/csrc/native.py with
// ctypes.
//
// The role of pycocotools' C maskApi (common/maskApi.c), which the reference
// uses for its mask RLE work: encode / decode, the string form, area, IoU in
// the RLE domain (no dense decode) and merge. The wire format: column-major
// runs starting with zeros; 5-bit varint characters offset by 48, counts
// beyond the second coded as deltas. unicorn_torch/evaluators/rle.py keeps
// the numpy forms as the plain reference the tests hold these against.
#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Run-length-encode a column-major flat 0/1 buffer (runs start with zeros).
// counts_out must hold total+1 entries.  Returns the number of counts.
// The binding feeds np.asfortranarray(mask).ravel("K"), so the scan is a
// single contiguous sweep.
int64_t rle_encode_flat(const uint8_t* flat, int64_t total,
                        int64_t* counts_out) {
  int64_t n = 0;
  int64_t run = 0;
  uint8_t cur = 0;
  for (int64_t p = 0; p < total; ++p) {
    uint8_t v = flat[p] ? 1 : 0;
    if (v == cur) {
      ++run;
    } else {
      counts_out[n++] = run;
      run = 1;
      cur = v;
    }
  }
  counts_out[n++] = run;
  return n;
}

// Decode column-major RLE counts into a row-major (h, w) 0/1 mask.
void rle_decode(const int64_t* counts, int64_t n, int64_t h, int64_t w,
                uint8_t* mask_out) {
  int64_t pos = 0;
  uint8_t val = 0;
  const int64_t total = h * w;
  for (int64_t k = 0; k < n; ++k) {
    int64_t c = counts[k];
    if (val) {
      for (int64_t t = 0; t < c && pos + t < total; ++t) {
        int64_t p = pos + t;
        // column-major position p -> row i = p % h, col j = p / h
        mask_out[(p % h) * w + (p / h)] = 1;
      }
    }
    pos += c;
    val = 1 - val;
  }
}

// counts -> char string (maskApi rleToString).  out must hold n*13+1 bytes.
// Returns the string length.
int64_t rle_to_string(const int64_t* counts, int64_t n, char* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;  // arithmetic shift (gcc/clang) keeps sign for deltas < 0
      more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      out[m++] = static_cast<char>(c + 48);
    }
  }
  out[m] = 0;
  return m;
}

// char string -> counts (maskApi rleFrString).  counts_out must hold len
// entries.  Returns the number of counts.
int64_t rle_from_string(const char* s, int64_t len, int64_t* counts_out) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    int64_t c = 0;
    while (more) {
      c = s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
    }
    if (c & 0x10) x |= -(int64_t(1) << (5 * k));
    if (n > 2) x += counts_out[n - 2];
    counts_out[n++] = x;
  }
  return n;
}

int64_t rle_area(const int64_t* counts, int64_t n) {
  int64_t a = 0;
  for (int64_t i = 1; i < n; i += 2) a += counts[i];
  return a;
}

namespace {
// Collect the 1-valued runs of an RLE as [start, end) intervals in the
// flattened column-major space.
void one_runs(const int64_t* counts, int64_t n,
              std::vector<int64_t>* starts, std::vector<int64_t>* ends) {
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t k = 0; k < n; ++k) {
    if (val && counts[k] > 0) {
      starts->push_back(pos);
      ends->push_back(pos + counts[k]);
    }
    pos += counts[k];
    val = 1 - val;
  }
}

int64_t intersect_runs(const std::vector<int64_t>& sa,
                       const std::vector<int64_t>& ea,
                       const std::vector<int64_t>& sb,
                       const std::vector<int64_t>& eb) {
  int64_t inter = 0;
  std::size_t i = 0, j = 0;
  while (i < sa.size() && j < sb.size()) {
    int64_t lo = sa[i] > sb[j] ? sa[i] : sb[j];
    int64_t hi = ea[i] < eb[j] ? ea[i] : eb[j];
    if (hi > lo) inter += hi - lo;
    if (ea[i] < eb[j]) ++i; else ++j;
  }
  return inter;
}
}  // namespace

// IoU matrix between D detection RLEs and G gt RLEs, all flattened into one
// counts buffer with per-mask offsets (off has D+1 / G+1 entries).  iscrowd
// (G) uses union = det area, as pycocotools iou does for crowd regions.
// iou_out is (D, G) row-major double.
void rle_iou(const int64_t* d_counts, const int64_t* d_off, int64_t D,
             const int64_t* g_counts, const int64_t* g_off, int64_t G,
             const uint8_t* iscrowd, double* iou_out) {
  std::vector<std::vector<int64_t>> ds(D), de(D), gs(G), ge(G);
  std::vector<int64_t> d_area(D), g_area(G);
  for (int64_t i = 0; i < D; ++i) {
    one_runs(d_counts + d_off[i], d_off[i + 1] - d_off[i], &ds[i], &de[i]);
    d_area[i] = rle_area(d_counts + d_off[i], d_off[i + 1] - d_off[i]);
  }
  for (int64_t j = 0; j < G; ++j) {
    one_runs(g_counts + g_off[j], g_off[j + 1] - g_off[j], &gs[j], &ge[j]);
    g_area[j] = rle_area(g_counts + g_off[j], g_off[j + 1] - g_off[j]);
  }
  for (int64_t i = 0; i < D; ++i) {
    for (int64_t j = 0; j < G; ++j) {
      int64_t inter = intersect_runs(ds[i], de[i], gs[j], ge[j]);
      double uni = iscrowd && iscrowd[j]
                       ? double(d_area[i])
                       : double(d_area[i] + g_area[j] - inter);
      iou_out[i * G + j] = uni > 0 ? double(inter) / uni : 0.0;
    }
  }
}

// Merge (union or intersection) a stack of RLEs into one mask's counts.
// Used for overlap resolution in MOTS dumps.  Returns n_counts.
int64_t rle_merge(const int64_t* counts, const int64_t* off, int64_t N,
                  int64_t h, int64_t w, int64_t intersect,
                  int64_t* counts_out) {
  const int64_t total = h * w;
  std::vector<uint8_t> acc(total, intersect ? 1 : 0);
  for (int64_t m = 0; m < N; ++m) {
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t k = off[m]; k < off[m + 1]; ++k) {
      int64_t c = counts[k];
      if (intersect) {
        if (!val)
          for (int64_t t = 0; t < c && pos + t < total; ++t) acc[pos + t] = 0;
      } else {
        if (val)
          for (int64_t t = 0; t < c && pos + t < total; ++t) acc[pos + t] = 1;
      }
      pos += c;
      val = 1 - val;
    }
  }
  // re-encode the column-major flat buffer directly
  int64_t n = 0;
  int64_t run = 0;
  uint8_t cur = 0;
  for (int64_t p = 0; p < total; ++p) {
    if (acc[p] == cur) {
      ++run;
    } else {
      counts_out[n++] = run;
      run = 1;
      cur = acc[p];
    }
  }
  counts_out[n++] = run;
  return n;
}

}  // extern "C"
