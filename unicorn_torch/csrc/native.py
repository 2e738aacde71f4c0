"""ctypes bindings of the port's native host libraries (its counterpart
of unicorn_tpu/csrc/bindings.py): the COCO RLE mask codec
`csrc/rle.cpp` and COCOeval's matcher `csrc/cocoeval.cpp` of the
evaluators, and the serving ingest's 4x4 space-to-depth packer
`csrc/pack.cpp`.

Each is built on first use by csrc/build.py with the system C++ compiler
into `csrc/_build/`. A failed build raises: nothing falls back to the
numpy / Python forms, which stay in unicorn_torch/evaluators/rle.py,
coco_map.py and drivers/stream.py `pack_frames_plain` as the plain
reference the tests hold these against.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.c_int64
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _declare_rle(lib):
    lib.rle_encode_flat.restype = _i64
    lib.rle_encode_flat.argtypes = [_u8p, _i64, _i64p]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [_i64p, _i64, _i64, _i64, _u8p]
    lib.rle_to_string.restype = _i64
    lib.rle_to_string.argtypes = [_i64p, _i64, ctypes.c_char_p]
    lib.rle_from_string.restype = _i64
    lib.rle_from_string.argtypes = [ctypes.c_char_p, _i64, _i64p]
    lib.rle_area.restype = _i64
    lib.rle_area.argtypes = [_i64p, _i64]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [_i64p, _i64p, _i64, _i64p, _i64p, _i64, _u8p,
                            _f64p]
    lib.rle_merge.restype = _i64
    lib.rle_merge.argtypes = [_i64p, _i64p, _i64, _i64, _i64, _i64, _i64p]


def _declare_cocoeval(lib):
    lib.cocoeval_evaluate_img.restype = None
    lib.cocoeval_evaluate_img.argtypes = [_f64p, _i64, _i64, _u8p, _u8p,
                                          _f64p, _i64, _i64p, _u8p]


def _declare_pack(lib):
    lib.pack_frames_s2d4.restype = None
    lib.pack_frames_s2d4.argtypes = [_u8p, _i64, _i64, _i64, _i64, _u8p]


_DECLARE = {"rle": _declare_rle, "cocoeval": _declare_cocoeval,
            "pack": _declare_pack}


def library(name: str) -> ctypes.CDLL:
    """The loaded csrc/<name>.cpp ("rle", "cocoeval" or "pack"), built
    first if needed, its functions declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = build.load(name)
            _DECLARE[name](lib)
            _libs[name] = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _counts(c) -> np.ndarray:
    return np.ascontiguousarray(c, np.int64).reshape(-1)


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool / 0-1 mask -> its column-major counts, int64."""
    if mask.ndim != 2:
        raise ValueError(f"rle_encode takes an (H, W) mask, got shape "
                         f"{mask.shape}")
    flat = np.asfortranarray(mask, np.uint8).ravel(order="K")
    out = np.empty(flat.size + 1, np.int64)
    n = library("rle").rle_encode_flat(_ptr(flat, ctypes.c_uint8), flat.size,
                                       _ptr(out, ctypes.c_int64))
    return out[:n]


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Column-major counts -> (H, W) uint8 0/1 mask, row-major; runs past
    H * W are cut."""
    counts = _counts(counts)
    mask = np.zeros((int(h), int(w)), np.uint8)
    library("rle").rle_decode(_ptr(counts, ctypes.c_int64), len(counts),
                              int(h), int(w), _ptr(mask, ctypes.c_uint8))
    return mask


def rle_to_string(counts) -> str:
    """Counts -> COCO's compressed string (maskApi rleToString)."""
    counts = _counts(counts)
    # at most 13 characters a 64-bit count, and the terminating zero
    buf = ctypes.create_string_buffer(13 * max(len(counts), 1) + 1)
    n = library("rle").rle_to_string(_ptr(counts, ctypes.c_int64),
                                     len(counts), buf)
    return buf.raw[:n].decode("ascii")


def rle_from_string(s: str) -> np.ndarray:
    """COCO's compressed string -> counts, int64 (maskApi rleFrString)."""
    raw = s.encode("ascii")
    codes = np.frombuffer(raw, np.uint8).astype(np.int64) - 48
    if ((codes < 0) | (codes > 63)).any() or (len(codes) and
                                               codes[-1] & 0x20):
        raise ValueError(f"not a compressed RLE string: {s[:40]!r}")
    out = np.empty(max(len(raw), 1), np.int64)
    n = library("rle").rle_from_string(raw, len(raw),
                                       _ptr(out, ctypes.c_int64))
    return out[:n]


def rle_area(counts) -> int:
    counts = _counts(counts)
    return int(library("rle").rle_area(_ptr(counts, ctypes.c_int64),
                                       len(counts)))


def _flatten(counts_list):
    counts = [_counts(c) for c in counts_list]
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum([len(c) for c in counts], out=off[1:])
    flat = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    return np.ascontiguousarray(flat, np.int64), off


def rle_iou(d_counts, g_counts, iscrowd=None) -> np.ndarray:
    """Lists of counts -> (D, G) float64 IoU in the RLE domain (interval
    intersection, no dense decode). With iscrowd (G,), a crowd ground
    truth's union is the detection's area; a union of 0 gives 0."""
    D, G = len(d_counts), len(g_counts)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dflat, doff = _flatten(d_counts)
    gflat, goff = _flatten(g_counts)
    crowd = (np.zeros(G, np.uint8) if iscrowd is None else
             np.ascontiguousarray(np.asarray(iscrowd) != 0, np.uint8))
    if crowd.shape != (G,):
        raise ValueError(f"iscrowd has shape {crowd.shape}, want ({G},)")
    out = np.zeros((D, G), np.float64)
    library("rle").rle_iou(
        _ptr(dflat, ctypes.c_int64), _ptr(doff, ctypes.c_int64), D,
        _ptr(gflat, ctypes.c_int64), _ptr(goff, ctypes.c_int64), G,
        _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def rle_merge(counts_list, h: int, w: int, intersect: bool = False
              ) -> np.ndarray:
    """The union (or intersection) of masks given as counts -> counts."""
    if not len(counts_list):
        raise ValueError("merge of zero masks")
    flat, off = _flatten(counts_list)
    out = np.empty(int(h) * int(w) + 1, np.int64)
    n = library("rle").rle_merge(
        _ptr(flat, ctypes.c_int64), _ptr(off, ctypes.c_int64),
        len(counts_list), int(h), int(w), int(intersect),
        _ptr(out, ctypes.c_int64))
    return out[:n]


def evaluate_img(ious: np.ndarray, gt_ignore: np.ndarray,
                 gt_iscrowd: np.ndarray, thresholds: np.ndarray):
    """COCOeval's greedy matching of one (image, category): ious (D, G) with
    the ground truth sorted non-ignored first, gt_ignore and gt_iscrowd (G,)
    in that order, thresholds (T,). Returns (dt_match (T, D) int64, the
    sorted ground-truth index or -1; dt_ignore (T, D) bool)."""
    ious = np.ascontiguousarray(ious, np.float64)
    if ious.ndim != 2:
        raise ValueError(f"ious must be (D, G), got shape {ious.shape}")
    D, G = ious.shape
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    gt_iscrowd = np.ascontiguousarray(gt_iscrowd, np.uint8)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    if gt_ignore.shape != (G,) or gt_iscrowd.shape != (G,):
        raise ValueError(f"gt_ignore / gt_iscrowd must be ({G},), got "
                         f"{gt_ignore.shape} / {gt_iscrowd.shape}")
    T = len(thresholds)
    dt_match = np.full((T, D), -1, np.int64)
    dt_ignore = np.zeros((T, D), np.uint8)
    library("cocoeval").cocoeval_evaluate_img(
        _ptr(ious, ctypes.c_double), D, G, _ptr(gt_ignore, ctypes.c_uint8),
        _ptr(gt_iscrowd, ctypes.c_uint8), _ptr(thresholds, ctypes.c_double),
        T, _ptr(dt_match, ctypes.c_int64), _ptr(dt_ignore, ctypes.c_uint8))
    return dt_match, dt_ignore.astype(bool)


def pack_frames_s2d4(frames: np.ndarray) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, H/4, W/4, 16 * C) uint8, the 4x4
    space-to-depth in patch-major (dy, dx, c) order; H and W multiples of
    4."""
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"pack_frames_s2d4 takes (N, H, W, C) uint8 frames, "
                         f"got {frames.dtype} {frames.shape}")
    n, h, w, c = frames.shape
    if h % 4 or w % 4:
        raise ValueError(f"pack_frames_s2d4 needs H, W divisible by 4 "
                         f"(letterboxed input), got {h}x{w}")
    frames = np.ascontiguousarray(frames)
    out = np.empty((n, h // 4, w // 4, 16 * c), np.uint8)
    library("pack").pack_frames_s2d4(_ptr(frames, ctypes.c_uint8), n, h, w,
                                     c, _ptr(out, ctypes.c_uint8))
    return out
