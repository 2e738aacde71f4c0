"""COCO run-length-encoded mask codec in numpy (port of
unicorn_tpu/evaluators/rle.py's pure forms; its native C++ codec comes
with the evaluators).

The COCO mask API formats: uncompressed RLE ({"size": [h, w], "counts":
[int, ...]}, column-major runs starting with zeros) and the compressed
string form (5-bit varint characters offset by 48, counts beyond the
second coded as deltas).
"""
from __future__ import annotations

import numpy as np


def encode_counts(mask: np.ndarray) -> dict:
    """(H, W) bool / 0-1 mask -> uncompressed RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # runs, starting with the count of zeros
    changes = np.flatnonzero(np.diff(flat))
    counts = np.diff(np.concatenate([[-1], changes, [len(flat) - 1]])).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def decode_counts(rle: dict) -> np.ndarray:
    """Uncompressed RLE dict -> (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    # alternate runs of 0 and 1: each 1-run is a range of the flat mask
    ends = np.cumsum(counts)
    starts = ends - counts
    flat = np.zeros(h * w + 1, np.int32)
    on_s, on_e = starts[1::2], ends[1::2]
    np.add.at(flat, np.minimum(on_s, h * w), 1)
    np.add.at(flat, np.minimum(on_e, h * w), -1)
    mask = (np.cumsum(flat[:-1]) > 0).astype(np.uint8)
    return mask.reshape((w, h)).T  # column-major


def compress(rle: dict) -> dict:
    """Uncompressed -> compressed string RLE (COCO maskApi rleToString)."""
    counts = rle["counts"]
    s = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return {"size": rle["size"], "counts": "".join(s)}


def decompress(rle: dict) -> dict:
    """Compressed string RLE -> uncompressed (COCO maskApi rleFrString)."""
    s = rle["counts"]
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": rle["size"], "counts": counts}


def _uncompressed(rle: dict) -> dict:
    """Any RLE form -> the uncompressed dict."""
    c = rle["counts"]
    if isinstance(c, (str, bytes)):
        return decompress({"size": rle["size"], "counts": c.decode("ascii")
                           if isinstance(c, bytes) else c})
    return rle


def encode(mask: np.ndarray) -> dict:
    """(H, W) binary mask -> compressed RLE (like mask_util.encode)."""
    return compress(encode_counts(mask))


def decode(rle) -> np.ndarray:
    """RLE (compressed string or bytes, or uncompressed list) -> mask."""
    return decode_counts(_uncompressed(rle))


def area(rle) -> int:
    return int(sum(_uncompressed(rle)["counts"][1::2]))


def merge(rles, intersect: bool = False) -> dict:
    """Union (or intersection) of RLE masks -> uncompressed RLE."""
    if not rles:
        raise ValueError("merge of zero masks")
    stack = np.stack([decode(r) for r in rles])
    m = stack.all(0) if intersect else stack.any(0)
    return encode_counts(m)


def iou_rle(d_rles, g_rles, iscrowd=None) -> np.ndarray:
    """IoU matrix between lists of RLEs; with iscrowd a crowd ground
    truth's union is the detection's area."""
    if not d_rles or not g_rles:
        return np.zeros((len(d_rles), len(g_rles)))
    d = np.stack([decode(r) for r in d_rles]).astype(np.float32)
    g = np.stack([decode(r) for r in g_rles]).astype(np.float32)
    d_flat = d.reshape(len(d), -1)
    g_flat = g.reshape(len(g), -1)
    inter = d_flat @ g_flat.T
    d_area = d_flat.sum(1)[:, None]
    g_area = g_flat.sum(1)[None, :]
    if iscrowd is None:
        iscrowd = np.zeros(len(g), bool)
    union = np.where(np.asarray(iscrowd, bool)[None, :], d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)
