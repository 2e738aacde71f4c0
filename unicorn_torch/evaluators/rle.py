"""COCO run-length-encoded mask codec (port of
unicorn_tpu/evaluators/rle.py).

The COCO mask API formats: uncompressed RLE ({"size": [h, w], "counts":
[int, ...]}, column-major runs starting with zeros) and the compressed
string form (5-bit varint characters offset by 48, counts beyond the
second coded as deltas).

encode / decode, the string codec, area, merge and IoU run on the native
codec `csrc/rle.cpp` (csrc/native.py), as JAX's do where its library
builds; a failed build raises. The `*_plain` functions are the numpy /
Python forms, kept as the plain reference the tests hold the native codec
against, bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..csrc import native


# ----------------------------------------------------------------- native
def encode_counts(mask: np.ndarray) -> dict:
    """(H, W) bool / 0-1 mask -> uncompressed RLE dict."""
    h, w = mask.shape
    return {"size": [h, w], "counts": native.rle_encode(mask).tolist()}


def decode_counts(rle: dict) -> np.ndarray:
    """Uncompressed RLE dict -> (H, W) uint8 mask."""
    h, w = rle["size"]
    return native.rle_decode(rle["counts"], h, w)


def compress(rle: dict) -> dict:
    """Uncompressed -> compressed string RLE (COCO maskApi rleToString)."""
    return {"size": rle["size"], "counts": native.rle_to_string(rle["counts"])}


def decompress(rle: dict) -> dict:
    """Compressed string RLE -> uncompressed (COCO maskApi rleFrString)."""
    return {"size": rle["size"],
            "counts": native.rle_from_string(rle["counts"]).tolist()}


def _uncompressed(rle: dict, decompress_fn=decompress) -> dict:
    """Any RLE form -> the uncompressed dict."""
    c = rle["counts"]
    if isinstance(c, (str, bytes)):
        return decompress_fn({"size": rle["size"], "counts": c.decode("ascii")
                              if isinstance(c, bytes) else c})
    return rle


def encode(mask: np.ndarray) -> dict:
    """(H, W) binary mask -> compressed RLE (like mask_util.encode)."""
    return compress(encode_counts(mask))


def decode(rle) -> np.ndarray:
    """RLE (compressed string or bytes, or uncompressed list) -> mask."""
    return decode_counts(_uncompressed(rle))


def area(rle) -> int:
    return native.rle_area(_uncompressed(rle)["counts"])


def merge(rles, intersect: bool = False) -> dict:
    """Union (or intersection) of RLE masks -> uncompressed RLE (the role of
    pycocotools' mask.merge; MOTS overlap resolution)."""
    if not rles:
        raise ValueError("merge of zero masks")
    h, w = rles[0]["size"]
    counts = native.rle_merge([_uncompressed(r)["counts"] for r in rles],
                              h, w, intersect)
    return {"size": [h, w], "counts": counts.tolist()}


def iou_rle(d_rles, g_rles, iscrowd=None) -> np.ndarray:
    """(D, G) float64 IoU between lists of RLEs, in the RLE domain; with
    iscrowd a crowd ground truth's union is the detection's area, and a
    union of 0 gives 0."""
    return native.rle_iou([_uncompressed(r)["counts"] for r in d_rles],
                          [_uncompressed(r)["counts"] for r in g_rles],
                          iscrowd)


# ------------------------------------------------------------------ plain
def encode_counts_plain(mask: np.ndarray) -> dict:
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # runs, starting with the count of zeros
    changes = np.flatnonzero(np.diff(flat))
    counts = np.diff(np.concatenate([[-1], changes, [len(flat) - 1]])).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def decode_counts_plain(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    # alternate runs of 0 and 1: each 1-run is a range of the flat mask
    ends = np.cumsum(counts)
    starts = ends - counts
    flat = np.zeros(h * w + 1, np.int32)
    np.add.at(flat, np.minimum(starts[1::2], h * w), 1)
    np.add.at(flat, np.minimum(ends[1::2], h * w), -1)
    mask = (np.cumsum(flat[:-1]) > 0).astype(np.uint8)
    return mask.reshape((w, h)).T  # column-major


def compress_plain(rle: dict) -> dict:
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


def decompress_plain(rle: dict) -> dict:
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


def decode_plain(rle) -> np.ndarray:
    return decode_counts_plain(_uncompressed(rle, decompress_plain))


def area_plain(rle) -> int:
    return int(sum(_uncompressed(rle, decompress_plain)["counts"][1::2]))


def merge_plain(rles, intersect: bool = False) -> dict:
    if not rles:
        raise ValueError("merge of zero masks")
    stack = np.stack([decode_plain(r) for r in rles])
    return encode_counts_plain(stack.all(0) if intersect else stack.any(0))


def iou_rle_plain(d_rles, g_rles, iscrowd=None) -> np.ndarray:
    """Dense: the masks decoded, the intersections counted in integers,
    each IoU one float64 division, as the native codec does it."""
    if not d_rles or not g_rles:
        return np.zeros((len(d_rles), len(g_rles)))
    d = np.stack([decode_plain(r) for r in d_rles]).reshape(len(d_rles), -1)
    g = np.stack([decode_plain(r) for r in g_rles]).reshape(len(g_rles), -1)
    inter = d.astype(np.int64) @ g.T.astype(np.int64)
    d_area = d.sum(1, dtype=np.int64)[:, None]
    g_area = g.sum(1, dtype=np.int64)[None, :]
    crowd = (np.zeros(len(g), bool) if iscrowd is None
             else np.asarray(iscrowd) != 0)
    union = np.where(crowd[None, :], d_area, d_area + g_area - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)
