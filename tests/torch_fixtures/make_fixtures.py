#!/usr/bin/env python3
"""Write the image fixtures of the port's reader (unicorn_torch/data/
image_io.py) and their decodes' digests, hashes.json.

    python3 tests/torch_fixtures/make_fixtures.py   # needs cv2 and PIL

The files: two 1080x1920 frames (a baseline 4:2:0 q90 JPEG as cv2.imwrite
writes it, and a progressive one with successive-approximation scans), a
DAVIS-480p frame (480x854 JPEG) and its palette mask (three objects), and
small files of every other format the reader takes (grayscale, 4:2:2,
4:4:4 and 4:4:0 JPEGs, restart intervals, an EXIF-rotated JPEG, PNGs of
every colour type and bit depth with every filter). The frames are seeded
synthetic scenes (gradients, shapes, blur and noise), so the files are
reproducible byte for byte on one OpenCV / PIL build.

hashes.json maps each file to the digest (`digest`) of cv2.imread's result
for IMREAD_COLOR and IMREAD_GRAYSCALE and, for PNGs, of PIL's first
channel (`np.atleast_3d(np.array(Image.open(f)))[..., 0]`, the palette
indices of a mask) for palette and 8-bit PNGs, which the reader must
reproduce.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def digest(a: np.ndarray) -> str:
    """sha256 of an array's shape, dtype and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape}{a.dtype}".encode() + a.tobytes()
                          ).hexdigest()


def png_bytes(samples: np.ndarray, depth: int, ctype: int, plte=None,
              filters=(0,)) -> bytes:
    """A PNG of (H, W, channels) integer samples at `depth` bits, colour
    type `ctype`, row r filtered with filters[r % len(filters)]."""
    h, w, ch = samples.shape
    rows = []
    for y in range(h):
        v = samples[y].reshape(-1)
        if depth < 8:
            bits = np.unpackbits(v.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
            rows.append(np.packbits(bits.reshape(-1)).tobytes())
        elif depth == 8:
            rows.append(v.astype(np.uint8).tobytes())
        else:
            rows.append(v.astype(">u2").tobytes())
    bpp = max(1, ch * depth // 8)
    out, prev = bytearray(), bytes(len(rows[0]))
    for y, r in enumerate(rows):
        f = filters[y % len(filters)]
        cur = np.frombuffer(r, np.uint8).astype(np.int32)
        up = np.frombuffer(prev, np.uint8).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out += bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = r

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if plte is not None:
        data += chunk(b"PLTE", plte)
    return data + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def scene(h, w, seed):
    """A seeded synthetic frame: gradients, shapes, blur and noise."""
    import cv2

    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 80 * xx / w, 90 + 60 * yy / h, 140 - 50 * xx / w],
                   -1).astype(np.uint8).copy()
    for _ in range(40):
        c = tuple(int(v) for v in r.randint(0, 256, 3))
        cx, cy = int(r.randint(0, w)), int(r.randint(0, h))
        ax = (int(r.randint(10, max(11, w // 8))),
              int(r.randint(10, max(11, h // 8))))
        if r.rand() < 0.5:
            cv2.ellipse(img, (cx, cy), ax, float(r.uniform(0, 180)), 0, 360,
                        c, -1, cv2.LINE_AA)
        else:
            cv2.rectangle(img, (cx, cy), (cx + ax[0], cy + ax[1]), c, -1)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    return np.clip(img + r.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def davis_mask(h, w, seed):
    """Three elliptic objects, ids 1-3, on the DAVIS palette."""
    import cv2

    r = np.random.RandomState(seed)
    m = np.zeros((h, w), np.uint8)
    for k in range(1, 4):
        cv2.ellipse(m, (int(r.randint(w // 5, 4 * w // 5)),
                        int(r.randint(h // 5, 4 * h // 5))),
                    (int(r.randint(30, 120)), int(r.randint(30, 90))),
                    float(r.uniform(0, 180)), 0, 360, k, -1)
    return m


DAVIS_PALETTE = bytes([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128]
                      + [128, 0, 128] * 251)


def write(out_dir=HERE):
    import cv2
    from PIL import Image

    files = {}
    big = scene(1080, 1920, 1)
    ok, b = cv2.imencode(".jpg", big, [cv2.IMWRITE_JPEG_QUALITY, 90])
    files["frame_1080x1920_q90.jpg"] = b.tobytes()
    ok, b = cv2.imencode(".jpg", scene(1080, 1920, 2), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["frame_1080x1920_q90_progressive.jpg"] = b.tobytes()
    ok, b = cv2.imencode(".jpg", scene(480, 854, 3),
                         [cv2.IMWRITE_JPEG_QUALITY, 90])
    files["davis_480x854.jpg"] = b.tobytes()
    files["davis_480x854_mask.png"] = png_bytes(
        davis_mask(480, 854, 4)[..., None], 8, 3, DAVIS_PALETTE, (0, 1, 2, 4))
    small = scene(37, 53, 5)
    for name, params in (
            ("small_gray.jpg", None),
            ("small_422_q75.jpg", [cv2.IMWRITE_JPEG_QUALITY, 75,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
            ("small_444_q100.jpg", [cv2.IMWRITE_JPEG_QUALITY, 100,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
            ("small_440_q50.jpg", [cv2.IMWRITE_JPEG_QUALITY, 50,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
            ("small_restart.jpg", [cv2.IMWRITE_JPEG_QUALITY, 85,
                                   cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
            ("small_progressive_q20.jpg", [cv2.IMWRITE_JPEG_QUALITY, 20,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
        src = small[..., 0] if name == "small_gray.jpg" else small
        ok, b = cv2.imencode(".jpg", src, params or [])
        files[name] = b.tobytes()
    import io

    exif = Image.Exif()
    exif[0x0112] = 6
    f = io.BytesIO()
    Image.fromarray(small[..., ::-1]).save(f, "JPEG", quality=90, exif=exif)
    files["small_exif6.jpg"] = f.getvalue()
    r = np.random.RandomState(6)
    for ctype, depth, ch in ((0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1),
                             (0, 16, 1), (2, 8, 3), (2, 16, 3), (3, 1, 1),
                             (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2),
                             (4, 16, 2), (6, 8, 4), (6, 16, 4)):
        samples = r.randint(0, 1 << depth, (13, 17, ch))
        plte = r.randint(0, 256, 3 * min(256, 1 << depth)).astype(
            np.uint8).tobytes() if ctype == 3 else None
        files[f"png_c{ctype}_d{depth}.png"] = png_bytes(
            samples, depth, ctype, plte, (0, 1, 2, 3, 4))
    hashes = {}
    os.makedirs(out_dir, exist_ok=True)
    for name, data in sorted(files.items()):
        path = os.path.join(out_dir, name)
        with open(path, "wb") as fh:
            fh.write(data)
        h = {"color": digest(cv2.imread(path, cv2.IMREAD_COLOR)),
             "gray": digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE))}
        # read_indexed_mask's domain: palette PNGs and 8-bit ones
        if name.endswith(".png") and (data[25] == 3 or data[24] == 8):
            h["index"] = digest(
                np.atleast_3d(np.array(Image.open(path)))[..., 0])
        hashes[name] = h
    with open(os.path.join(out_dir, "hashes.json"), "w") as fh:
        json.dump(hashes, fh, indent=1, sort_keys=True)
    return hashes


if __name__ == "__main__":
    for name, h in write().items():
        print(name, os.path.getsize(os.path.join(HERE, name)), sorted(h))
