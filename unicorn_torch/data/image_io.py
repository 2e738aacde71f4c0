"""Image files of the data path without OpenCV or PIL: JPEG and PNG decoded
by the port's host library `csrc/imcodec.cpp` (built with the system C++
compiler on first use, bound here with ctypes), to what `cv2.imread` gives
on an OpenCV built with libjpeg-turbo and libpng, bit for bit.

    imread(path, flags=IMREAD_COLOR)   (H, W, 3) BGR uint8, or (H, W) for
                                       IMREAD_GRAYSCALE, EXIF orientation
                                       applied
    imdecode(buf, flags)               the same from the file's bytes
    read_indexed_mask(path)            a palette PNG's raw indices (H, W)
                                       uint8, as PIL gives them
    read_png(path)                     an 8-bit PNG's stored samples, as
                                       np.asarray(PIL.Image.open(path))
                                       gives them
    write_png(path, array)             (H, W) gray, (H, W, 3) RGB or
                                       (H, W, 4) RGBA uint8 to a PNG file
    fill_poly(mask, polys, value)      cv2.fillPoly(mask, [p.astype(int32)
                                       for p in polys], value), LINE_8

Where cv2.imread returns None, these raise: FileNotFoundError for a file
that cannot be read, ValueError for data that is not a valid JPEG or PNG,
NotImplementedError (naming the file and what it lacks) for arithmetic-coded,
lossless, hierarchical, 12-bit or 4-component JPEGs, interlaced PNGs, and
grayscale reads of colour PNGs that declare a gamma or colour profile
(gAMA other than 1.0, sRGB, iCCP: libpng converts those through gamma
tables).
A failed build raises too: nothing falls back to another decoder. ctypes
releases the interpreter lock during a call, so loader threads decode in
parallel.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 256
_lib = None
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from ..csrc import build

            lib = build.load("imcodec")
            u8p = ctypes.POINTER(ctypes.c_uint8)
            ip = ctypes.POINTER(ctypes.c_int)
            i64 = ctypes.c_int64
            lib.imc_jpeg_header.argtypes = [u8p, i64, ip, ip, ip,
                                            ctypes.c_char_p, ctypes.c_int]
            lib.imc_jpeg_decode.argtypes = [u8p, i64, ctypes.c_int, u8p,
                                            ctypes.c_char_p, ctypes.c_int]
            lib.imc_png_decode.argtypes = [
                u8p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                u8p, ctypes.c_char_p, ctypes.c_int]
            lib.imc_tiff_orientation.argtypes = [u8p, i64]
            lib.imc_fill_poly.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int]
            lib.imc_fill_poly.restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _raise(code: int, err, what: str):
    msg = f"{what}: {err.value.decode(errors='replace')}"
    if code == 1:
        raise NotImplementedError(msg + " is not supported")
    raise ValueError(msg)


def imread(path, flags: int = IMREAD_COLOR) -> np.ndarray:
    """cv2.imread(path, flags) for flags IMREAD_COLOR / IMREAD_GRAYSCALE;
    raises where cv2 returns None."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise FileNotFoundError(f"cannot read image {path}: {e}") from e
    return imdecode(buf, flags, what=str(path))


def imdecode(buf, flags: int = IMREAD_COLOR, what: str = "image buffer"
             ) -> np.ndarray:
    """cv2.imdecode(np.frombuffer(buf, np.uint8), flags)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"flags must be IMREAD_COLOR or IMREAD_GRAYSCALE, "
                         f"got {flags}")
    data = np.frombuffer(bytes(buf) if not isinstance(buf, bytes) else buf,
                         np.uint8)
    gray = flags == IMREAD_GRAYSCALE
    if len(data) >= 2 and data[0] == 0xFF and data[1] == 0xD8:
        return _jpeg(data, gray, what)
    if bytes(data[:8]) == _PNG_SIGNATURE:
        return _png(data, 1 if gray else 0, what)
    raise ValueError(f"{what}: not a JPEG or PNG file")


def _jpeg(data: np.ndarray, gray: bool, what: str) -> np.ndarray:
    lib = _library()
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = lib.imc_jpeg_header(_ptr(data), len(data), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(nc), err, _ERRLEN)
    if code:
        _raise(code, err, what)
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3),
                   np.uint8)
    code = lib.imc_jpeg_decode(_ptr(data), len(data), int(gray), _ptr(out),
                               err, _ERRLEN)
    if code:
        _raise(code, err, what)
    return out


def _png_chunks(data: bytes, what: str):
    """IHDR fields, PLTE, the joined IDAT, the eXIf chunk before the first
    IDAT, and whether a colour profile is declared (a gAMA other than
    1.0, sRGB or iCCP); every chunk's CRC checked."""
    pos = 8
    ihdr = plte = exif = None
    idat = []
    profiled = False
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"{what}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{what}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"{what}: bad PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"eXIf" and not idat:
            exif = body
        elif kind in (b"sRGB", b"iCCP") or (
                kind == b"gAMA" and body != struct.pack(">I", 100000)):
            profiled = True
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{what}: PNG without IHDR or IDAT")
    return ihdr, plte, exif, b"".join(idat), profiled


def _png(data: np.ndarray, mode: int, what: str) -> np.ndarray:
    """mode 0: BGR, 1: gray (cv2.imread's conversions); 2: the first stored
    channel (read_indexed_mask)."""
    (w, h, depth, ctype, _, _, interlace), plte, exif, idat, profiled = \
        _png_chunks(data.tobytes(), what)
    if interlace:
        raise NotImplementedError(f"{what}: interlaced (Adam7) PNG is not "
                                  f"supported")
    if mode == 1 and ctype in (2, 3, 6) and profiled:
        # libpng's rgb_to_gray then works through gamma tables (as for a
        # significant gAMA, an sRGB chunk or a known sRGB ICC profile)
        raise NotImplementedError(
            f"{what}: a grayscale read of a colour PNG with gAMA / sRGB / "
            f"iCCP is not supported")
    if (ctype, depth) not in {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16),
                              (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
                              (4, 8), (4, 16), (6, 8), (6, 16)}:
        raise ValueError(f"{what}: invalid PNG colour type {ctype} at bit "
                         f"depth {depth}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{what}: palette PNG without PLTE")
    if not w or not h or w * h > 1 << 30:  # OpenCV's CV_IO_MAX_IMAGE_PIXELS
        raise ValueError(f"{what}: PNG of {w}x{h} pixels")
    if mode == 2 and ctype != 3 and depth != 8:
        raise NotImplementedError(f"{what}: read_indexed_mask of a {depth}-bit "
                                  f"non-palette PNG is not supported")
    if mode == 3 and depth != 8:
        raise NotImplementedError(f"{what}: read_png of a {depth}-bit PNG is "
                                  f"not supported")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).copy()
    except zlib.error as e:
        raise ValueError(f"{what}: corrupt PNG image data ({e})") from e
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if len(raw) < ((w * channels * depth + 7) // 8 + 1) * h:
        raise ValueError(f"{what}: truncated PNG image data")
    lib = _library()
    orientation = 1
    if exif is not None and mode < 2:
        e = np.frombuffer(exif, np.uint8)
        orientation = lib.imc_tiff_orientation(_ptr(e), len(e))
    shape = (h, w) if orientation < 5 or orientation > 8 else (w, h)
    out = np.empty(shape + ((3,) if mode == 0 else (channels,)
                            if mode == 3 and channels > 1 else ()), np.uint8)
    pal = np.frombuffer(plte or b"\0", np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = lib.imc_png_decode(_ptr(raw), len(raw), w, h, depth, ctype,
                              _ptr(pal), len(pal) // 3, mode, orientation,
                              _ptr(out), err, _ERRLEN)
    if code:
        _raise(code, err, what)
    return out


def read_indexed_mask(path) -> np.ndarray:
    """The object-id plane of a mask PNG, (H, W) uint8: a palette PNG's raw
    indices (the DAVIS / YouTube-VOS annotations; IMREAD_GRAYSCALE would
    give their luma), else the first channel of an 8-bit PNG. What
    `np.atleast_3d(np.array(PIL.Image.open(path)))[..., 0]` gives."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise FileNotFoundError(f"cannot read mask {path}: {e}") from e
    data = np.frombuffer(buf, np.uint8)
    if bytes(data[:8]) != _PNG_SIGNATURE:
        raise NotImplementedError(f"{path}: read_indexed_mask reads PNG "
                                  f"files only")
    return _png(data, 2, str(path))


def read_png(path) -> np.ndarray:
    """The stored samples of an 8-bit PNG, uint8: (H, W) for gray or
    palette indices, (H, W, 2 / 3 / 4) for gray + alpha / RGB / RGBA, in
    the file's channel order and without EXIF orientation; what
    `np.asarray(PIL.Image.open(path))` gives."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise FileNotFoundError(f"cannot read PNG {path}: {e}") from e
    data = np.frombuffer(buf, np.uint8)
    if bytes(data[:8]) != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    return _png(data, 3, str(path))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, array: np.ndarray) -> None:
    """Write an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 array as
    an 8-bit, non-interlaced PNG, every row with filter type 0 (none),
    zlib level 6. read_png and PIL read back the same array. The parent
    directory is created."""
    a = np.ascontiguousarray(array)
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(a.shape[-1])}.get(a.ndim)
    if a.dtype != np.uint8 or ctype is None or 0 in a.shape[:2]:
        raise ValueError(f"write_png takes an (H, W), (H, W, 3) or (H, W, "
                         f"4) uint8 array, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    png = (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def fill_poly(mask: np.ndarray, polys, value: int) -> np.ndarray:
    """cv2.fillPoly(mask, [p.astype(np.int32) for p in polys], value) on an
    (H, W) uint8 array, in place (LINE_8, shift 0: the outlines drawn with
    the 8-connected line iterator, then the even-odd fill of the edges).
    Returns mask."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or \
            not mask.flags.c_contiguous:
        raise ValueError("fill_poly draws on a C-contiguous (H, W) uint8 "
                         "array")
    pts = [np.ascontiguousarray(np.asarray(p).reshape(-1, 2).astype(np.int32))
           for p in polys]
    if not pts:
        return mask
    flat = np.ascontiguousarray(np.concatenate(pts, 0), np.int32)
    npts = np.asarray([len(p) for p in pts], np.int32)
    _library().imc_fill_poly(_ptr(mask), mask.shape[0], mask.shape[1],
                             _ptr(flat, ctypes.c_int32),
                             _ptr(npts, ctypes.c_int32), len(pts), int(value))
    return mask
