"""The port's image reader (unicorn_torch/data/image_io.py over
csrc/imcodec.cpp) against OpenCV and PIL, on the CPU: every decode and
every polygon fill is held to equality, not to a tolerance.

  * JPEGs written by cv2 and PIL at qualities 10-100, sampling 4:4:4 /
    4:2:2 / 4:2:0 / 4:4:0 / 4:1:1 and grayscale, at sizes 1x1 to 33x47
    (the odd ones cut MCUs, where fancy upsampling replicates its edges),
    baseline, progressive (successive-approximation scans) and with
    restart intervals: equal to cv2.imread for IMREAD_COLOR and
    IMREAD_GRAYSCALE.
  * EXIF orientations 0-9 in JPEG (APP1) and PNG (eXIf): equal to cv2.
  * PNGs of every colour type and bit depth, each filter: equal to cv2
    (colour and gray); read_indexed_mask equal to PIL's first channel.
  * fill_poly against cv2.fillPoly on seeded random, outside-the-image,
    degenerate (collinear, repeated, horizontal, < 3 points) and
    multi-contour polygons.
  * The committed fixtures' decodes reproduce hashes.json (written from
    cv2 / PIL by tests/torch_fixtures/make_fixtures.py), and the script
    itself reproduces them here.
  * Errors: a missing file, CMYK, arithmetic coding, 12-bit samples, an
    interlaced PNG, a gray read of a colour PNG with gAMA / sRGB, a bad
    CRC, data that is no image, a failed build; corrupted files decode or
    raise, never crash.
"""
import io
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from unicorn_torch.csrc import build
from unicorn_torch.data import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
sys.path.insert(0, FIXTURES)
import make_fixtures  # noqa: E402

SIZES = [(1, 1), (1, 2), (2, 1), (3, 5), (8, 8), (9, 17), (16, 16),
         (17, 33), (31, 2), (2, 31), (33, 47)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.fixture(scope="module", autouse=True)
def _built():
    torch.set_num_threads(1)
    image_io._library()  # one build (or cache hit) for the file


def _image(h, w, seed):
    a = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(a, (5, 5), 1.5) if h > 4 and w > 4 else a


def _assert_like_cv2(buf, what):
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), flags)
        got = image_io.imdecode(buf, flags)
        assert ref is not None, what
        assert got.shape == ref.shape and got.dtype == ref.dtype, (what, flags)
        assert np.array_equal(got, ref), (what, flags, int(np.abs(
            got.astype(int) - ref).max()))


@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_cv2_jpegs(sampling):
    for i, (h, w) in enumerate(SIZES):
        a = _image(h, w, i)
        for q in (10, 50, 75, 90, 100):
            if sampling == "gray":
                ok, b = cv2.imencode(".jpg", a[..., 0],
                                     [cv2.IMWRITE_JPEG_QUALITY, q])
            else:
                ok, b = cv2.imencode(".jpg", a, [
                    cv2.IMWRITE_JPEG_QUALITY, q,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
            _assert_like_cv2(b.tobytes(), f"{sampling} {h}x{w} q{q}")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_jpegs(subsampling):
    """PIL's writer: 4:4:4 / 4:2:2 / 4:2:0, baseline and progressive."""
    for i, (h, w) in enumerate(SIZES):
        a = _image(h, w, 100 + i)
        for q in (10, 60, 95):
            for progressive in (False, True):
                f = io.BytesIO()
                Image.fromarray(a[..., ::-1]).save(
                    f, "JPEG", quality=q, subsampling=subsampling,
                    progressive=progressive)
                _assert_like_cv2(f.getvalue(), f"pil {subsampling} {h}x{w} "
                                 f"q{q} progressive {progressive}")


@pytest.mark.parametrize("mode", ["progressive", "restart1", "restart3"])
def test_progressive_and_restart_jpegs(mode):
    """libjpeg's progression script (spectral selection, then successive
    approximation refinements) and restart intervals of 1 and 3 MCUs,
    at odd sizes and one 4:2:0 frame of 67x131."""
    params = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "restart1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
              "restart3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}[mode]
    for i, (h, w) in enumerate(SIZES + [(67, 131)]):
        a = _image(h, w, 200 + i)
        for q in (20, 90):
            ok, b = cv2.imencode(".jpg", a, [cv2.IMWRITE_JPEG_QUALITY, q]
                                 + params)
            _assert_like_cv2(b.tobytes(), f"{mode} {h}x{w} q{q}")
            ok, b = cv2.imencode(".jpg", a[..., 1], [
                cv2.IMWRITE_JPEG_QUALITY, q] + params)
            _assert_like_cv2(b.tobytes(), f"{mode} gray {h}x{w} q{q}")


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_exif_orientation(fmt):
    """Orientations 1-8 (and 0 / 9, which cv2 ignores) on a 37x53 image:
    5-8 read back as 53x37 in both modes."""
    a = _image(37, 53, 7)
    for o in range(10):
        exif = Image.Exif()
        exif[0x0112] = o
        f = io.BytesIO()
        Image.fromarray(a).save(f, fmt, exif=exif, **(
            {"quality": 90} if fmt == "JPEG" else {}))
        _assert_like_cv2(f.getvalue(), f"{fmt} orientation {o}")
        got = image_io.imdecode(f.getvalue(), image_io.IMREAD_GRAYSCALE)
        assert got.shape == ((53, 37) if 5 <= o <= 8 else (37, 53))


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_pngs(ctype, depth, tmp_path):
    """Every colour type and bit depth, each of the five filters alone and
    mixed by row, odd sizes; colour rows that are sometimes gray (libpng's
    rgb_to_gray passes those through); a palette shorter than the indices
    (libpng's zero entries). read_indexed_mask against PIL where it is
    defined (palette and 8-bit PNGs)."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype * 100 + depth)
    for h, w in ((1, 1), (3, 5), (17, 33)):
        s = rng.randint(0, 1 << depth, (h, w, ch))
        if ch >= 3:
            s[::2, :, 1] = s[::2, :, 2] = s[::2, :, 0]
        n_pal = min(256, 1 << depth) - (5 if depth == 8 else 0)
        plte = rng.randint(0, 256, 3 * n_pal).astype(np.uint8).tobytes() \
            if ctype == 3 else None
        for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
            b = make_fixtures.png_bytes(s, depth, ctype, plte, filters)
            _assert_like_cv2(b, f"c{ctype} d{depth} {h}x{w} {filters}")
            if ctype == 3 or depth == 8:
                p = tmp_path / "m.png"
                p.write_bytes(b)
                ref = np.atleast_3d(np.array(Image.open(p)))[..., 0]
                got = image_io.read_indexed_mask(p)
                assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_writers_pngs_and_palette_luma(tmp_path):
    """PNGs as cv2 and PIL write them (8 / 16-bit, gray, BGR, BGRA, a
    palette mask): IMREAD_GRAYSCALE of a palette mask is luma, not the
    ids, which read_indexed_mask keeps."""
    rng = np.random.RandomState(8)
    for a in (rng.randint(0, 256, (20, 30, 3)).astype(np.uint8),
              rng.randint(0, 1 << 16, (20, 30, 3)).astype(np.uint16),
              rng.randint(0, 256, (20, 30)).astype(np.uint8),
              rng.randint(0, 1 << 16, (20, 30)).astype(np.uint16),
              rng.randint(0, 256, (20, 30, 4)).astype(np.uint8)):
        ok, b = cv2.imencode(".png", a)
        _assert_like_cv2(b.tobytes(), f"cv2 png {a.shape} {a.dtype}")
    ids = rng.randint(0, 4, (10, 12)).astype(np.uint8)
    m = Image.fromarray(ids, "P")
    m.putpalette(list(make_fixtures.DAVIS_PALETTE))
    p = tmp_path / "mask.png"
    m.save(p)
    _assert_like_cv2(p.read_bytes(), "PIL palette")
    assert np.array_equal(image_io.read_indexed_mask(p), ids)
    luma = image_io.imread(p, image_io.IMREAD_GRAYSCALE)
    assert set(np.unique(luma)) <= {0, 38, 75, 113}
    assert np.array_equal(luma, cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))


def _polys(rng, h, w, mode):
    k = rng.randint(1, 12)
    if mode == "inside":
        pts = rng.uniform(0, 1, (k, 2)) * [w, h]
    elif mode == "border":  # COCO's: vertices on [0, w] x [0, h]
        pts = np.round(rng.uniform(0, 1, (k, 2)) * [w, h] * 2) / 2
    elif mode == "outside":
        pts = rng.uniform(-3, 3, (k, 2)) * [w, h]
    else:  # collinear, repeated, horizontal
        base = rng.uniform(0, 1, 2) * [w, h]
        pts = base + np.outer(rng.uniform(-1, 1, k),
                              rng.uniform(-1, 1, 2) * [w, h])
        if rng.rand() < 0.5:
            pts[:, 1] = pts[0, 1]
        if rng.rand() < 0.3:
            pts = np.repeat(pts[:1], k, 0)
    polys = [pts]
    if rng.rand() < 0.25:
        polys.append(rng.uniform(-0.2, 1.2, (rng.randint(1, 8), 2)) * [w, h])
    return polys


@pytest.mark.parametrize("mode", ["inside", "border", "outside",
                                  "degenerate"])
def test_fill_poly(mode):
    rng = np.random.RandomState(["inside", "border", "outside",
                                 "degenerate"].index(mode))
    for _ in range(400):
        h, w = rng.randint(1, 64, 2)
        polys = _polys(rng, h, w, mode)
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, [p.astype(np.int32) for p in polys], 3)
        got = image_io.fill_poly(np.zeros((h, w), np.uint8), polys, 3)
        assert np.array_equal(got, ref), (h, w, [p.astype(np.int32).tolist()
                                                  for p in polys])
    # one polygon at a time onto the same mask, as the COCO loader fills
    ref = np.zeros((480, 640), np.uint8)
    got = ref.copy()
    for _ in range(6):
        pts = rng.uniform(-20, 660, (rng.randint(3, 40), 2))
        cv2.fillPoly(ref, [pts.astype(np.int32)], 1)
        image_io.fill_poly(got, [pts], 1)
    assert np.array_equal(got, ref)


def test_fixture_hashes(tmp_path):
    """Every committed fixture decodes to the digests hashes.json holds,
    and the fixture script, run here, writes the same files and digests
    (cv2 and PIL agree with the record)."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    assert len(hashes) >= 20
    for name, h in hashes.items():
        path = os.path.join(FIXTURES, name)
        for kind, want in h.items():
            got = image_io.read_indexed_mask(path) if kind == "index" else \
                image_io.imread(path, image_io.IMREAD_COLOR if kind == "color"
                                else image_io.IMREAD_GRAYSCALE)
            assert make_fixtures.digest(got) == want, (name, kind)
    small = {k: v for k, v in hashes.items() if "1080" not in k}
    assert {k: v for k, v in make_fixtures.write(str(tmp_path)).items()
            if k in small} == small


def _jpeg_with(byte_at, value, src=None):
    ok, b = cv2.imencode(".jpg", _image(16, 16, 9) if src is None else src)
    b = bytearray(b.tobytes())
    i = b.index(b"\xff\xc0")
    b[i + byte_at] = value
    return bytes(b)


def test_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.jpg"):
        image_io.imread(tmp_path / "nope.jpg")
    with pytest.raises(FileNotFoundError, match="nope.png"):
        image_io.read_indexed_mask(tmp_path / "nope.png")
    f = io.BytesIO()
    Image.new("CMYK", (8, 8), (1, 2, 3, 4)).save(f, "JPEG")
    p = tmp_path / "cmyk.jpg"
    p.write_bytes(f.getvalue())
    with pytest.raises(NotImplementedError, match="cmyk.jpg.*4-component"):
        image_io.imread(p)
    for byte_at, value, what in ((1, 0xC9, "arithmetic"),
                                 (4, 12, "12-bit"),
                                 (1, 0xC3, "lossless")):
        p = tmp_path / f"{what}.jpg"
        p.write_bytes(_jpeg_with(byte_at, value))
        with pytest.raises(NotImplementedError, match=f"{what}.jpg.*{what}"):
            image_io.imread(p)
    b = bytearray(make_fixtures.png_bytes(np.zeros((4, 4, 1), int), 8, 0))
    b[28] = 1  # IHDR's interlace method: Adam7
    b[29:33] = struct.pack(">I", zlib.crc32(bytes(b[12:29])))
    p = tmp_path / "adam7.png"
    p.write_bytes(bytes(b))
    with pytest.raises(NotImplementedError, match="adam7.png.*interlaced"):
        image_io.imread(p)
    b[30] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        image_io.imdecode(bytes(b))
    # a gamma other than 1.0 or an sRGB chunk: libpng's gray conversion of
    # colour goes through gamma tables, which the port refuses; the colour
    # read and a gAMA of exactly 1.0 are unaffected
    rgb = make_fixtures.png_bytes(np.random.RandomState(5).randint(
        0, 256, (9, 11, 3)), 8, 2)
    for kind, body in ((b"gAMA", struct.pack(">I", 45455)),
                       (b"sRGB", b"\0"), (b"gAMA", struct.pack(">I", 100000))):
        chunk = struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
        data = rgb[:33] + chunk + rgb[33:]
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(image_io.imdecode(data), ref)
        if body == struct.pack(">I", 100000):
            _assert_like_cv2(data, "gAMA 1.0")
            continue
        with pytest.raises(NotImplementedError, match="gAMA / sRGB"):
            image_io.imdecode(data, image_io.IMREAD_GRAYSCALE)
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        image_io.imdecode(b"GIF89a....")
    with pytest.raises(ValueError, match="IMREAD"):
        image_io.imdecode(b"\xff\xd8", 2)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises, naming the source: nothing falls back
    to another decoder. A host library's cache key covers its source and
    the compiler, not the CUDA headers."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed for imcodec.cpp"):
        build._compile("imcodec")
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cpp").write_text("// a\n")
    (src / "h.cuh").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", str(src))
    first = build._target("k", "c++")
    (src / "h.cuh").write_text("// b\n")
    assert build._target("k", "c++") == first
    (src / "k.cpp").write_text("// c\n")
    assert len({first, build._target("k", "c++"),
                build._target("k", "g++")}) == 3


def _recrc(png: bytes) -> bytes:
    """The same chunks with their CRCs recomputed (so that a mutation
    reaches the decoder instead of the CRC check)."""
    out, pos = bytearray(png[:8]), 8
    while pos + 8 <= len(png):
        n = struct.unpack(">I", png[pos:pos + 4])[0]
        kind, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if len(body) < n:
            break
        out += png[pos:pos + 8 + n] + struct.pack(">I", zlib.crc32(kind + body))
        pos += 12 + n
    return bytes(out)


def test_corrupt_files_raise_or_decode():
    """Truncated, overwritten, inserted and deleted bytes in every small
    fixture (PNG CRCs recomputed): each read decodes or raises ValueError /
    NotImplementedError, never crashes; a header past OpenCV's 2**30
    pixels and a short IHDR are refused."""
    rng = np.random.RandomState(0)
    names = [n for n in sorted(os.listdir(FIXTURES))
             if n.endswith((".jpg", ".png")) and "1080" not in n]
    for i in range(600):
        b = bytearray(open(os.path.join(FIXTURES, names[i % len(names)]),
                           "rb").read())
        k, at = i % 4, rng.randint(len(b))
        if k == 0:
            b = b[:at]
        elif k == 1:
            for j in rng.randint(0, len(b), rng.randint(1, 8)):
                b[j] = rng.randint(256)
        elif k == 2:
            b[at:at] = rng.randint(0, 256, rng.randint(1, 50)).astype(
                np.uint8).tobytes()
        else:
            del b[at:at + rng.randint(1, 50)]
        if names[i % len(names)].endswith(".png"):
            b = bytearray(_recrc(bytes(b)))
        for flags in (image_io.IMREAD_COLOR, image_io.IMREAD_GRAYSCALE):
            try:
                out = image_io.imdecode(bytes(b), flags)
                assert out.dtype == np.uint8 and out.size > 0
            except (ValueError, NotImplementedError):
                pass
    big = make_fixtures.png_bytes(np.zeros((1, 1, 1), int), 8, 0)
    ihdr = struct.pack(">IIBBBBB", 1 << 16, 1 << 15, 8, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="pixels"):
        image_io.imdecode(_recrc(big[:16] + ihdr + big[29:]))
    short = big[:8] + struct.pack(">I", 12) + b"IHDR" + ihdr[:12] + big[29:]
    with pytest.raises(ValueError, match="IHDR"):
        image_io.imdecode(_recrc(short))
    ok, b = cv2.imencode(".jpg", _image(16, 16, 9))
    jpg = bytearray(b.tobytes())
    i = jpg.index(b"\xff\xc0")  # SOF0: marker, length, precision, H, W
    jpg[i + 5:i + 9] = struct.pack(">HH", 65000, 65000)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        image_io.imdecode(bytes(jpg))
