"""Box, track and mask drawing on uint8 HWC numpy images without OpenCV
(port of unicorn_tpu/utils/visualize.py; the reference's
unicorn/utils/visualize.py).

`rectangle` is cv2.rectangle with LINE_8 and shift 0, pixel for pixel:
at thickness 1 the four edges are 8-connected lines clipped to the image;
at thickness t >= 2 each edge is a filled band of half-width
((t << 15) + (t & 1) * 32768) / 65536 px around it (cv2's ThickLine
polygon, filled by data/image_io.py `fill_poly`) and every corner gets
cv2's filled midpoint circle of radius ((t << 15) + 32768) >> 16 (the
round caps); a negative thickness fills the box.

`put_text` stands in for cv2.putText(FONT_HERSHEY_SIMPLEX), whose stroke
glyphs have no cv2-free equal: it draws the same string at the same origin
in the same colour in a 5x7 bitmap font held below, scaled to the font
scale, and keeps every pixel inside the box cv2.getTextSize gives for that
string, scale and thickness ([org.x, org.x + width] x [org.y - height,
org.y]; the pen advances by Hershey simplex's advance widths, floored to
whole pixels less one, so the text spans nearly what cv2's does). Lower-
case letters are drawn as capitals, any character outside ASCII 32-126 as
'?'. Outside the label boxes the drawers are cv2's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np

from ..data.image_io import fill_poly

_COLORS = (np.array([
    [0.000, 0.447, 0.741], [0.850, 0.325, 0.098], [0.929, 0.694, 0.125],
    [0.494, 0.184, 0.556], [0.466, 0.674, 0.188], [0.301, 0.745, 0.933],
    [0.635, 0.078, 0.184], [0.300, 0.300, 0.300], [0.600, 0.600, 0.600],
    [1.000, 0.000, 0.000], [1.000, 0.500, 0.000], [0.749, 0.749, 0.000],
    [0.000, 1.000, 0.000], [0.000, 0.000, 1.000], [0.667, 0.000, 1.000],
]) * 255).astype(np.uint8)

# Hershey simplex advance widths of ASCII 32..126 at font scale 1 (px):
# cv2.getTextSize of the character alone at scale 100 and thickness 0,
# less the one pixel that every string's width carries, over 100
_ADVANCE = (
    7.45, 7.05, 10.78, 20.12, 17.83, 21.97, 20.06, 6.27, 17.86, 17.86, 12.86,
    17.95, 7.19, 13.99, 7.25, 13.9, 17.86, 17.86, 17.86, 17.86, 17.86, 17.86,
    17.86, 17.86, 17.86, 17.86, 7.4, 7.83, 14.19, 16.44, 14.16, 15.35, 24.02,
    19.34, 19.31, 19.25, 19.88, 17.51, 16.88, 19.65, 20.61, 7.86, 18.29,
    17.37, 16.24, 22.95, 20.06, 19.57, 18.55, 19.57, 18.93, 17.98, 16.7,
    20.26, 18.9, 23.12, 18.29, 18.67, 17.34, 9.39, 13.9, 9.39, 12.45, 21.59,
    9.74, 15.95, 17.2, 15.95, 17.2, 16.18, 11.1, 17.22, 17.57, 6.96, 7.34,
    14.91, 7.02, 25.7, 17.49, 16.56, 17.22, 17.22, 10.95, 14.74, 11.3, 17.37,
    15.98, 23.15, 15.58, 15.92, 14.68, 10.63, 6.7, 10.63, 16.18)
_CAP = 21.0   # the simplex capitals' height at scale 1 (px)
_HEIGHT = 26  # getTextSize's height at scale 1, before the thickness term

# 5x7 glyphs: seven rows of five bits each (bit 4 = leftmost column)
_GLYPHS = {
    " ": "00000000000000", "!": "04040404040004", '"': "0A0A0A00000000",
    "#": "0A0A1F0A1F0A0A", "$": "040F140E051E04", "%": "18190204081303",
    "&": "0C121408151209", "'": "0C040800000000", "(": "02040808080402",
    ")": "08040202020408", "*": "0004150E150400", "+": "0004041F040400",
    ",": "000000000C0408", "-": "0000001F000000", ".": "00000000000C0C",
    "/": "00010204081000", "0": "0E11131519110E", "1": "040C040404040E",
    "2": "0E11010204081F", "3": "1F02040201110E",
    "4": "02060A121F0202", "5": "1F101E0101110E", "6": "0608101E11110E",
    "7": "1F010204080808", "8": "0E11110E11110E", "9": "0E11110F01020C",
    ":": "000C0C000C0C00", ";": "000C0C000C0408", "<": "02040810080402",
    "=": "00001F001F0000", ">": "08040201020408", "?": "0E110102040004",
    "@": "0E11010D15150E", "A": "0E1111111F1111", "B": "1E11111E11111E",
    "C": "0E11101010110E", "D": "1C12111111121C", "E": "1F10101E10101F",
    "F": "1F10101E101010", "G": "0E11101711110F", "H": "1111111F111111",
    "I": "0E04040404040E", "J": "0702020202120C", "K": "11121418141211",
    "L": "1010101010101F", "M": "111B1515111111", "N": "11111915131111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D",
    "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404040404",
    "U": "1111111111110E", "V": "11111111110A04", "W": "1111111515150A",
    "X": "11110A040A1111", "Y": "1111110A040404", "Z": "1F01020408101F",
    "[": "0E08080808080E", "\\": "00100804020100", "]": "0E02020202020E",
    "^": "040A1100000000", "_": "0000000000001F", "`": "08040200000000",
    "{": "02040408040402", "|": "04040404040404", "}": "08040402040408",
    "~": "00000815020000",
}


def _glyph(c: str) -> np.ndarray:
    """The (7, 5) bool bitmap of character c."""
    code = _GLYPHS.get(c.upper(), _GLYPHS["?"])
    rows = [int(code[2 * i:2 * i + 2], 16) for i in range(7)]
    return np.array([[(r >> (4 - j)) & 1 for j in range(5)] for r in rows],
                    bool)


def _color(img: np.ndarray, color):
    c = np.asarray(color, np.float64).reshape(-1)
    if img.ndim == 2:
        return img.dtype.type(c[0])
    return np.resize(c, img.shape[2]).astype(img.dtype)


def _hline(img, y, x0, x1, color):
    """Pixels x0..x1 of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        a, b = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
        if a <= b:
            img[y, a:b + 1] = color


def _vline(img, x, y0, y1, color):
    h, w = img.shape[:2]
    if 0 <= x < w:
        a, b = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
        if a <= b:
            img[a:b + 1, x] = color


def _circle(img, cx, cy, radius, color):
    """cv2's filled midpoint circle (drawing.cpp Circle, fill = 1),
    clipped to the image."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _fill_polygon(img, pts, color):
    """fill_poly of one integer polygon in the window of its bounding box
    that lies in the image (the window's edges are the image's edges where
    the polygon is clipped), the colour set where it filled."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    x0, y0 = max(int(pts[:, 0].min()), 0), max(int(pts[:, 1].min()), 0)
    x1 = min(int(pts[:, 0].max()), w - 1)
    y1 = min(int(pts[:, 1].max()), h - 1)
    if x0 > x1 or y0 > y1:
        return
    mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.uint8)
    fill_poly(mask, [pts - (x0, y0)], 1)
    img[y0:y1 + 1, x0:x1 + 1][mask.astype(bool)] = color


def line(img: np.ndarray, pt1, pt2, color):
    """An 8-connected one-pixel line from pt1 to pt2, both ends included
    (Bresenham), clipped to the image; in place, returns img."""
    col = _color(img, color)
    (x0, y0), (x1, y1) = (int(v) for v in pt1), (int(v) for v in pt2)
    n = max(abs(x1 - x0), abs(y1 - y0)) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(np.int64)
    ys = np.rint(np.linspace(y0, y1, n)).astype(np.int64)
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = col
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1):
    """cv2.rectangle(img, pt1, pt2, color, thickness) with LINE_8, in
    place on an (H, W) or (H, W, C) uint8 image. Returns img."""
    col = _color(img, color)
    (xa, ya), (xb, yb) = (int(v) for v in pt1), (int(v) for v in pt2)
    v = [(xa, ya), (xb, ya), (xb, yb), (xa, yb)]
    if thickness < 0:
        _fill_polygon(img, v, col)
        return img
    if thickness <= 1:
        for (x0, y0), (x1, y1) in zip(v[-1:] + v[:-1], v):
            if y0 == y1:
                _hline(img, y0, x0, x1, col)
            else:
                _vline(img, x0, y0, y1, col)
        return img
    half = ((thickness << 15) + (thickness & 1) * 32768) / 65536.0
    radius = ((thickness << 15) + 32768) >> 16
    for (x0, y0), (x1, y1) in zip(v[-1:] + v[:-1], v):
        if (x0, y0) != (x1, y1):
            # the edge's band: its two ends moved by +-half across it
            dx, dy = (0, half) if y0 == y1 else (half, 0)
            dx, dy = int(dx), int(dy)
            _fill_polygon(img, [(x0 + dx, y0 + dy), (x0 - dx, y0 - dy),
                                (x1 - dx, y1 - dy), (x1 + dx, y1 + dy)],
                          col)
        _circle(img, x1, y1, radius, col)
    return img


def _advances(text: str, scale: float):
    """Each character's advance in whole pixels at `scale`: its Hershey
    advance floored, less one pixel, so that the sum stays inside the width
    cv2.getTextSize gives the string (OpenCV 5 places the glyphs of small
    text on whole pixels)."""
    return [max(int(math.floor(_ADVANCE[ord(c) - 32 if 32 <= ord(c) < 127
                                        else 31] * scale)) - 1, 0)
            for c in text]


def text_size(text: str, scale: float, thickness: int):
    """(width, height) of the box put_text keeps its pixels in: no larger
    than cv2.getTextSize's for FONT_HERSHEY_SIMPLEX."""
    return (sum(_advances(text, scale)),
            int(math.floor(_HEIGHT * scale + (thickness + 1) // 2)))


def put_text(img: np.ndarray, text: str, org, scale: float, color,
             thickness: int = 1):
    """Draw `text` with its baseline's left end at org (x, y), capitals
    floor(21 * scale) px tall, each character centred in its advance
    (`_advances`); thickness >= 2 doubles the strokes one pixel to the
    right. Every pixel lies in [org.x, org.x + width) x [org.y - height,
    org.y), (width, height) = text_size(...). In place; returns img."""
    col = _color(img, color)
    h, w = img.shape[:2]
    x_org, y_org = int(org[0]), int(org[1])
    height = text_size(text, scale, thickness)[1]
    gh = min(max(int(math.floor(_CAP * scale)), 1), height)
    x0 = x_org
    for c, adv in zip(text, _advances(text, scale)):
        cell_w = min(max(int(round(gh * 5 / 7)), 1), adv)
        x1, x0 = x0, x0 + adv
        if cell_w <= 0:
            continue
        g = _glyph(c if 32 <= ord(c) < 127 else "?")
        rows = np.minimum((np.arange(gh) * 7) // gh, 6)
        cols = np.minimum((np.arange(cell_w) * 5) // cell_w, 4)
        cell = g[rows[:, None], cols[None, :]]
        if thickness >= 2 and cell_w < adv:
            cell = np.pad(cell, ((0, 0), (0, 1)))
            cell[:, 1:] |= cell[:, :-1].copy()
        ys, xs = np.nonzero(cell)
        ys = ys + y_org - gh
        xs = xs + x1 + (adv - cell.shape[1]) // 2
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = col
    return img


def draw_detections(img, dets, class_names=None):
    """dets: (N, 7) [x1, y1, x2, y2, obj, cls_conf, cls_id]."""
    vis = img.copy()
    if dets is None or len(dets) == 0:
        return vis
    for d in dets:
        x1, y1, x2, y2 = map(int, d[:4])
        cls_id = int(d[6]) if len(d) > 6 else 0
        score = float(d[4] * d[5]) if len(d) > 6 else float(d[4])
        color = tuple(int(c) for c in _COLORS[cls_id % len(_COLORS)])
        rectangle(vis, (x1, y1), (x2, y2), color, 2)
        name = class_names[cls_id] if class_names else str(cls_id)
        put_text(vis, f"{name}:{score:.2f}", (x1, max(y1 - 4, 10)), 0.5,
                 color, 1)
    return vis


def draw_tracks(img, tlwhs, track_ids, scores=None):
    vis = img.copy()
    for tlwh, tid in zip(tlwhs, track_ids):
        x, y, w, h = map(int, tlwh)
        color = tuple(int(c) for c in _COLORS[int(tid) % len(_COLORS)])
        rectangle(vis, (x, y), (x + w, y + h), color, 2)
        put_text(vis, str(int(tid)), (x, max(y - 4, 10)), 0.6, color, 2)
    return vis


def draw_masks(img, mask_indexed, alpha=0.5):
    """mask_indexed: (H, W) int labels."""
    vis = img.copy().astype(np.float32)
    for oid in np.unique(mask_indexed):
        if oid == 0:
            continue
        color = _COLORS[int(oid) % len(_COLORS)].astype(np.float32)
        m = mask_indexed == oid
        vis[m] = vis[m] * (1 - alpha) + color * alpha
    return vis.astype(np.uint8)
