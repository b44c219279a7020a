"""A numpy rasterizer for the classic-control frames, without pygame.

gymnasium draws CartPole and Pendulum with pygame's ``gfxdraw`` (the
SDL_gfx primitives) on a 32-bit surface, then flips it vertically. The
functions here are those primitives over an ``[H, W, 3]`` uint8 canvas in
the surface's coordinates (``y`` down, before the flip), with SDL_gfx's
integer arithmetic, so that a frame equals gymnasium's:

- ``hline`` and ``vline``: opaque runs, clipped to the canvas;
- ``filled_polygon``: SDL_gfx's scanline fill, its intersections in 16.16
  fixed point;
- ``aapolygon``: Wu's anti-aliased lines (``_aalineRGBA`` without the end
  point), each edge clipped to the canvas first;
- ``filled_circle`` and ``aacircle``: the midpoint fill and the
  anti-aliased ellipse, whose offsets depend only on the radius and are
  computed once a radius;
- ``smoothscale``: pygame's area-averaging shrink in 14-bit fixed point
  (its SSE path), and ``blit_alpha``, a per-pixel-alpha blit;
- ``line`` and ``aalines``: ``pygame.draw``'s own (not SDL_gfx's) one-pixel
  line, Bresenham's on truncated end points, and its anti-aliased
  polyline, Wu's algorithm in float32 over float end points, each segment
  drawn whole (Acrobot's ground, the Mountain Car track).

A pixel drawn with weight ``w`` and colour alpha ``a`` blends with alpha
``(a * w) >> 8`` as ``d + floor((c - d) * alpha / 256)``; alpha 255 writes
the colour. Every primitive is vectorised over its pixels; a pixel that
one primitive draws twice is blended twice, in the primitive's order.
"""

from __future__ import annotations

import functools
import math
import os
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]


def blend(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color: Color, alpha: np.ndarray) -> None:
    """Blend ``color`` into the pixels ``(xs, ys)`` (distinct) with
    per-pixel ``alpha``; pixels off the canvas are skipped."""
    h, w = img.shape[:2]
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    alpha = np.broadcast_to(np.asarray(alpha, np.int64), xs.shape)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys, alpha = xs[keep], ys[keep], alpha[keep]
    if xs.size == 0:
        return
    c = np.asarray(color, np.int64)
    d = img[ys, xs].astype(np.int64)
    out = d + np.floor_divide((c - d) * alpha[:, None], 256)
    out = np.where((alpha == 255)[:, None], c, out)
    img[ys, xs] = out.astype(np.uint8)


def _weighted(weight: np.ndarray, a: int = 255) -> np.ndarray:
    """``pixelRGBAWeight``'s alpha: ``(a * weight) >> 8``."""
    return (a * np.asarray(weight, np.int64)) >> 8


def hline(img: np.ndarray, x1: int, x2: int, y: int, color: Color) -> None:
    """An opaque run from ``x1`` to ``x2`` inclusive (either order)."""
    h, w = img.shape[:2]
    lo, hi = min(x1, x2), max(x1, x2)
    if y < 0 or y >= h or hi < 0 or lo >= w:
        return
    img[y, max(lo, 0) : min(hi, w - 1) + 1] = color


def vline(img: np.ndarray, x: int, y1: int, y2: int, color: Color) -> None:
    h, w = img.shape[:2]
    lo, hi = min(y1, y2), max(y1, y2)
    if x < 0 or x >= w or hi < 0 or lo >= h:
        return
    img[max(lo, 0) : min(hi, h - 1) + 1, x] = color


def filled_polygon(img: np.ndarray, points: Sequence[Tuple[float, float]], color: Color) -> None:
    """SDL_gfx's ``filledPolygonRGBAMT``: for each scanline the edges'
    16.16 intersections, sorted and filled in pairs."""
    # pygame casts each coordinate to Sint16: toward zero, as int() does
    vx = np.array([int(p[0]) for p in points], np.int64)
    vy = np.array([int(p[1]) for p in points], np.int64)
    n = len(vx)
    if n < 3:
        return
    miny, maxy = int(vy.min()), int(vy.max())
    ys = np.arange(miny, maxy + 1, dtype=np.int64)[:, None]
    i1, i2 = np.roll(np.arange(n), 1), np.arange(n)
    ya, yb = vy[i1], vy[i2]
    down = ya > yb
    y1, y2 = np.where(down, yb, ya), np.where(down, ya, yb)
    x1, x2 = np.where(down, vx[i2], vx[i1]), np.where(down, vx[i1], vx[i2])
    flat = y1 == y2
    span = np.where(flat, 1, y2 - y1)
    hit = (((ys >= y1) & (ys < y2)) | ((ys == maxy) & (ys > y1) & (ys <= y2))) & ~flat
    ints = ((65536 * (ys - y1)) // span) * (x2 - x1) + 65536 * x1
    big = np.iinfo(np.int64).max
    ints = np.sort(np.where(hit, ints, big), axis=1)
    counts = hit.sum(axis=1)
    h, w = img.shape[:2]
    cols = np.arange(w, dtype=np.int64)
    for k in range(0, n - 1, 2):
        valid = counts >= k + 2
        if not valid.any():
            break
        xa = ints[valid, k] + 1
        xa = (xa >> 16) + ((xa & 32768) >> 15)
        xb = ints[valid, k + 1] - 1
        xb = (xb >> 16) + ((xb & 32768) >> 15)
        lo, hi = np.minimum(xa, xb), np.maximum(xa, xb)
        rows = ys[valid, 0]
        inside = (rows >= 0) & (rows < h)
        mask = (cols[None, :] >= lo[inside, None]) & (cols[None, :] <= hi[inside, None])
        r, c = np.nonzero(mask)
        img[rows[inside][r], c] = color


_LEFT, _RIGHT, _BOTTOM, _TOP = 1, 2, 4, 8


def _clip_code(x: int, y: int, right: int, bottom: int) -> int:
    code = 0
    if x < 0:
        code |= _LEFT
    elif x > right:
        code |= _RIGHT
    if y < 0:
        code |= _TOP
    elif y > bottom:
        code |= _BOTTOM
    return code


def _clip_line(x1: int, y1: int, x2: int, y2: int, w: int, h: int):
    """SDL_gfx's ``_clipLine`` (Cohen-Sutherland, a float32 slope, Sint16
    truncation); ``None`` when nothing is left to draw."""
    right, bottom = w - 1, h - 1
    while True:
        c1, c2 = _clip_code(x1, y1, right, bottom), _clip_code(x2, y2, right, bottom)
        if not (c1 | c2):
            return x1, y1, x2, y2
        if c1 & c2:
            return None
        if not c1:
            x1, y1, x2, y2, c1, c2 = x2, y2, x1, y1, c2, c1
        m = np.float32(y2 - y1) / np.float32(x2 - x1) if x2 != x1 else np.float32(1.0)
        if c1 & _LEFT:
            y1 += int(np.float32(0 - x1) * m)
            x1 = 0
        elif c1 & _RIGHT:
            y1 += int(np.float32(right - x1) * m)
            x1 = right
        elif c1 & _BOTTOM:
            if x2 != x1:
                x1 += int(np.float32(bottom - y1) / m)
            y1 = bottom
        elif c1 & _TOP:
            if x2 != x1:
                x1 += int(np.float32(0 - y1) / m)
            y1 = 0


def aaline(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color: Color) -> None:
    """SDL_gfx's ``_aalineRGBA`` without the end point: the start pixel
    opaque, then Wu's pixel pairs weighted by an 8-bit error
    accumulator."""
    h, w = img.shape[:2]
    clipped = _clip_line(x1, y1, x2, y2, w, h)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    xx0, yy0, xx1, yy1 = x1, y1, x2, y2
    if yy0 > yy1:
        xx0, yy0, xx1, yy1 = xx1, yy1, xx0, yy0
    dx, dy = xx1 - xx0, yy1 - yy0
    if dx == 0:
        if dy > 0:
            vline(img, x1, yy0, yy0 + dy, color)
        else:
            blend(img, [x1], [y1], color, 255)
        return
    if dy == 0:
        hline(img, xx0, xx0 + dx, y1, color)
        return
    xdir = 1 if dx >= 0 else -1
    dx = abs(dx)
    blend(img, [x1], [y1], color, 255)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    steps = np.arange(1, major, dtype=np.uint64)
    if steps.size == 0:
        return
    erradj = np.uint64((((minor << 16) // major) << 16) & 0xFFFFFFFF)
    total = steps * erradj
    # a rollover is ``erracc <= previous``: every step when a diagonal's
    # adjustment wraps to 0
    carries = steps.astype(np.int64) if erradj == 0 else (total >> np.uint64(32)).astype(np.int64)
    wgt = ((total & np.uint64(0xFFFFFFFF)) >> np.uint64(24)).astype(np.int64) & 255
    i = steps.astype(np.int64)
    if dy > dx:
        xa = xx0 + xdir * carries
        yb = yy0 + i
        xs, ys = np.concatenate([xa, xa + xdir]), np.concatenate([yb, yb])
    else:
        xb = xx0 + xdir * i
        ya = yy0 + carries
        xs, ys = np.concatenate([xb, xb]), np.concatenate([ya, ya + 1])
    blend(img, xs, ys, color, _weighted(np.concatenate([255 - wgt, wgt])))


def aapolygon(img: np.ndarray, points: Sequence[Tuple[float, float]], color: Color) -> None:
    """SDL_gfx's ``aapolygonRGBA``: each edge in turn, closing the loop."""
    vx = [int(p[0]) for p in points]
    vy = [int(p[1]) for p in points]
    n = len(vx)
    for i in range(n):
        j = (i + 1) % n
        aaline(img, vx[i], vy[i], vx[j], vy[j], color)


@functools.lru_cache(maxsize=None)
def _filled_circle_mask(rad: int) -> Tuple[np.ndarray, np.ndarray]:
    """The offsets SDL_gfx's ``filledCircleColor`` covers at ``rad``."""
    rows: dict = {}

    def run(x_half: int, y: int) -> None:
        rows[y] = max(rows.get(y, -1), x_half)

    cx, cy, ocx, ocy = 0, rad, None, None
    df, d_e, d_se = 1 - rad, 3, -2 * rad + 5
    while True:
        if ocy != cy:
            if cy > 0:
                run(cx, cy)
                run(cx, -cy)
            else:
                run(cx, 0)
            ocy = cy
        if ocx != cx:
            if cx != cy:
                if cx > 0:
                    run(cy, -cx)
                    run(cy, cx)
                else:
                    run(cy, 0)
            ocx = cx
        if df < 0:
            df += d_e
            d_e += 2
            d_se += 2
        else:
            df += d_se
            d_e += 2
            d_se += 4
            cy -= 1
        cx += 1
        if cx > cy:
            break
    xs: List[int] = []
    ys: List[int] = []
    for y, half in rows.items():
        for x in range(-half, half + 1):
            xs.append(x)
            ys.append(y)
    return np.array(xs, np.int64), np.array(ys, np.int64)


def filled_circle(img: np.ndarray, x: int, y: int, rad: int, color: Color) -> None:
    dx, dy = _filled_circle_mask(int(rad))
    blend(img, x + dx, y + dy, color, 255)


@functools.lru_cache(maxsize=None)
def _aacircle_rounds(rad: int) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]:
    """SDL_gfx's ``aaellipseRGBA`` at ``rx = ry = rad`` about the origin, as
    rounds of ``(dx, dy, weight)`` in which no pixel repeats: the k-th
    draw of a pixel is in round k, so the rounds in order blend as the
    serial algorithm does. Weight 256 marks an opaque draw."""
    draws: List[Tuple[int, int, int]] = []
    a2 = b2 = rad * rad
    ds, dt = 2 * a2, 2 * b2
    sab = math.sqrt(float(a2 + b2))
    dxt = int(np.rint(a2 / sab))
    t, s, d = 0, -2 * a2 * rad, 0
    xp, yp = 0, -rad
    for px, py in ((xp, yp), (-xp, yp), (xp, -yp), (-xp, -yp)):
        draws.append((px, py, 256))

    def weight_of(num: int, den: int) -> int:
        cp = np.float32(1.0)
        if den != 0:
            cp = np.float32(abs(num)) / np.float32(abs(den))
            if cp > 1.0:
                cp = np.float32(1.0)
        return int(cp * np.float32(255))

    for _ in range(dxt):
        xp -= 1
        d += t - b2
        if d >= 0:
            ys = yp - 1
        elif (d - s - a2) > 0:
            if (2 * d - s - a2) >= 0:
                ys = yp + 1
            else:
                ys = yp
                yp += 1
                d -= s + a2
                s += ds
        else:
            yp += 1
            ys = yp + 1
            d -= s + a2
            s += ds
        t -= dt
        wt = weight_of(d, s)
        iw = 255 - wt
        xx = -xp
        draws += [(xp, yp, iw), (xx, yp, iw), (xp, ys, wt), (xx, ys, wt)]
        draws += [(xp, -yp, iw), (xx, -yp, iw), (xp, -ys, wt), (xx, -ys, wt)]
    dyt = int(np.rint(b2 / sab))
    for _ in range(dyt):
        yp += 1
        d -= s + a2
        if d <= 0:
            xs = xp + 1
        elif (d + t - b2) < 0:
            if (2 * d + t - b2) <= 0:
                xs = xp - 1
            else:
                xs = xp
                xp -= 1
                d += t - b2
                t -= dt
        else:
            xp -= 1
            xs = xp - 1
            d += t - b2
            t -= dt
        s += ds
        wt = weight_of(d, t)
        iw = 255 - wt
        xx, yy = -xp, -yp
        draws += [(xp, yp, iw), (xx, yp, iw), (xp, yy, iw), (xx, yy, iw)]
        xx = -xs
        draws += [(xs, yp, wt), (xx, yp, wt), (xs, yy, wt), (xx, yy, wt)]
    seen: dict = {}
    rounds: List[List[Tuple[int, int, int]]] = []
    for dx, dy, wt in draws:
        k = seen.get((dx, dy), 0)
        seen[(dx, dy)] = k + 1
        if k == len(rounds):
            rounds.append([])
        rounds[k].append((dx, dy, wt))
    return tuple(tuple(np.array(col, np.int64) for col in zip(*r)) for r in rounds)


def aacircle(img: np.ndarray, x: int, y: int, rad: int, color: Color) -> None:
    """SDL_gfx's ``aacircleRGBA`` (an anti-aliased ellipse with equal
    radii)."""
    for dx, dy, wt in _aacircle_rounds(int(rad)):
        alpha = np.where(wt == 256, 255, _weighted(np.minimum(wt, 255)))
        blend(img, x + dx, y + dy, color, alpha)


@functools.lru_cache(maxsize=None)
def _shrink_plan(n: int, dst_len: int) -> Tuple[np.ndarray, ...]:
    """pygame's shrink filter along an axis of ``n`` pixels to ``dst_len``,
    as index arrays a destination pixel: the pixel whose remainder it
    starts with and that remainder's weight, the whole pixels it sums, and
    the pixel it ends in and its weight (14-bit fixed point), and the
    reciprocal."""
    space = 0x4000 * n // dst_len
    counter = space
    begin, begin_w, first, last, end, end_w = [], [], [], [], [], []
    prev, prev_w, start = -1, 0, 0
    for i in range(n):
        if counter > 0x4000:
            counter -= 0x4000
        else:
            begin.append(prev)
            begin_w.append(prev_w)
            first.append(start)
            last.append(i)
            end.append(i)
            end_w.append(counter)
            prev, prev_w, start = i, 0x4000 - counter, i + 1
            counter += space - 0x4000
    k = min(len(end), dst_len)
    cols = (np.array(a[:k], np.int64) for a in (begin, begin_w, first, last, end, end_w))
    return (*cols, 0x40000000 // space)


def _shrink_axis(src: np.ndarray, dst_len: int, axis: int) -> np.ndarray:
    """pygame's area-averaging shrink along ``axis`` (``filter_shrink_X``
    and ``_Y`` of its SSE path): 14-bit coverage of the pixels a destination
    pixel spans, each partial pixel's product floored, a 16-bit
    accumulator, an unsigned multiply-high by the reciprocal, saturated to
    uint8. A destination pixel the filter never reaches stays 0."""
    src = np.moveaxis(src.astype(np.int64), axis, 0)
    begin, begin_w, first, last, end, end_w, recip = _shrink_plan(src.shape[0], dst_len)
    sums = np.concatenate([np.zeros_like(src[:1]), np.cumsum(src, axis=0)])
    whole = sums[last] - sums[first]
    expand = (slice(None),) + (None,) * (src.ndim - 1)
    s4 = src << 2
    head = np.where((begin >= 0)[expand], (s4[np.maximum(begin, 0)] * begin_w[expand]) >> 16, 0)
    tail = (s4[end] * end_w[expand]) >> 16
    val = (((head + whole + tail) & 0xFFFF) * recip) >> 16
    out = np.zeros((dst_len,) + src.shape[1:], np.int64)
    out[: len(end)] = np.where(val >= 0x8000, 0, np.minimum(val, 255))
    return np.moveaxis(out, 0, axis)


def smoothscale(rgba: np.ndarray, width: int, height: int) -> np.ndarray:
    """``pygame.transform.smoothscale`` of an ``[H, W, 4]`` image to a
    smaller ``[height, width, 4]`` (the only direction the frames need):
    X first, then Y."""
    h, w = rgba.shape[:2]
    if width > w or height > h:
        raise ValueError(f"smoothscale here only shrinks: {w}x{h} to {width}x{height}")
    if width == 0 or height == 0:
        return np.zeros((height, width, rgba.shape[2]), np.uint8)
    out = rgba.astype(np.int64)
    if width < w:
        out = _shrink_axis(out, width, axis=1)
    if height < h:
        out = _shrink_axis(out, height, axis=0)
    return out.astype(np.uint8)


def blit_alpha(img: np.ndarray, src_rgba: np.ndarray, x: int, y: int) -> None:
    """A per-pixel-alpha blit of ``src_rgba`` with its top-left at
    ``(x, y)``: alpha 0 leaves the pixel, 255 writes it, others blend as
    ``d + floor((s - d) * alpha / 256)``."""
    h, w = img.shape[:2]
    sh, sw = src_rgba.shape[:2]
    x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + sw, w), min(y + sh, h)
    if x0 >= x1 or y0 >= y1:
        return
    src = src_rgba[y0 - y : y1 - y, x0 - x : x1 - x].astype(np.int64)
    dst = img[y0:y1, x0:x1].astype(np.int64)
    a = src[..., 3:4]
    out = dst + np.floor_divide((src[..., :3] - dst) * a, 256)
    out = np.where(a == 255, src[..., :3], out)
    img[y0:y1, x0:x1] = out.astype(np.uint8)


def line(img: np.ndarray, start: Tuple[float, float], end: Tuple[float, float], color: Color) -> None:
    """``pygame.draw.line`` at width 1: the end points truncated toward
    zero, then Bresenham's walk from ``start`` with both ends drawn, each
    pixel clipped to the canvas. Equal to pygame's where both ends lie on
    the canvas and for every horizontal or vertical line; pygame moves an
    end off the canvas onto its edge before the walk, which this does not
    copy (a diagonal leaving the canvas may then differ by a row)."""
    x1, y1, x2, y2 = int(start[0]), int(start[1]), int(end[0]), int(end[1])
    if y1 == y2:
        hline(img, x1, x2, y1, color)
        return
    if x1 == x2:
        vline(img, x1, y1, y2, color)
        return
    dx, sx = abs(x2 - x1), 1 if x1 < x2 else -1
    dy, sy = abs(y2 - y1), 1 if y1 < y2 else -1
    # C's int division: toward zero
    err = int((dx if dx > dy else -dy) / 2)
    xs, ys = [], []
    while x1 != x2 or y1 != y2:
        xs.append(x1)
        ys.append(y1)
        e2 = err
        if e2 > -dx:
            err -= dy
            x1 += sx
        if e2 < dy:
            err += dx
            y1 += sy
    xs.append(x2)
    ys.append(y2)
    blend(img, np.array(xs), np.array(ys), color, 255)


_F = np.float32


def _aa_blend(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color: Color, brightness: np.ndarray) -> None:
    """pygame.draw's anti-aliased pixel at ``(xs, ys)`` (distinct; off the
    canvas skipped): ``(Uint8)(b * c + (1 - b) * d)`` in float32, the cast
    through an int as the C compiler does it."""
    h, w = img.shape[:2]
    xs, ys = np.atleast_1d(np.asarray(xs, np.int64)), np.atleast_1d(np.asarray(ys, np.int64))
    b = np.broadcast_to(np.asarray(brightness, _F), xs.shape)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys, b = xs[keep], ys[keep], b[keep][:, None]
    if xs.size == 0:
        return
    mixed = b * np.asarray(color, _F) + (_F(1) - b) * img[ys, xs].astype(_F)
    img[ys, xs] = (mixed.astype(np.int64) & 0xFF).astype(np.uint8)


def draw_aaline(img: np.ndarray, start: Tuple[float, float], end: Tuple[float, float], color: Color) -> None:
    """``pygame.draw.aaline`` (pygame 2.6's ``draw_aaline``): the end
    points as float32, the line clipped to one pixel beyond the canvas,
    both end pixels weighted by their coverage, and between them two
    pixels a column (a row when steep) weighted by the distance to the
    line, its height accumulated in float32 from column to column."""
    h, w = img.shape[:2]
    fx, fy, tx, ty = _F(start[0]), _F(start[1]), _F(end[0]), _F(end[1])
    dx, dy = tx - fx, ty - fy
    if abs(float(dx)) < 0.0001 and abs(float(dy)) < 0.0001:
        _aa_blend(img, math.floor(float(fx) + 0.5), math.floor(float(fy) + 0.5), color, 1.0)
        return
    left, right, top, bottom = _F(-1), _F(w), _F(-1), _F(h)
    steep = abs(dx) < abs(dy)
    if steep:
        fx, fy, tx, ty, dx, dy = fy, fx, ty, tx, dy, dx
        left, top, right, bottom = top, left, bottom, right
    if dx < 0:
        fx, tx, fy, ty, dx, dy = tx, fx, ty, fy, -dx, -dy
    if tx <= left or fx >= right:
        return
    g = dy / dx
    if fx < left:
        fy, fx = fy + g * (left - fx), left
    if tx > right:
        ty, tx = ty + g * (right - tx), right
    if g > 0:
        if ty <= top or fy >= bottom:
            return
        if fy < top:
            fx, fy = fx + (top - fy) / g, top
        if ty > bottom:
            tx, ty = tx + (bottom - ty) / g, bottom
    else:
        if fy <= top or ty >= bottom:
            return
        if ty < top:
            tx, ty = tx + (top - ty) / g, top
        if fy > bottom:
            fx, fy = fx + (bottom - fy) / g, bottom
    # one pixel down, so that int() rounds down; drawn one pixel up
    fy, ty = fy + _F(1), ty + _F(1)

    def put(along: Any, across: Any, brightness: Any) -> None:
        if steep:
            _aa_blend(img, across, along, color, brightness)
        else:
            _aa_blend(img, along, across, color, brightness)

    def end_pixels(x: int, y_end: Any, gap: Any) -> None:
        frac = y_end - _F(int(y_end))
        if _F(int(y_end)) < y_end:
            put(x, int(y_end), frac * gap)
        put(x, int(y_end) - 1, (_F(1) - frac) * gap)

    x_start = int(fx)
    inter = fy + g * (_F(x_start) - fx)
    if tx > left + _F(1):
        end_pixels(x_start, inter, _F(1 + x_start) - fx)
        inter = inter + g
        x_start += 1
    x_end = int(math.ceil(float(tx)))
    if fx < right - _F(1):
        end_pixels(x_end, ty + g * (_F(x_end) - tx), _F(1 - x_end) + tx)
    n = x_end - x_start
    if n <= 0:
        return
    # intersect_y += gradient, column after column, rounded each time
    ys = np.add.accumulate(np.concatenate([[inter], np.full(n - 1, g, _F)]).astype(_F))
    xs = np.arange(x_start, x_end)
    yi = ys.astype(np.int64)
    bright = (_F(1) - ys) + yi.astype(_F)
    put(xs, yi - 1, bright)
    below = yi.astype(_F) < ys
    put(xs[below], yi[below], _F(1) - bright[below])


def aalines(img: np.ndarray, points: Sequence[Tuple[float, float]], color: Color, closed: bool = False) -> None:
    """``pygame.draw.aalines``: each segment by :func:`draw_aaline`, whole,
    in order (and the closing one when ``closed`` with 3 points or more)."""
    segments = list(zip(points[:-1], points[1:]))
    if closed and len(points) > 2:
        segments.append((points[-1], points[0]))
    for a, b in segments:
        draw_aaline(img, a, b, color)


def rotate_rad(vec: Tuple[float, float], angle: float, epsilon: float = 1e-6) -> Tuple[float, float]:
    """``pygame.math.Vector2(vec).rotate_rad(angle)``: exact at multiples of
    90 degrees (within ``epsilon``), else the float64 rotation."""
    x, y = float(vec[0]), float(vec[1])
    angle = math.fmod(angle, 2 * math.pi)
    if angle < 0:
        angle += 2 * math.pi
    if math.fmod(angle + epsilon, math.pi / 2) < 2 * epsilon:
        quarter = int((angle + epsilon) / (math.pi / 2)) % 4
        return ((x, y), (-y, x), (-x, -y), (y, -x))[quarter]
    s, c = math.sin(angle), math.cos(angle)
    return c * x - s * y, s * x + c * y


# -- the two envs' frames (gymnasium 1.2.2 classic_control/cartpole.py and
# pendulum.py ``render``), as ``[H, W, 3]`` uint8 after the vertical flip --

CARTPOLE_SIZE = (400, 600)
PENDULUM_SIZE = (500, 500)
_ASSET = os.path.join(os.path.dirname(__file__), "assets", "clockwise.rgba.zlib")
_ASSET_SHAPE = (312, 329, 4)


def cartpole_frame(x: float, theta: float, x_threshold: float = 2.4, length: float = 0.5) -> np.ndarray:
    """CartPole's frame at cart position ``x`` and pole angle ``theta``."""
    height, width = CARTPOLE_SIZE
    img = np.full((height, width, 3), 255, np.uint8)
    scale = width / (x_threshold * 2)
    polewidth, polelen = 10.0, scale * (2 * length)
    cartwidth, cartheight = 50.0, 30.0
    l, r, t, b = -cartwidth / 2, cartwidth / 2, cartheight / 2, -cartheight / 2
    axleoffset = cartheight / 4.0
    cartx = float(x) * scale + width / 2.0
    carty = 100
    cart = [(cx + cartx, cy + carty) for cx, cy in ((l, b), (l, t), (r, t), (r, b))]
    aapolygon(img, cart, (0, 0, 0))
    filled_polygon(img, cart, (0, 0, 0))
    l, r, t, b = -polewidth / 2, polewidth / 2, polelen - polewidth / 2, -polewidth / 2
    pole = []
    for corner in ((l, b), (l, t), (r, t), (r, b)):
        px, py = rotate_rad(corner, -float(theta))
        pole.append((px + cartx, py + carty + axleoffset))
    aapolygon(img, pole, (202, 152, 101))
    filled_polygon(img, pole, (202, 152, 101))
    axle = (int(cartx), int(carty + axleoffset), int(polewidth / 2))
    aacircle(img, *axle, (129, 132, 203))
    filled_circle(img, *axle, (129, 132, 203))
    hline(img, 0, width, carty, (0, 0, 0))
    return img[::-1].copy()


@functools.lru_cache(maxsize=1)
def _arrow() -> np.ndarray:
    """gymnasium's ``assets/clockwise.png`` as ``[312, 329, 4]`` RGBA (see
    ``assets/LICENSE.gymnasium``)."""
    with open(_ASSET, "rb") as f:
        return np.frombuffer(zlib.decompress(f.read()), np.uint8).reshape(_ASSET_SHAPE)


@functools.lru_cache(maxsize=None)
def _scaled_arrow(size: int, clockwise: bool) -> np.ndarray:
    """The arrow at ``size`` (0 to 113 pixels a side), flipped as gymnasium
    flips it; at most 228 of them, 6 MB in all."""
    img = smoothscale(_arrow(), size, size)[::-1]
    return img[:, ::-1] if clockwise else img


def pendulum_frame(theta: float, last_u: Optional[float] = None) -> np.ndarray:
    """Pendulum's frame at angle ``theta`` with the last torque ``last_u``
    (``None`` after a reset: no arrow)."""
    dim = PENDULUM_SIZE[0]
    img = np.full((dim, dim, 3), 255, np.uint8)
    scale = dim / (2.2 * 2)
    offset = dim // 2
    rod_length, rod_width = 1 * scale, 0.2 * scale
    l, r, t, b = 0, rod_length, rod_width / 2, -rod_width / 2
    angle = float(theta) + math.pi / 2
    rod = []
    for corner in ((l, b), (l, t), (r, t), (r, b)):
        px, py = rotate_rad(corner, angle)
        rod.append((px + offset, py + offset))
    red = (204, 77, 77)
    aapolygon(img, rod, red)
    filled_polygon(img, rod, red)
    aacircle(img, offset, offset, int(rod_width / 2), red)
    filled_circle(img, offset, offset, int(rod_width / 2), red)
    ex, ey = rotate_rad((rod_length, 0), angle)
    end = (int(ex + offset), int(ey + offset))
    aacircle(img, *end, int(rod_width / 2), red)
    filled_circle(img, *end, int(rod_width / 2), red)
    if last_u is not None:
        # gymnasium's size: float32 arithmetic (NumPy 2 keeps the float32
        # torque's type), truncated to whole pixels by smoothscale
        u = np.float32(last_u)
        size = int(float(np.float32(scale) * np.abs(u) / np.float32(2)))
        arrow = _scaled_arrow(size, bool(u > 0))
        blit_alpha(img, arrow, offset - size // 2, offset - size // 2)
    aacircle(img, offset, offset, int(0.05 * scale), (0, 0, 0))
    filled_circle(img, offset, offset, int(0.05 * scale), (0, 0, 0))
    return img[::-1].copy()


# -- Acrobot and the two Mountain Cars (gymnasium 1.2.2 classic_control/
# acrobot.py, mountain_car.py and continuous_mountain_car.py ``render``).
# Each expression is written as gymnasium writes it, on the state's own
# numpy scalars, so that NumPy's promotion (float32 for a float32 state)
# is the same on both sides.

ACROBOT_SIZE = (500, 500)
MOUNTAIN_CAR_SIZE = (400, 600)
_CAR_MIN, _CAR_MAX = -1.2, 0.6


def acrobot_frame(s: np.ndarray) -> np.ndarray:
    """Acrobot's frame at state ``s`` (the two angles and their
    velocities, float32 after a reset and float64 after a step)."""
    dim = ACROBOT_SIZE[0]
    img = np.full((dim, dim, 3), 255, np.uint8)
    bound = 1.0 + 1.0 + 0.2
    scale = dim / (bound * 2)
    offset = dim / 2
    p1 = [-1.0 * np.cos(s[0]) * scale, 1.0 * np.sin(s[0]) * scale]
    p2 = [p1[0] - 1.0 * np.cos(s[0] + s[1]) * scale, p1[1] + 1.0 * np.sin(s[0] + s[1]) * scale]
    xys = np.array([[0, 0], p1, p2])[:, ::-1]
    thetas = [s[0] - math.pi / 2, s[0] + s[1] - math.pi / 2]
    link_lengths = [1.0 * scale, 1.0 * scale]
    line(img, (-2.2 * scale + offset, 1 * scale + offset), (2.2 * scale + offset, 1 * scale + offset), (0, 0, 0))
    for (x, y), th, llen in zip(xys, thetas, link_lengths):
        x = x + offset
        y = y + offset
        l, r, t, b = 0, llen, 0.1 * scale, -0.1 * scale
        coords = []
        for corner in ((l, b), (l, t), (r, t), (r, b)):
            cx, cy = rotate_rad(corner, th)
            coords.append((cx + x, cy + y))
        aapolygon(img, coords, (0, 204, 204))
        filled_polygon(img, coords, (0, 204, 204))
        aacircle(img, int(x), int(y), int(0.1 * scale), (204, 204, 0))
        filled_circle(img, int(x), int(y), int(0.1 * scale), (204, 204, 0))
    return img[::-1].copy()


def _car_height(xs: Any) -> Any:
    return np.sin(3 * xs) * 0.45 + 0.55


@functools.lru_cache(maxsize=1)
def _mountain_track() -> np.ndarray:
    """The white canvas with the track drawn: it depends on no state."""
    height, width = MOUNTAIN_CAR_SIZE
    img = np.full((height, width, 3), 255, np.uint8)
    scale = width / (_CAR_MAX - _CAR_MIN)
    xs = np.linspace(_CAR_MIN, _CAR_MAX, 100)
    aalines(img, list(zip((xs - _CAR_MIN) * scale, _car_height(xs) * scale)), (0, 0, 0))
    img.flags.writeable = False
    return img


def mountain_car_frame(pos: Any, goal_position: float) -> np.ndarray:
    """A Mountain Car frame with the car at position ``pos`` (a numpy
    scalar: float64, or float32 for the continuous car after a step) and
    the flag at ``goal_position`` (0.5 for MountainCar-v0, 0.45 for
    MountainCarContinuous-v0)."""
    img = _mountain_track().copy()
    scale = MOUNTAIN_CAR_SIZE[1] / (_CAR_MAX - _CAR_MIN)
    carwidth, carheight, clearance = 40, 20, 10
    l, r, t, b = -carwidth / 2, carwidth / 2, carheight, 0
    coords = []
    for corner in ((l, b), (l, t), (r, t), (r, b)):
        cx, cy = rotate_rad(corner, math.cos(3 * pos))
        coords.append((cx + (pos - _CAR_MIN) * scale, cy + clearance + _car_height(pos) * scale))
    aapolygon(img, coords, (0, 0, 0))
    filled_polygon(img, coords, (0, 0, 0))
    for corner in ((carwidth / 4, 0), (-carwidth / 4, 0)):
        cx, cy = rotate_rad(corner, math.cos(3 * pos))
        wheel = (int(cx + (pos - _CAR_MIN) * scale), int(cy + clearance + _car_height(pos) * scale))
        aacircle(img, wheel[0], wheel[1], int(carheight / 2.5), (128, 128, 128))
        filled_circle(img, wheel[0], wheel[1], int(carheight / 2.5), (128, 128, 128))
    flagx = int((goal_position - _CAR_MIN) * scale)
    flagy1 = int(_car_height(goal_position) * scale)
    flagy2 = flagy1 + 50
    vline(img, flagx, flagy1, flagy2, (0, 0, 0))
    flag = [(flagx, flagy2), (flagx, flagy2 - 10), (flagx + 25, flagy2 - 5)]
    aapolygon(img, flag, (204, 204, 0))
    filled_polygon(img, flag, (204, 204, 0))
    return img[::-1].copy()
