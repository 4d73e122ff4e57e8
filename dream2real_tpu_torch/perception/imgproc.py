"""Host counterparts of the OpenCV calls the perception modules make, in
numpy and scipy (the GPU machine has no OpenCV):

- ``connected_components``: ``cv2.connectedComponents`` (8-connectivity,
  labels ordered as OpenCV's block-based scan meets the components: by the
  first 2 x 2 block, in raster order of blocks);
- ``external_contours``: ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_NONE)``, OpenCV's border following (Suzuki and Abe) on the
  image padded with zeros, every step of the border a point;
- ``min_area_rect`` and ``box_points``: ``cv2.minAreaRect`` (convex hull,
  rotating calipers in f32, the angle in [-90, 0)) and ``cv2.boxPoints``;
- ``moments``: the raw moments m00, m10, m01 of ``cv2.moments``;
- ``gaussian_blur``: ``cv2.GaussianBlur`` with sigma 0 (OpenCV's sigma for
  the kernel size) and the reflect-101 border, in f64, rounded half up;
- ``dilate`` / ``erode``: ``cv2.dilate`` / ``cv2.erode`` with an all-ones
  kernel, anchored at the kernel's centre as OpenCV anchors it (k // 2, one
  pixel off the JAX package's placement for even k), through
  ``ops.image``;
- ``inpaint_telea`` / ``inpaint_ns``: ``cv2.inpaint(img, mask, radius,
  cv2.INPAINT_TELEA / INPAINT_NS)``, the fast marching with OpenCV's queue
  order and its f32 arithmetic.

Where OpenCV's fixed-point blur or its f32 angle rounds a value that lies on
a threshold (a blurred value of one half, a box corner on an integer) the
two may fall on either side: the tests show each such difference a tie.
"""

from __future__ import annotations

import heapq
import itertools
import math

import numpy as np
import torch
from scipy import ndimage

from dream2real_tpu_torch.ops import image as image_ops

_F32 = np.float32
# Border-following directions 0..7 as (dy, dx): right, up-right, up,
# up-left, left, down-left, down, down-right (OpenCV's chain codes).
_DELTAS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))


def connected_components(img: np.ndarray):
    """-> (n labels counting the background, (H, W) int32 labels)."""
    fg = np.asarray(img) != 0
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    if n == 0:
        return 1, lab.astype(np.int32)
    rr, cc = np.nonzero(lab)
    block = (rr // 2) * ((fg.shape[1] + 1) // 2) + cc // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab[rr, cc], block)
    remap = np.zeros(n + 1, np.int32)
    remap[1 + np.argsort(first[1:], kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return n + 1, remap[lab]


def _trace_outer(img: np.ndarray, r0: int, c0: int) -> np.ndarray:
    """OpenCV's outer-border following from the component's raster-first
    pixel (r0, c0) of the zero-padded image -> (N, 1, 2) int32 (x, y) points
    in the unpadded frame."""
    def nz(r, c):
        return img[r, c] != 0

    s = s_end = 4
    while True:
        s = (s - 1) & 7
        dy, dx = _DELTAS[s]
        if nz(r0 + dy, c0 + dx) or s == s_end:
            break
    if s == s_end and not nz(r0 + _DELTAS[s][0], c0 + _DELTAS[s][1]):
        return np.array([[[c0 - 1, r0 - 1]]], np.int32)  # a single pixel
    r1, c1 = r0 + _DELTAS[s][0], c0 + _DELTAS[s][1]
    r3, c3 = r0, c0
    pts = []
    while True:
        s_end = s
        while True:
            s += 1
            dy, dx = _DELTAS[s & 7]
            r4, c4 = r3 + dy, c3 + dx
            if nz(r4, c4) or s >= 15:
                break
        s &= 7
        pts.append((c3 - 1, r3 - 1))
        if (r4, c4) == (r0, c0) and (r3, c3) == (r1, c1):
            break
        r3, c3 = r4, c4
        s = (s + 4) & 7
    return np.asarray(pts, np.int32)[:, None, :]


def external_contours(img: np.ndarray) -> list[np.ndarray]:
    """The outer borders of the components that no hole of another
    component encloses, as ``findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)``
    lists them: each (N, 1, 2) int32 (x, y), the last found first."""
    fg = np.pad(np.asarray(img) != 0, 1)
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    bg, _ = ndimage.label(~fg)  # 4-connected background regions
    outside = bg[0, 0]
    flat = lab.ravel()
    idx = np.flatnonzero(flat)
    first = np.full(n + 1, flat.size)
    np.minimum.at(first, flat[idx], idx)
    contours = []
    for start in np.sort(first[1:]):
        r, c = divmod(int(start), fg.shape[1])
        if bg[r, c - 1] == outside:  # the region around it is the outside
            contours.append(_trace_outer(fg, r, c))
    return contours[::-1]


def _cyclic_start(idx: list) -> int:
    """Where OpenCV's convexHull starts its output: when the hull's input
    indices run cyclically up (down), at the smallest (largest); else where
    it began (0)."""
    n = len(idx)
    if n < 3:
        return 0
    lo = hi = lt = 0
    for i in range(1, n):
        lt += idx[i - 1] < idx[i]
        if 1 < lt <= i - 2:
            break
        if idx[i] < idx[lo]:
            lo = i
        if idx[i] > idx[hi]:
            hi = i
    if abs(hi - lo) in (1, n - 1) and (lt <= 1 or lt >= n - 2):
        ascending = (hi + 1) % n == lo
        i0 = lo if ascending else hi
        j = i0
        for i in range(n - 1):
            nj = j + 1 if j + 1 < n else 0
            if ascending != (idx[j] < idx[nj]):
                return 0
            j = nj
        return i0
    return 0


def _hull(points: np.ndarray) -> np.ndarray:
    """Convex hull vertices (no collinear points) in OpenCV's orientation
    and order: from the point of largest x (then largest y), shifted to the
    smallest (largest) input index when the indices run cyclically up
    (down), as for a contour; a point met twice counts at its first index.
    -> (M, 2) int64."""
    raw = np.asarray(points, np.int64).reshape(-1, 2)
    pts = np.unique(raw, axis=0)  # sorted by x, then y
    if len(pts) < 3:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    ring = lower[:-1] + upper[:-1]  # counter-clockwise (y up), from min x
    start = max(range(len(ring)), key=lambda i: (ring[i][0], ring[i][1]))
    ring = ring[start:] + ring[:start]
    first: dict = {}
    for i, p in enumerate(map(tuple, raw.tolist())):
        first.setdefault(p, i)
    s = _cyclic_start([first[p] for p in ring])
    return np.asarray(ring[s:] + ring[:s], np.int64)


def _calipers(p: np.ndarray):
    """OpenCV's rotatingCalipers (min-area mode) over f32 hull points ->
    (corner point, edge vector 1, edge vector 2), f32."""
    n = len(p)
    vect = np.zeros((n, 2), _F32)
    inv = np.zeros(n, _F32)
    left = bottom = right = top = 0
    pt0 = p[0]
    left_x = right_x = pt0[0]
    top_y = bottom_y = pt0[1]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = p[i + 1 if i + 1 < n else 0]
        dx, dy = float(pt[0]) - float(pt0[0]), float(pt[1]) - float(pt0[1])
        vect[i] = (dx, dy)
        inv[i] = 1.0 / math.sqrt(dx * dx + dy * dy)
        pt0 = pt
    orientation = _F32(0)
    ax, ay = float(vect[n - 1, 0]), float(vect[n - 1, 1])
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        conv = ax * by - ay * bx
        if conv != 0:
            orientation = _F32(1.0 if conv > 0 else -1.0)
            break
        ax, ay = bx, by
    base_a, base_b = orientation, _F32(0)
    seq = [bottom, right, top, left]
    minarea = _F32(np.finfo(_F32).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0], 0] + base_b * vect[seq[0], 1],
              -base_b * vect[seq[1], 0] + base_a * vect[seq[1], 1],
              -base_a * vect[seq[2], 0] - base_b * vect[seq[2], 1],
              base_b * vect[seq[3], 0] - base_a * vect[seq[3], 1])
        maxcos, main = dp[0] * inv[seq[0]], 0
        for i in range(1, 4):
            cosalpha = dp[i] * inv[seq[i]]
            if cosalpha > maxcos:
                maxcos, main = cosalpha, i
        k = seq[main]
        lx, ly = vect[k, 0] * inv[k], vect[k, 1] * inv[k]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = 0 if seq[main] + 1 == n else seq[main] + 1
        width = (p[seq[1], 0] - p[seq[3], 0]) * base_a + (p[seq[1], 1] - p[seq[3], 1]) * base_b
        height = (-(p[seq[2], 0] - p[seq[0], 0]) * base_b
                  + (p[seq[2], 1] - p[seq[0], 1]) * base_a)
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    s3, a1, wd, b1, ht, s0 = best
    a2, b2 = -b1, a1
    c1 = a1 * p[s3, 0] + p[s3, 1] * b1
    c2 = a2 * p[s0, 0] + p[s0, 1] * b2
    idet = _F32(1) / (a1 * b2 - a2 * b1)
    corner = np.array([(c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet], _F32)
    return corner, np.array([a1 * wd, b1 * wd], _F32), np.array([a2 * ht, b2 * ht], _F32)


def min_area_rect(points: np.ndarray):
    """``cv2.minAreaRect`` -> ((cx, cy), (w, h), angle in degrees), the
    angle in [-90, 0) and w along it."""
    hull = _hull(points).astype(_F32)
    if len(hull) == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0
    if len(hull) == 2:
        c = (hull[0] + hull[1]) * _F32(0.5)
        dx, dy = float(hull[1, 0] - hull[0, 0]), float(hull[1, 1] - hull[0, 1])
        return ((float(c[0]), float(c[1])), (float(_F32(math.hypot(dx, dy))), 0.0),
                float(_F32(math.degrees(math.atan2(dy, dx)))))
    with np.errstate(over="ignore"):
        corner, o1, o2 = _calipers(hull)
    centre = corner + (o1 + o2) * _F32(0.5)
    for v, u in ((o1, o2), (o2, o1), (-o1, o2), (-o2, o1)):
        ang = _F32(math.degrees(math.atan2(float(v[1]), float(v[0]))))
        if -90 <= ang < 0:
            w = _F32(math.hypot(float(v[0]), float(v[1])))
            h = _F32(math.hypot(float(u[0]), float(u[1])))
            return (float(centre[0]), float(centre[1])), (float(w), float(h)), float(ang)
    raise AssertionError("no edge of the rectangle has an angle in [-90, 0)")


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints``: the rectangle's four corners, (4, 2) f32."""
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = _F32(cx), _F32(cy), _F32(w), _F32(h)
    rad = angle * math.pi / 180.0
    b = _F32(math.cos(rad)) * _F32(0.5)
    a = _F32(math.sin(rad)) * _F32(0.5)
    pt = np.empty((4, 2), _F32)
    pt[0] = (cx - a * h - b * w, cy + b * h - a * w)
    pt[1] = (cx + a * h - b * w, cy - b * h - a * w)
    pt[2] = (_F32(2) * cx - pt[0, 0], _F32(2) * cy - pt[0, 1])
    pt[3] = (_F32(2) * cx - pt[1, 0], _F32(2) * cy - pt[1, 1])
    return pt


def moments(img: np.ndarray) -> dict:
    """The raw moments m00, m10 (sum of x) and m01 (sum of y) of an image."""
    a = np.asarray(img, np.float64)
    ys, xs = np.arange(a.shape[0], dtype=np.float64), np.arange(a.shape[1], dtype=np.float64)
    return {"m00": float(a.sum()), "m10": float((a.sum(axis=0) * xs).sum()),
            "m01": float((a.sum(axis=1) * ys).sum())}


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Separable Gaussian blur of a (H, W) uint8 image with OpenCV's kernel
    (sigma <= 0: 0.3 ((k - 1) / 2 - 1) + 0.8) and reflect-101 border, in f64,
    rounded half up to uint8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    out = np.asarray(img, np.float64)
    for axis in (0, 1):
        out = ndimage.correlate1d(out, k, axis=axis, mode="mirror")
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _morph(img: np.ndarray, ksize: int, iterations: int, take_min: bool) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(img))
    for _ in range(iterations):
        t = (image_ops.erode if take_min else image_ops.dilate)(t, ksize, cv2_anchor=True)
    return t.numpy()


def dilate(img: np.ndarray, ksize: int, iterations: int = 1) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k)), iterations=n)``."""
    return _morph(img, ksize, iterations, take_min=False)


def erode(img: np.ndarray, ksize: int, iterations: int = 1) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k)), iterations=n)``."""
    return _morph(img, ksize, iterations, take_min=True)


# ---------------------------------------------------------------- inpainting
# Telea's fast-marching inpainting (Telea 2004) as OpenCV's INPAINT_TELEA
# computes it: the image padded by one pixel, the flags below, the distance T
# solved from the 4-neighbourhood, a band of known pixels within the radius
# given negative distances first, then each hole pixel filled in order of T
# from the known pixels within the radius, weighted by direction, level and
# distance, plus OpenCV's gradient term; rounded to uint8 half to even. Both
# queues pop the least T, equal T in push order, as OpenCV's sorted list
# does. The arithmetic is OpenCV's: f32 operations, and f64 where OpenCV
# widens (the distance solve, the distance and level weights).
_KNOWN, _BAND, _INSIDE, _CHANGE = 0, 1, 2, 3


def _fm_solve(f, t, i1, j1, i2, j2) -> float:
    """OpenCV's FastMarching_solve: T of a pixel from two 4-neighbours, in
    f64, returned as f32."""
    a11, a22 = float(t[i1, j1]), float(t[i2, j2])
    m12 = min(a11, a22)
    if f[i1, j1] != _INSIDE:
        if f[i2, j2] != _INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1.0 + m12
            else:
                sol = (a11 + a22 + math.sqrt(2.0 - (a11 - a22) * (a11 - a22))) * 0.5
        else:
            sol = 1.0 + a11
    elif f[i2, j2] != _INSIDE:
        sol = 1.0 + a22
    else:
        sol = 1.0 + m12
    return float(_F32(sol))


def _fm_dist(f, t, i, j) -> float:
    return min(min(_fm_solve(f, t, i - 1, j, i, j - 1), _fm_solve(f, t, i + 1, j, i, j - 1)),
               min(_fm_solve(f, t, i - 1, j, i, j + 1), _fm_solve(f, t, i + 1, j, i, j + 1)))


class _Queue:
    """OpenCV's CvPriorityQueueFloat: the least T first, equal T in push
    order. Starts with the nonzero pixels of ``flags`` at T 0, in raster
    order."""

    def __init__(self, flags: np.ndarray):
        self._n = itertools.count()
        self._heap = [(0.0, next(self._n), int(i), int(j)) for i, j in zip(*np.nonzero(flags))]

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, T: float, i: int, j: int) -> None:
        heapq.heappush(self._heap, (T, next(self._n), i, j))

    def pop(self) -> tuple[int, int]:
        return heapq.heappop(self._heap)[2:]


def _march_outside(f, t, queue: _Queue) -> None:
    """OpenCV's icvCalcFMM with negate: T outward over the INSIDE pixels of
    ``f`` (the known ring within the radius), stored negated."""
    rows, cols = f.shape
    while queue:
        ii, jj = queue.pop()
        f[ii, jj] = _CHANGE
        for i, j in ((ii - 1, jj), (ii, jj - 1), (ii + 1, jj), (ii, jj + 1)):
            if i <= 0 or j <= 0 or i > rows or j > cols:
                continue
            if f[i, j] == _INSIDE:
                dist = _fm_dist(f, t, i, j)
                t[i, j] = dist
                f[i, j] = _BAND
                queue.push(dist, i, j)
    change = f == _CHANGE
    f[change] = _KNOWN
    t[change] = -t[change]


class _Disc:
    """The offsets within the radius, k (rows) outer, l (columns) inner, and
    what depends on the offset alone: r = (j - l, i - k), |r|^2, Telea's
    distance weight 1 / |r|^3 (f64, rounded to f32) and the Navier-Stokes
    one 1 / (|r|^4 + 1) (f32)."""

    def __init__(self, rng: int):
        oy, ox = np.mgrid[-rng:rng + 1, -rng:rng + 1]
        disc = oy * oy + ox * ox <= rng * rng
        self.dk, self.dl = oy[disc], ox[disc]
        self.ry, self.rx = (-self.dk).astype(_F32), (-self.dl).astype(_F32)
        self.len2 = self.rx * self.rx + self.ry * self.ry
        length = self.len2.astype(np.float64)
        with np.errstate(divide="ignore"):
            self.dst = (1.0 / (length * np.sqrt(length))).astype(_F32)
        self.dst_ns = _F32(1) / (self.len2 * self.len2 + _F32(1))


# Neighbours of a sample whose flags pick the gradient's form: right, left,
# down, up.
_NB_K = np.array([0, 0, 1, -1])
_NB_L = np.array([1, -1, 0, 0])


def _telea_pixel(f, t, out, i, j, disc: _Disc) -> None:
    """Fill hole pixel (i, j) (padded coordinates) of ``out`` (unpadded,
    (H, W, C) uint8), every colour from the known pixels within the
    radius."""
    rows, cols = f.shape
    ti = t[i, j]
    # gradT, from the known 4-neighbours.
    if f[i, j + 1] != _INSIDE:
        gx = ((t[i, j + 1] - t[i, j - 1]) * _F32(0.5) if f[i, j - 1] != _INSIDE
              else t[i, j + 1] - ti)
    else:
        gx = ti - t[i, j - 1] if f[i, j - 1] != _INSIDE else _F32(0)
    if f[i + 1, j] != _INSIDE:
        gy = ((t[i + 1, j] - t[i - 1, j]) * _F32(0.5) if f[i - 1, j] != _INSIDE
              else t[i + 1, j] - ti)
    else:
        gy = ti - t[i - 1, j] if f[i - 1, j] != _INSIDE else _F32(0)
    k = i + disc.dk
    l = j + disc.dl
    ok = (k > 0) & (l > 0) & (k < rows - 1) & (l < cols - 1)
    ok[ok] = f[k[ok], l[ok]] != _INSIDE
    k, l, rx, ry, dst = k[ok], l[ok], disc.rx[ok], disc.ry[ok], disc.dst[ok]
    # The level weight: the f32 difference, then 1 / (1 + |d|) in f64.
    lev = (1.0 / (1.0 + np.abs(t[k, l] - ti).astype(np.float64))).astype(_F32)
    direction = rx * gx + ry * gy
    direction[np.abs(direction) <= 0.01] = _F32(0.000001)
    w = np.abs(dst * lev * direction)
    # Image coordinates of the gradient's samples, clamped at the image
    # border as OpenCV clamps them (the sample itself is read unclamped).
    km = k - 1 + (k == 1)
    kp = k - 1 - (k == rows - 2)
    lm = l - 1 + (l == 1)
    lp = l - 1 - (l == cols - 2)
    known = f[k[:, None] + _NB_K, l[:, None] + _NB_L] != _INSIDE
    r_in, l_in, d_in, u_in = (known[:, q, None] for q in range(4))
    smp = out[np.stack([k - 1, km, km, km, km, kp + 1, km - 1, kp]),
              np.stack([l - 1, lp + 1, lm - 1, lm, lp, lm, lm, lm])].astype(_F32)
    own, right, left, mid, lft, down, up, dwn = smp
    gix = np.where(r_in & l_in, (right - left) * _F32(2),
                   np.where(r_in, right - mid, np.where(l_in, lft - left, _F32(0))))
    giy = np.where(d_in & u_in, (down - up) * _F32(2),
                   np.where(d_in, down - mid, np.where(u_in, dwn - up, _F32(0))))
    wc = w[:, None]
    s = np.concatenate([[_F32(1e-20)], w]).cumsum(dtype=_F32)[-1]
    ia = (wc * own).cumsum(axis=0, dtype=_F32)[-1]
    jx = -(wc * (gix * rx[:, None])).cumsum(axis=0, dtype=_F32)[-1]
    jy = -(wc * (giy * ry[:, None])).cumsum(axis=0, dtype=_F32)[-1]
    norm = np.sqrt(jx * jx + jy * jy) + _F32(1e-20)
    sat = ia / s + (jx + jy) / norm + _F32(0.5)
    out[i - 1, j - 1] = np.clip(np.rint(sat), 0, 255).astype(np.uint8)


def _fmm_start(img: np.ndarray, mask: np.ndarray, radius: float):
    """OpenCV's cvInpaint set-up: -> (out (H, W, C) copy, squeeze, the
    radius in pixels, flags f and distances t padded by one pixel, the band
    (the hole's 4-neighbours outside it, T 0))."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    out = (img[..., None] if squeeze else img).copy()
    h, w = out.shape[:2]
    rng = min(max(int(np.rint(radius)), 1), 100)
    f = np.zeros((h + 2, w + 2), np.uint8)  # the flags, padded by one pixel
    f[1:-1, 1:-1] = np.where(np.asarray(mask) != 0, _INSIDE, _KNOWN)
    inside = f == _INSIDE
    cross = ndimage.binary_dilation(inside, np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
    band = cross & ~inside
    band[0, :] = band[-1, :] = band[:, 0] = band[:, -1] = False
    t = np.full(f.shape, 1.0e6, _F32)
    t[band] = 0
    return out, squeeze, rng, f, t, band


def _march_inside(f, t, queue: _Queue, fill) -> None:
    """The hole, from its boundary inwards: each INSIDE 4-neighbour of the
    popped pixel gets its T, is filled by ``fill(i, j)`` and joins the band."""
    rows, cols = f.shape
    while queue:
        ii, jj = queue.pop()
        f[ii, jj] = _KNOWN
        for i, j in ((ii - 1, jj), (ii, jj - 1), (ii + 1, jj), (ii, jj + 1)):
            if i <= 0 or j <= 0 or i > rows or j > cols:
                continue
            if f[i, j] == _INSIDE:
                dist = _fm_dist(f, t, i, j)
                t[i, j] = dist
                fill(i, j)
                f[i, j] = _BAND
                queue.push(dist, i, j)


def inpaint_telea(img: np.ndarray, mask: np.ndarray, radius: float = 3) -> np.ndarray:
    """``cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA)``: (H, W, C) or
    (H, W) uint8 with the pixels where ``mask`` is nonzero filled; every
    other pixel is returned as it was."""
    out, squeeze, rng, f, t, band = _fmm_start(img, mask, radius)
    inside = f == _INSIDE
    # T outside the hole, within the radius: negative distances.
    ring = ndimage.binary_dilation(inside, np.ones((2 * rng + 1,) * 2, bool)) & ~inside & ~band
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = False
    f_out = np.where(ring, _INSIDE, _KNOWN).astype(np.uint8)
    _march_outside(f_out, t, _Queue(band))
    disc = _Disc(rng)
    _march_inside(f, t, _Queue(band), lambda i, j: _telea_pixel(f, t, out, i, j, disc))
    return out[..., 0] if squeeze else out


# Navier-Stokes inpainting (Bertalmio, Bertozzi and Sapiro 2001) as OpenCV's
# INPAINT_NS computes it (icvNSInpaintFMM): the same set-up, queue and T as
# Telea's without the outside march; each hole pixel is the mean of the known
# pixels within the radius, weighted by 1 / (|r|^4 + 1) and by |cos| of the
# angle between r and an isophote estimate from absolute differences of the
# image (so the sign of r does not matter), in f32, the mean itself in f64
# (rounded half to even for uint8).
def _ns_pixel(f, out, i, j, disc: _Disc) -> None:
    """Fill hole pixel (i, j) (padded coordinates) of ``out`` (unpadded, (H,
    W, C) uint8 or float32), every channel from the known pixels within the
    radius."""
    rows, cols = f.shape
    k = i + disc.dk
    l = j + disc.dl
    ok = (k > 0) & (l > 0) & (k < rows - 1) & (l < cols - 1)
    ok[ok] = f[k[ok], l[ok]] != _INSIDE
    k, l = k[ok], l[ok]
    rx, ry = disc.rx[ok, None], disc.ry[ok, None]
    # Image coordinates of the isophote's samples, clamped at the image
    # border as OpenCV clamps them.
    km = k - 1 + (k == 1)
    kp = k - 1 - (k == rows - 2)
    lm = l - 1 + (l == 1)
    lp = l - 1 - (l == cols - 2)
    known = f[k[:, None] + _NB_K, l[:, None] + _NB_L] != _INSIDE
    r_in, l_in, d_in, u_in = (known[:, q, None] for q in range(4))
    # uint8 differences as exact ints (OpenCV sums them before its cast to
    # f32, which the f32 sum of two values under 256 repeats exactly).
    wide = np.int32 if out.dtype == np.uint8 else _F32
    smp = out[np.stack([k - 1, kp + 1, kp, km - 1, km, km, km]),
              np.stack([l - 1, lm, lm, lm, lp + 1, lm, lm - 1])].astype(wide)
    own, down, mid_v, up, right, mid_h, left = smp
    a_d, a_u = np.abs(down - mid_v).astype(_F32), np.abs(mid_v - up).astype(_F32)
    a_r, a_l = np.abs(right - mid_h).astype(_F32), np.abs(mid_h - left).astype(_F32)
    gx = np.where(d_in & u_in, a_d + a_u, np.where(d_in, a_d * _F32(2),
                                                   np.where(u_in, a_u * _F32(2), _F32(0))))
    gy = np.where(r_in & l_in, a_r + a_l, np.where(r_in, a_r * _F32(2),
                                                   np.where(l_in, a_l * _F32(2), _F32(0))))
    gx = -gx
    dot = rx * gx + ry * gy
    len_g = gx * gx + gy * gy
    with np.errstate(divide="ignore", invalid="ignore"):
        cosine = np.abs(dot / np.sqrt(disc.len2[ok, None] * len_g))
    direction = np.where(np.abs(dot) <= 0.01, _F32(0.000001), cosine).astype(_F32)
    w = disc.dst_ns[ok, None] * direction
    s = np.concatenate([np.full((1, w.shape[1]), 1e-20, _F32), w]).cumsum(axis=0, dtype=_F32)[-1]
    ia = (w * own.astype(_F32)).cumsum(axis=0, dtype=_F32)[-1]
    mean = ia.astype(np.float64) / s.astype(np.float64)
    if out.dtype == np.uint8:
        out[i - 1, j - 1] = np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    else:
        out[i - 1, j - 1] = mean.astype(out.dtype)


def inpaint_ns(img: np.ndarray, mask: np.ndarray, radius: float = 3) -> np.ndarray:
    """``cv2.inpaint(img, mask, radius, cv2.INPAINT_NS)``: (H, W, C) or (H,
    W) uint8, or (H, W) float32, with the pixels where ``mask`` is nonzero
    filled; every other pixel is returned as it was."""
    out, squeeze, rng, f, t, band = _fmm_start(img, mask, radius)
    if out.dtype not in (np.uint8, np.float32):
        raise TypeError(f"inpaint_ns takes uint8 or float32 images, not {out.dtype}")
    disc = _Disc(rng)
    _march_inside(f, t, _Queue(band), lambda i, j: _ns_pixel(f, out, i, j, disc))
    return out[..., 0] if squeeze else out
