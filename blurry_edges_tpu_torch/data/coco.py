"""A self-contained reader of MS-COCO instance annotations (the JAX
package's ``data/coco.py``; reference test_data_generator.py:26-68:
COCO(), getCatIds, getImgIds, getAnnIds, loadAnns, loadImgs, annToMask).

``open_coco`` prefers pycocotools when it can be imported, as the JAX
package's does; else ``SimpleCOCO``, which needs neither pycocotools nor
OpenCV:

- polygons are filled by ``fill_poly``, a transcription of OpenCV's
  ``cv2.fillPoly`` (the JAX reader's rasteriser, after ``np.round`` of the
  vertices): each edge drawn as an 8-connected line, then the scanline fill
  of the edges in 16.16 fixed point;
- uncompressed RLE as the JAX reader decodes it;
- compressed RLE (a ``counts`` string, as MS-COCO stores its crowd
  annotations) by pycocotools' ``rleFrString``. The JAX reader raises on
  those without pycocotools; this one gives what pycocotools gives.

``fill_poly`` equals ``cv2.fillPoly`` (OpenCV 5.0.0) bit for bit on
polygons whose rounded vertices lie inside the image. A vertex on the far
border (x = width or y = height, where MS-COCO's float vertices may round
to) takes OpenCV's clipping path, which this transcription follows only in
part: a few pixels along that border may differ
(``tests/test_torch_coco.py`` counts them).
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


class SimpleCOCO:
    """pycocotools.coco.COCO's surface, as far as the test-set generator
    uses it."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.imgs = {i["id"]: i for i in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self._img_to_anns = defaultdict(list)
        self._cat_to_imgs = defaultdict(set)
        for a in d.get("annotations", []):
            self._img_to_anns[a["image_id"]].append(a)
            self._cat_to_imgs[a["category_id"]].add(a["image_id"])

    def loadCats(self, ids):
        return [self.cats[i] for i in ids]

    def getCatIds(self, catNms=None):
        if catNms is None:
            return sorted(self.cats)
        if isinstance(catNms, str):
            catNms = [catNms]
        return [i for i, c in sorted(self.cats.items()) if c["name"] in catNms]

    def getImgIds(self, catIds=None):
        if not catIds:
            return sorted(self.imgs)
        ids = set(self.imgs)
        for c in catIds:
            ids &= self._cat_to_imgs[c]
        return sorted(ids)

    def getAnnIds(self, imgIds, catIds=None):
        if not isinstance(imgIds, (list, tuple)):
            imgIds = [imgIds]
        return [a["id"] for i in imgIds for a in self._img_to_anns[i]
                if not catIds or a["category_id"] in catIds]

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annToMask(self, ann) -> np.ndarray:
        """(height, width) uint8 0/1 mask of an annotation."""
        info = self.imgs[ann["image_id"]]
        h, w = info["height"], info["width"]
        seg = ann["segmentation"]
        if isinstance(seg, list):
            mask = np.zeros((h, w), np.uint8)
            for poly in seg:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                fill_poly(mask, np.round(pts).astype(np.int64))
            return mask
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):
            counts = rle_from_string(counts)
        return rle_decode(counts, h, w)


def open_coco(annotation_file: str):
    """pycocotools' COCO when it can be imported, else ``SimpleCOCO``."""
    try:
        from pycocotools.coco import COCO  # type: ignore

        return COCO(annotation_file)
    except ImportError:
        return SimpleCOCO(annotation_file)


# --------------------------------------------------------------------- RLE

def rle_from_string(s) -> list:
    """pycocotools' ``rleFrString``: runs of 5-bit groups, each character
    offset by 48, 0x20 the continuation bit, 0x10 of the last group the
    sign; counts after the third are deltas from the count two places
    back."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts, p = [], 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Alternating runs of 0 and 1, column-major (the COCO convention) ->
    (h, w) uint8."""
    runs = np.asarray(counts, np.int64)
    values = np.arange(len(runs)) % 2
    flat = np.repeat(values.astype(np.uint8), runs)
    mask = np.zeros(h * w, np.uint8)
    mask[:min(flat.size, h * w)] = flat[:h * w]
    return mask.reshape((w, h)).T


# ------------------------------------------------------------ polygon fill

def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, W - 1] x [0, H - 1]: (inside, x1, y1,
    x2, y2), the moved coordinates truncated toward zero as its int64
    casts of a double truncate."""
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected ``LineIterator`` (left to right), clipped to the
    image, setting each pixel to 1."""
    H, W = img.shape
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        inside, x1, y1, x2, y2 = _clip_line(W, H, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = 1
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:
            y += step_y
            x += diag
        else:
            x += 1
            y += step_y if diag else 0


def fill_poly(img: np.ndarray, pts) -> None:
    """``cv2.fillPoly(img, [pts], 1)`` for one contour of integer vertices
    (N, 2) as (x, y), on a 2-D uint8 ``img``, in place: every edge drawn by
    ``_line8`` from its vertices (x rounded from 16.16 fixed point), then
    each scanline y filled between pairs of the active edges (those with
    y0 <= y < y1, in order of x), from (x + 0.5 + 65535 / 65536) to (x +
    0.5 - 1 / 65536) in pixels. An edge starts at its upper vertex plus half
    a pixel and steps by its slope, floored in 16.16; an edge whose line
    ``_clip_line`` moved takes its slope from the clipped ends."""
    H, W = img.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    half = XY_ONE >> 1
    edges = []
    x0, y0 = pts[-1][0] << XY_SHIFT, pts[-1][1]
    for px, y1 in pts:
        x1 = px << XY_SHIFT
        t0x, t1x = (x0 + half) >> XY_SHIFT, (x1 + half) >> XY_SHIFT
        _line8(img, t0x, y0, t1x, y1)
        c0x, c0y, c1x, c1y = x0 + half, y0, x1 + half, y1
        if not (0 <= t0x < W and 0 <= t1x < W and 0 <= y0 < H and 0 <= y1 < H):
            _, a, b, c, d = _clip_line(W, H, t0x, y0, t1x, y1)
            if b != d:
                c0x, c0y, c1x, c1y = (a << XY_SHIFT) + half, b, (c << XY_SHIFT) + half, d
        if y0 != y1 and c0y != c1y:
            slope = (c1x - c0x) // (c1y - c0y)
            edges.append([y0, y1, c0x, slope] if y0 < y1 else [y1, y0, c1x, slope])
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_end = min(max(e[1] for e in edges), H)
    active, i, y = [], 0, edges[0][0]
    while y < y_end:
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            k = 0
            while k < len(active) and active[k][2] < edges[i][2]:
                k += 1
            active.insert(k, edges[i])
            i += 1
        if y >= 0:
            for a, b in zip(active[0::2], active[1::2]):
                lo, hi = (b[2], a[2]) if a[2] > b[2] else (a[2], b[2])
                xa, xb = (lo + XY_ONE - 1) >> XY_SHIFT, (hi - 1) >> XY_SHIFT
                if xa < W and xb >= 0:
                    img[y, max(xa, 0):min(xb, W - 1) + 1] = 1
        for e in active[:len(active) - len(active) % 2]:
            e[2] += e[3]
        active.sort(key=lambda e: e[2])
        y += 1
