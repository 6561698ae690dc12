#!/usr/bin/env python3
"""Write the small fake MS-COCO / Painting fixture that the port's tests and
``chip_smoke.py`` read (``tests/data/coco_fixture/``):

    python make_coco_fixture.py [--out tests/data/coco_fixture] [--seed 2017]

Needs OpenCV (``cv2``); downloads nothing; the same seed writes the same
files. It writes

- ``coco/instances_val2017.json`` in MS-COCO's schema: two categories;
  simple, concave and two-part polygons, an annotation whose ``area`` is
  under the loader's 40,000, an uncompressed RLE and a compressed-RLE
  crowd annotation (``iscrowd`` 1; its string encoded as pycocotools'
  ``rleToString`` encodes, transcribed below). Every polygon vertex lies
  inside its image.
- ``coco/val2017/``: JPEGs at MS-COCO's sizes (640x480 landscape, 480x640
  portrait; OpenCV's default 4:2:0 encoding), one of them progressive, one
  grayscale, one stored 640x480 with an EXIF orientation segment (6: turn
  90 degrees clockwise) spliced in, so it reads as 480x640 (its
  annotation lists that size); and one PNG.
- ``painting/``: three JPEGs and one PNG, below and above 587 px.
- ``decoded_cv2/``: ``cv2.imread`` of every JPEG, stored as PNG, the
  pixels the card's nvJPEG decodes are compared with; and
  ``png_sha256.json``, the SHA-256 of ``cv2.imread``'s array of every PNG
  source, against which a decode without OpenCV is held bit for bit.

The content is smooth (low-frequency colour fields and flat shapes) so
that the whole fixture stays under 3 MB.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np


def smooth_image(rng, h: int, w: int, gray: bool = False) -> np.ndarray:
    """A low-frequency colour field with a few flat shapes (chroma edges)."""
    low = rng.uniform(40, 215, (4, 5, 3))
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    for _ in range(4):
        color = [float(c) for c in rng.uniform(20, 235, 3)]
        cx, cy = int(rng.uniform(0.15, 0.85) * w), int(rng.uniform(0.15, 0.85) * h)
        ax = (int(rng.uniform(0.05, 0.2) * w), int(rng.uniform(0.05, 0.2) * h))
        cv2.ellipse(img, (cx, cy), ax, float(rng.uniform(0, 180)), 0, 360, color, -1)
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def star(rng, cx, cy, r_lo, r_hi, n, w, h):
    """A star-shaped polygon's float vertices, [x0, y0, x1, y1, ...], inside
    [1, w - 2] x [1, h - 2]."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(r_lo, r_hi, n)
    x = np.clip(cx + rad * np.cos(ang), 1, w - 2)
    y = np.clip(cy + rad * np.sin(ang), 1, h - 2)
    return [round(float(v), 2) for v in np.stack([x, y], 1).ravel()]


def concave(cx, cy, s):
    """An L-shaped (concave) polygon of size s around (cx, cy)."""
    pts = [(-1, -1), (0.1, -1), (0.1, 0.35), (1, 0.35), (1, 1), (-1, 1)]
    return [round(float(v), 2) for x, y in pts for v in (cx + x * s + 0.3, cy + y * s + 0.7)]


def rle_counts(mask: np.ndarray) -> list:
    """Column-major runs of a 0/1 mask, starting with a run of zeros."""
    flat = mask.T.ravel()
    cuts = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], cuts, [flat.size]])).tolist()
    return ([0] if flat[0] else []) + runs


def rle_to_string(counts) -> str:
    """pycocotools' ``rleToString``: each count (a delta from the count two
    places back, after the third) in 5-bit groups, low first, 0x20 marking
    a continuation and 0x10 the sign of the last group, offset by 48."""
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def exif_segment(orientation: int) -> bytes:
    """An APP1 Exif segment holding IFD0 with the orientation tag alone."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def polygon_mask(poly, h, w):
    m = np.zeros((h, w), np.uint8)
    cv2.fillPoly(m, [np.round(np.asarray(poly).reshape(-1, 2)).astype(np.int32)], 1)
    return m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="tests/data/coco_fixture")
    ap.add_argument("--seed", type=int, default=2017)
    a = ap.parse_args(argv)
    rng = np.random.default_rng(a.seed)
    out = Path(a.out)
    if out.exists():
        shutil.rmtree(out)
    val, paint, dec = out / "coco" / "val2017", out / "painting", out / "decoded_cv2"
    for d in (val, paint, dec):
        d.mkdir(parents=True)

    images, anns = [], []
    jpeg = [int(cv2.IMWRITE_JPEG_QUALITY), 90]

    def add_image(iid, name, h, w):
        images.append({"id": iid, "file_name": name, "height": h, "width": w,
                       "license": 1, "date_captured": "2013-11-14 16:28:13"})

    def add_ann(iid, cat, seg, h, w, crowd=0, area=None):
        if isinstance(seg, list):
            mask = np.zeros((h, w), np.uint8)
            for poly in seg:
                mask |= polygon_mask(poly, h, w)
            bbox_src = mask
        else:
            bbox_src = None
        if area is None:
            area = float(bbox_src.sum()) if bbox_src is not None else 0.0
        anns.append({"id": 100 + len(anns), "image_id": iid, "category_id": cat,
                     "segmentation": seg, "area": area, "iscrowd": crowd,
                     "bbox": [0.0, 0.0, float(w), float(h)]})

    # 1: landscape baseline, a simple star (kept) and a small one (area < 40,000)
    h, w = 480, 640
    cv2.imwrite(str(val / "000000000001.jpg"), smooth_image(rng, h, w), jpeg)
    add_image(1, "000000000001.jpg", h, w)
    add_ann(1, 1, [star(rng, 320, 240, 120, 200, 24, w, h)], h, w)
    add_ann(1, 1, [star(rng, 120, 100, 30, 60, 10, w, h)], h, w)
    # 2: portrait baseline, a concave polygon
    h, w = 640, 480
    cv2.imwrite(str(val / "000000000002.jpg"), smooth_image(rng, h, w), jpeg)
    add_image(2, "000000000002.jpg", h, w)
    add_ann(2, 2, [concave(240, 330, 190)], h, w)
    # 3: progressive; a two-part polygon (two components) and an uncompressed RLE
    h, w = 480, 640
    cv2.imwrite(str(val / "000000000003.jpg"), smooth_image(rng, h, w),
                jpeg + [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1])
    add_image(3, "000000000003.jpg", h, w)
    add_ann(3, 1, [star(rng, 170, 240, 90, 140, 12, w, h),
                   star(rng, 480, 240, 90, 140, 12, w, h)], h, w)
    rle_mask = polygon_mask(star(rng, 330, 230, 130, 190, 20, w, h), h, w)
    add_ann(3, 2, {"counts": rle_counts(rle_mask), "size": [h, w]}, h, w, crowd=1,
            area=float(rle_mask.sum()))
    # 4: grayscale JPEG
    cv2.imwrite(str(val / "000000000004.jpg"), smooth_image(rng, h, w, gray=True), jpeg)
    add_image(4, "000000000004.jpg", h, w)
    add_ann(4, 2, [star(rng, 300, 250, 140, 200, 18, w, h)], h, w)
    # 5: stored 640x480 with EXIF orientation 6, read as 480x640
    ok, buf = cv2.imencode(".jpg", smooth_image(rng, 480, 640), jpeg)
    data = buf.tobytes()
    (val / "000000000005.jpg").write_bytes(data[:2] + exif_segment(6) + data[2:])
    h, w = cv2.imread(str(val / "000000000005.jpg")).shape[:2]
    assert (h, w) == (640, 480), (h, w)
    add_image(5, "000000000005.jpg", h, w)
    add_ann(5, 1, [star(rng, 240, 330, 140, 200, 16, w, h)], h, w)
    # 6: a PNG; a polygon and a compressed-RLE crowd annotation
    h, w = 480, 640
    cv2.imwrite(str(val / "000000000006.png"), smooth_image(rng, h, w))
    add_image(6, "000000000006.png", h, w)
    add_ann(6, 2, [star(rng, 330, 250, 130, 200, 20, w, h)], h, w)
    crowd = polygon_mask(star(rng, 300, 240, 140, 200, 14, w, h), h, w)
    add_ann(6, 1, {"counts": rle_to_string(rle_counts(crowd)), "size": [h, w]}, h, w,
            crowd=1, area=float(crowd.sum()))

    (out / "coco").mkdir(exist_ok=True)
    with open(out / "coco" / "instances_val2017.json", "w") as f:
        json.dump({"info": {"description": "fake MS-COCO fixture", "year": 2017},
                   "licenses": [{"id": 1, "name": "fixture"}],
                   "images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person", "supercategory": "person"},
                                  {"id": 2, "name": "dog", "supercategory": "animal"}]},
                  f, indent=1)

    for name, (h, w) in (("p1.jpg", (400, 500)), ("p2.jpg", (640, 800)),
                         ("p3.jpg", (480, 640))):
        cv2.imwrite(str(paint / name), smooth_image(rng, h, w), jpeg)
    cv2.imwrite(str(paint / "p4.png"), smooth_image(rng, 450, 600))

    hashes = {}
    for folder, tag in ((val, "val2017"), (paint, "painting")):
        for path in sorted(folder.glob("*.jpg")):
            cv2.imwrite(str(dec / f"{tag}_{path.stem}.png"), cv2.imread(str(path)))
        for path in sorted(folder.glob("*.png")):
            arr = cv2.imread(str(path))
            hashes[f"{tag}/{path.name}"] = [list(arr.shape),
                                            hashlib.sha256(arr.tobytes()).hexdigest()]
    with open(dec / "png_sha256.json", "w") as f:
        json.dump(hashes, f, indent=1)
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: {total / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
