"""The port's MS-COCO / Painting test-set source against the JAX package's,
on the committed fixture (``tests/data/coco_fixture/``, written by
``make_coco_fixture.py``) and on seeded random inputs, on the CPU. Skips
without OpenCV, which the JAX package's loader needs.

- ``SimpleCOCO`` answers every query as the JAX reader does; its masks
  equal the JAX reader's (``cv2.fillPoly`` after ``np.round``) on every
  polygon and uncompressed RLE of the fixture.
- ``fill_poly`` against ``cv2.fillPoly``: bit for bit on 100 seeded random
  polygons whose rounded vertices lie inside the image. On 100 seeded
  random polygons with float vertices anywhere in [0, width] x [0, height],
  as MS-COCO's are, the polygons with a vertex rounded onto the far border
  (x = width or y = height) go through OpenCV's clipping path, which the
  port follows only in part: 13 of the 100 differ, in 185 pixels, all in the
  image's outermost row or column. The test holds to at most those counts
  and to that place.
- Compressed RLE (pycocotools' string form) decodes to the mask that its
  uncompressed runs give, the string made by the test's own encoder (a
  transcription of pycocotools' ``rleToString``).
- ``resize_linear_u8`` equals ``cv2.resize`` bit for bit at the loader's
  scales, on 0/1 masks and 3-channel images.
- PNG decoding equals ``cv2.imread`` bit for bit; PNGs the port writes read
  back in OpenCV bit for bit; the EXIF orientation transform equals
  OpenCV's for all eight orientations. A JPEG whose chroma is subsampled
  other than by 1 or 2 along each axis is refused.
- ``load_coco_foregrounds`` / ``load_painting_backgrounds`` pick what the
  JAX loader picks from the same seeds, and their masks, objects and
  backgrounds are equal at 147x147 and 587x587. The JAX reader raises on
  compressed RLE without pycocotools (absent here), so it is given the
  test's own decoder for it, as pycocotools would decode.
- ``generate_synthetic_data(source="coco")`` against the JAX generator's,
  from JAX's own depth-plane draws and key points (as
  tests/test_torch_realistic_gen.py injects them): the clean images within
  rtol 1e-4 / atol 1e-2 on values up to 255 (the blurs are summed in
  another order), the depths within 1e-5; alphas in [180, 200) and the
  noisy counts integers in [0, round(alpha)] (the two packages draw noise
  from different generators).
- Without OpenCV the port imports and writes a set from the fixture's PNG
  entries on the CPU; a JPEG on the CPU raises ``ImportError`` naming
  OpenCV. Missing files raise ``FileNotFoundError`` naming the path.
- The shape generator's PNG previews equal the JAX package's, read back by
  OpenCV, on the same arrays.
"""

import json
import math
import os
import random
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blurry_edges_tpu.data.coco as jcoco  # noqa: E402
from blurry_edges_tpu.config import get_args as jax_get_args  # noqa: E402
from blurry_edges_tpu.data import realistic_gen as jrg  # noqa: E402
from blurry_edges_tpu.data import shapes_gen as jsg  # noqa: E402

from blurry_edges_tpu_torch.config import get_args  # noqa: E402
from blurry_edges_tpu_torch.data import coco  # noqa: E402
from blurry_edges_tpu_torch.data import realistic_gen as rg  # noqa: E402
from blurry_edges_tpu_torch.data import shapes_gen as sg  # noqa: E402
from blurry_edges_tpu_torch.ops.resize import resize_linear_u8  # noqa: E402
from blurry_edges_tpu_torch.data import imageio  # noqa: E402

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "coco_fixture"
FRGD, BKGD = f"{FIXTURE}/coco/", f"{FIXTURE}/painting/"
ANNOTATIONS = f"{FRGD}instances_val2017.json"
SEED = 1869
BORDER_BAD_POLYGONS, BORDER_BAD_PIXELS = 13, 185


def rle_to_string(counts) -> str:
    """pycocotools' rleToString, transcribed apart from the port's decoder."""
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        while True:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if ch & 0x10 else (x != 0)
            out.append(chr((ch | 0x20 if more else ch) + 48))
            if not more:
                break
    return "".join(out)


def rle_from_string(s: str) -> list:
    """pycocotools' rleFrString, transcribed apart from the port's decoder,
    for the JAX reader (which needs pycocotools for it)."""
    counts, p = [], 0
    while p < len(s):
        x = k = 0
        while True:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << 5 * k
            p, k = p + 1, k + 1
            if not c & 0x20:
                if c & 0x10:
                    x |= -1 << 5 * k
                break
        counts.append(x + (counts[-2] if len(counts) > 2 else 0))
    return counts


def runs_of(mask) -> list:
    flat = np.asarray(mask).T.ravel()
    cuts = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], cuts, [flat.size]])).tolist()
    return ([0] if flat[0] else []) + runs


class JaxCOCOWithStrings(jcoco.SimpleCOCO):
    """The JAX reader, given the compressed-RLE decoding that pycocotools
    would add to it."""

    def annToMask(self, ann):
        seg = ann["segmentation"]
        if isinstance(seg, dict) and isinstance(seg["counts"], str):
            return super().annToMask({**ann, "segmentation": {
                "counts": rle_from_string(seg["counts"]), "size": seg["size"]}})
        return super().annToMask(ann)


@pytest.fixture
def jax_reader(monkeypatch):
    monkeypatch.setattr(jcoco, "open_coco", JaxCOCOWithStrings)


def args_for(argv=()):
    base = ["--frgd_path", FRGD, "--bkgd_path", BKGD, *argv]
    return get_args("data_gen_test", argv=base), jax_get_args("data_gen_test", argv=base)


# ------------------------------------------------------------------ reader

def test_simple_coco_matches_jax():
    ours, theirs = coco.SimpleCOCO(ANNOTATIONS), JaxCOCOWithStrings(ANNOTATIONS)
    cats = theirs.getCatIds()
    assert ours.getCatIds() == cats and len(cats) >= 2
    assert ours.loadCats(cats) == theirs.loadCats(cats)
    assert ours.getImgIds() == theirs.getImgIds()
    for c in theirs.loadCats(cats):
        ids = theirs.getCatIds(catNms=c["name"])
        assert ours.getCatIds(catNms=c["name"]) == ours.getCatIds(catNms=[c["name"]]) == ids
        imgs = theirs.getImgIds(catIds=ids)
        assert ours.getImgIds(catIds=ids) == imgs
        for i in imgs:
            anns = theirs.getAnnIds(i, catIds=ids)
            assert ours.getAnnIds(i, catIds=ids) == anns
            assert ours.loadAnns(anns) == theirs.loadAnns(anns)
            assert ours.loadImgs(i) == theirs.loadImgs(i) == theirs.loadImgs([i])
    kinds = set()
    for ann in theirs.anns.values():
        seg = ann["segmentation"]
        kinds.add("polygon" if isinstance(seg, list) else type(seg["counts"]).__name__)
        np.testing.assert_array_equal(ours.annToMask(ann), theirs.annToMask(ann))
    assert kinds == {"polygon", "list", "str"}


def test_compressed_rle_is_the_uncompressed_mask():
    rng = np.random.default_rng(5)
    reader = coco.SimpleCOCO(ANNOTATIONS)
    masks = [reader.annToMask(a) for a in reader.anns.values()]
    masks += [(rng.random((37, 23)) < p).astype(np.uint8) for p in (0.02, 0.5, 0.98)]
    masks += [np.ones((5, 7), np.uint8), np.zeros((5, 7), np.uint8)]
    for m in masks:
        h, w = m.shape
        runs = runs_of(m)
        np.testing.assert_array_equal(coco.rle_decode(runs, h, w), m)
        assert coco.rle_from_string(rle_to_string(runs)) == runs
        ann_ids = {"image_id": 1}
        reader.imgs[1] = {"id": 1, "height": h, "width": w}
        got = reader.annToMask({**ann_ids, "segmentation": {"counts": rle_to_string(runs),
                                                            "size": [h, w]}})
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(
            got, jcoco.SimpleCOCO.annToMask(reader, {**ann_ids, "segmentation": {
                "counts": runs, "size": [h, w]}}))


def random_polygons(seed, n, inside):
    """n star-shaped (simple) polygons with float vertices, on 640x480 or
    480x640: within [0, W] x [0, H] as MS-COCO's, or, ``inside``, within
    [0, W - 1] x [0, H - 1]."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        H, W = ((480, 640), (640, 480))[rng.integers(2)]
        k = int(rng.integers(3, 40))
        c = rng.uniform([0, 0], [W, H])
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(5, 0.6 * max(H, W), k)
        pts = c + rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
        yield H, W, np.clip(pts, 0, [W - inside, H - inside])


def fills(H, W, pts):
    ip = np.round(pts).astype(np.int32)
    want = np.zeros((H, W), np.uint8)
    cv2.fillPoly(want, [ip], 1)
    got = np.zeros((H, W), np.uint8)
    coco.fill_poly(got, ip)
    return got, want, ip


def test_fill_poly_matches_opencv_inside():
    for H, W, pts in random_polygons(11, 100, inside=True):
        got, want, _ = fills(H, W, pts)
        np.testing.assert_array_equal(got, want)


def test_fill_poly_against_opencv_on_the_border():
    bad = pixels = 0
    for H, W, pts in random_polygons(12, 100, inside=False):
        got, want, ip = fills(H, W, pts)
        diff = np.argwhere(got != want)
        if len(diff):
            bad, pixels = bad + 1, pixels + len(diff)
            assert (ip[:, 0] == W).any() or (ip[:, 1] == H).any()
            y, x = diff.T
            assert (np.minimum.reduce([y, x, H - 1 - y, W - 1 - x]) == 0).all()
    assert bad <= BORDER_BAD_POLYGONS and pixels <= BORDER_BAD_PIXELS, (bad, pixels)


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (427, 640)])
@pytest.mark.parametrize("target", [147, 587])
def test_resize_matches_opencv(shape, target):
    rng = np.random.default_rng(target + shape[0])
    scale = target / min(shape)
    w, h = int(round(shape[1] * scale)), int(round(shape[0] * scale))
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    mask = (rng.random(shape) < 0.5).astype(np.uint8)
    for a in (img, mask, cv2.GaussianBlur(img, (0, 0), 3)):
        np.testing.assert_array_equal(resize_linear_u8(torch.from_numpy(a), w, h).numpy(),
                                      cv2.resize(a, (w, h)))


# --------------------------------------------------------------- image I/O

def test_palette_png_matches_opencv(tmp_path):
    """An 8-bit palette PNG (OpenCV writes none), rows unfiltered."""
    import struct
    import zlib

    rng = np.random.default_rng(3)
    idx = rng.integers(0, 7, (9, 13)).astype(np.uint8)
    palette = rng.integers(0, 256, (7, 3)).astype(np.uint8)
    raw = np.concatenate([np.zeros((9, 1), np.uint8), idx], axis=1).tobytes()
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b                # noqa: E731
                          + struct.pack(">I", zlib.crc32(k + b) & 0xFFFFFFFF))
    data = (imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 13, 9, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.tobytes()) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))
    (tmp_path / "p.png").write_bytes(data)
    want = cv2.imread(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(imageio.decode_png(data), want)
    np.testing.assert_array_equal(want, palette[idx][..., ::-1])


@pytest.mark.parametrize("shape", [(31, 45, 3), (31, 45), (20, 33, 4), (480, 640, 3)])
def test_png_decode_and_write_match_opencv(tmp_path, shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[: shape[0] // 2] = cv2.GaussianBlur(img, (0, 0), 2)[: shape[0] // 2]  # filtered rows
    src = str(tmp_path / "cv.png")
    cv2.imwrite(src, img)
    np.testing.assert_array_equal(imageio.decode_png(Path(src).read_bytes()), cv2.imread(src))
    np.testing.assert_array_equal(imageio.imread(src, "cpu").numpy(), cv2.imread(src))
    mine = str(tmp_path / "port.png")
    imageio.imwrite_png(mine, img)
    np.testing.assert_array_equal(cv2.imread(mine, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(imageio.decode_png(Path(mine).read_bytes()), cv2.imread(mine))


def test_fixture_images_decode_as_opencv():
    hashes = json.loads((FIXTURE / "decoded_cv2" / "png_sha256.json").read_text())
    for key in hashes:
        folder = "coco/val2017" if key.startswith("val2017") else "painting"
        path = str(FIXTURE / folder / key.split("/")[1])
        np.testing.assert_array_equal(imageio.imread(path, "cpu").numpy(), cv2.imread(path))
    for path in sorted(FIXTURE.glob("**/*.jpg")):
        tag = "val2017" if "val2017" in str(path) else "painting"
        ref = imageio.decode_png((FIXTURE / "decoded_cv2" / f"{tag}_{path.stem}.png").read_bytes())
        np.testing.assert_array_equal(imageio.imread(str(path), "cpu").numpy(), ref)
    assert imageio.imread(str(FIXTURE / "missing.jpg"), "cpu") is None
    assert imageio.imread(ANNOTATIONS, "cpu") is None


def test_exif_orientation_matches_opencv(tmp_path):
    import make_coco_fixture as fixture_tool

    data = (FIXTURE / "coco" / "val2017" / "000000000001.jpg").read_bytes()
    plain = cv2.imread(str(FIXTURE / "coco" / "val2017" / "000000000001.jpg"))
    assert imageio.jpeg_orientation(data) == 1
    for o in range(1, 9):
        path = tmp_path / f"o{o}.jpg"
        spliced = data[:2] + fixture_tool.exif_segment(o) + data[2:]
        path.write_bytes(spliced)
        assert imageio.jpeg_orientation(spliced) == o
        got = imageio.apply_orientation(torch.from_numpy(plain), o).numpy()
        np.testing.assert_array_equal(got, cv2.imread(str(path)))


def libjpeg_upsample(c, h, v):
    """jdsample.c's h2v2 / h2v1 / h1v2 fancy upsampling, loop for loop, the
    context rows above and below the image its edge rows."""
    c = c.astype(np.int64)
    ch, cw = c.shape
    rows = []
    for r in range(ch):
        for k in range(v):
            if v == 1:
                rows.append((c[r] * 4, None))
            else:
                other = c[max(r - 1, 0)] if k == 0 else c[min(r + 1, ch - 1)]
                rows.append((c[r] * 3 + other, 1 if k == 0 else 2))
    out = []
    for colsum, bias in rows:
        if h == 1:
            out.append(colsum // 4 if v == 1 else (colsum + bias) >> 2)
            continue
        line = []
        for x in range(cw):
            this, last = colsum[x], colsum[max(x - 1, 0)]
            nxt = colsum[min(x + 1, cw - 1)]
            if v == 2:
                line += [(this * 3 + last + 8) >> 4, (this * 3 + nxt + 7) >> 4]
            else:
                a, b, cc = this // 4, last // 4, nxt // 4
                line += [(a * 3 + b + 1) >> 2, (a * 3 + cc + 2) >> 2]
        out.append(np.array(line))
    return np.array(out)


@pytest.mark.parametrize("h,v", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_fancy_upsampling_and_colour_conversion_match_libjpeg(h, v):
    """``fancy_upsample`` against a loop transcription of libjpeg-turbo's
    jdsample.c, and ``ycc_to_bgr`` against jdcolor.c's formulas in
    float64 rounded as its tables round (the card holds the whole decode
    to OpenCV's pixels)."""
    rng = np.random.default_rng(h * 3 + v)
    H, W = 37, 51
    ch, cw = -(-H // v), -(-W // h)
    c = rng.integers(0, 256, (ch, cw)).astype(np.uint8)
    want = libjpeg_upsample(c, h, v)[:H, :W]
    got = imageio.fancy_upsample(torch.from_numpy(c), h, v, H, W).numpy()
    np.testing.assert_array_equal(got, want)
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cr = rng.integers(0, 256, (ch, cw)).astype(np.uint8)
    bgr = imageio.ycc_to_bgr(torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(cr),
                             h, v).numpy().astype(np.int64)
    cbu, cru = want - 128, libjpeg_upsample(cr, h, v)[:H, :W] - 128
    fix = lambda x: int(x * 65536 + 0.5)                               # noqa: E731
    r = y + ((fix(1.402) * cru + 32768) >> 16)
    b = y + ((fix(1.772) * cbu + 32768) >> 16)
    g = y + ((-fix(0.34414) * cbu + 32768 - fix(0.71414) * cru) >> 16)
    np.testing.assert_array_equal(bgr, np.clip(np.stack([b, g, r], -1), 0, 255))


@pytest.mark.parametrize("widths,heights,want", [
    ((320, 320), (240, 240), (2, 2)),        # 4:2:0
    ((320, 320), (480, 480), (2, 1)),        # 4:2:2
    ((640, 640), (480, 480), (1, 1)),        # 4:4:4
    ((160, 160), (480, 480), None),          # 4:1:1
    ((320, 160), (240, 240), None),          # Cb and Cr of unequal size
])
def test_chroma_factors_accepts_only_what_fancy_upsample_decodes(widths, heights, want):
    """A 640x480 JPEG's chroma layouts, as nvJPEG's header reports them:
    subsampling by 1 or 2 along each axis gives its factors; any other
    raises ``ValueError`` naming the file and the planes' sizes (nvJPEG's
    own conversion would not give OpenCV's pixels)."""
    if want is not None:
        assert imageio.chroma_factors(480, 640, widths, heights, "a.jpg") == want
        return
    with pytest.raises(ValueError, match=rf"a\.jpg: chroma planes of {widths[0]}x{heights[0]}"):
        imageio.chroma_factors(480, 640, widths, heights, "a.jpg")


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("size", [147, 587])
def test_loaders_match_jax(jax_reader, size):
    ours, theirs = args_for()
    n = 6
    random.seed(SEED)
    np.random.seed(SEED)
    j_masks, j_objs = jrg.load_coco_foregrounds(theirs, (size, size), n)
    j_bgs = jrg.load_painting_backgrounds(theirs, (size, size), n)
    masks, objs = rg.load_coco_foregrounds(ours, (size, size), n, random.Random(SEED), "cpu")
    bgs = rg.load_painting_backgrounds(ours, (size, size), n, np.random.RandomState(SEED), "cpu")
    assert masks.dtype == torch.bool and objs.dtype == bgs.dtype == torch.uint8
    np.testing.assert_array_equal(masks.numpy(), j_masks)
    np.testing.assert_array_equal(objs.numpy(), j_objs)
    np.testing.assert_array_equal(bgs.numpy(), j_bgs)
    assert masks.any(dim=(1, 2)).all()


def jax_plane_draws(seed, n):
    """_coco_layers' depth-plane draws, in the JAX generator's key order:
    the alphas' key first, then a depth key and a noise key a sample."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append(dict(rel=torch.from_numpy(np.array(
                            jnp.sort(jax.random.uniform(k1, (4,)))[::-1])),
                        angles=torch.from_numpy(np.array(
                            jax.random.uniform(k2, (2,)) * 2 * math.pi))))
        key, _ = jax.random.split(key)
    return out


def jnp_linspace(start, stop, num):
    return torch.from_numpy(np.array(jnp.linspace(jnp.float32(start.item()),
                                                  jnp.float32(stop.item()), num)))


def test_generate_coco_matches_jax(jax_reader, monkeypatch, tmp_path):
    n, H = 3, 48
    argv = ["--img_size", str(H), str(H), "--num_sample_test", str(n)]
    ours, theirs = args_for(argv + ["--data_path", str(tmp_path / "port")])
    theirs.data_path = str(tmp_path / "jax")
    random.seed(SEED)
    np.random.seed(SEED)
    with jax.default_matmul_precision("highest"):
        jrg.SyntheticRealisticDataGenerator(theirs, source="coco",
                                            n_interval=6).generate_synthetic_data()
    draws = iter(jax_plane_draws(SEED, n))
    monkeypatch.setattr(rg, "draw_planes", lambda g: next(draws))
    monkeypatch.setattr(rg, "_linspace", jnp_linspace)
    rg.SyntheticRealisticDataGenerator(ours, source="coco", n_interval=6,
                                       device="cpu").generate_synthetic_data()
    ld = lambda who, k: np.load(tmp_path / who / f"{k}.npy")          # noqa: E731
    for who in ("port", "jax"):
        assert ld(who, "images_gt").shape == ld(who, "images_ny").shape == (n, 2, H, H, 3)
        assert ld(who, "depth_maps").shape == (n, H, H) and ld(who, "alphas").shape == (n,)
    np.testing.assert_allclose(ld("port", "depth_maps"), ld("jax", "depth_maps"),
                               rtol=1e-5, atol=1e-5)
    clean = lambda who: (ld(who, "images_gt") * 255.0                  # noqa: E731
                         / ld(who, "alphas")[:, None, None, None, None])
    np.testing.assert_allclose(clean("port"), clean("jax"), rtol=1e-4, atol=1e-2)
    alphas, ny = ld("port", "alphas"), ld("port", "images_ny")
    a = alphas[:, None, None, None, None]
    assert ld("port", "images_gt").dtype == ny.dtype == np.float32
    assert ((alphas >= 180) & (alphas < 200)).all()
    assert (ny == np.round(ny)).all() and ny.min() >= 0 and (ny <= np.round(a)).all()
    assert (ld("port", "images_gt") >= 0).all() and (ld("port", "images_gt") <= a + 1e-3).all()


def test_missing_files_raise(tmp_path):
    def try_paths(frgd, bkgd):
        a = get_args("data_gen_test", argv=["--frgd_path", frgd, "--bkgd_path", bkgd,
                                            "--data_path", str(tmp_path / "out")])
        rg.SyntheticRealisticDataGenerator(a, source="coco", device="cpu")

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="instances_val2017.json"):
        try_paths(f"{empty}/", BKGD)
    shutil.copy(ANNOTATIONS, empty / "instances_val2017.json")
    with pytest.raises(FileNotFoundError, match="val2017"):
        try_paths(f"{empty}/", BKGD)
    with pytest.raises(FileNotFoundError, match="no_paintings"):
        try_paths(FRGD, f"{tmp_path}/no_paintings/")
    assert not (tmp_path / "out").exists()


def test_png_only_set_without_opencv(tmp_path):
    """With cv2 unimportable, the port writes a set from the fixture's PNG
    entries on the CPU through the command line; a JPEG then raises."""
    d = json.loads(Path(ANNOTATIONS).read_text())
    keep = {i["id"] for i in d["images"] if i["file_name"].endswith(".png")}
    d["images"] = [i for i in d["images"] if i["id"] in keep]
    d["annotations"] = [a for a in d["annotations"] if a["image_id"] in keep]
    (tmp_path / "coco" / "val2017").mkdir(parents=True)
    (tmp_path / "coco" / "instances_val2017.json").write_text(json.dumps(d))
    for i in d["images"]:
        shutil.copy(FIXTURE / "coco" / "val2017" / i["file_name"], tmp_path / "coco" / "val2017")
    (tmp_path / "painting").mkdir()
    shutil.copy(FIXTURE / "painting" / "p4.png", tmp_path / "painting")
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "from blurry_edges_tpu_torch import cli\n"
        "from blurry_edges_tpu_torch.data import imageio\n"
        f"cli.gen_test_main(['--coco', '--cuda', 'cpu', '--frgd_path', '{tmp_path}/coco/',\n"
        f"    '--bkgd_path', '{tmp_path}/painting/', '--data_path', '{tmp_path}/data_test',\n"
        "    '--img_size', '33', '33', '--num_sample_test', '2'])\n"
        "try:\n"
        f"    imageio.imread('{FIXTURE}/painting/p1.jpg', 'cpu')\n"
        "except ImportError as e:\n"
        "    print('raised', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "raised" in res.stdout and "OpenCV" in res.stdout
    gt = np.load(tmp_path / "data_test" / "images_gt.npy")
    ny = np.load(tmp_path / "data_test" / "images_ny.npy")
    assert gt.shape == ny.shape == (2, 2, 33, 33, 3) and np.isfinite(gt).all()
    depth = np.load(tmp_path / "data_test" / "depth_maps.npy")
    assert depth.shape == (2, 33, 33) and depth.min() >= 0.75 and depth.max() <= 1.18 + 1e-6


# ---------------------------------------------------------------- previews

def test_shape_previews_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    n, H = 3, 29
    aif = rng.random((n, H, H, 3)).astype(np.float32)
    bloc = (rng.random((n, H, H)) < 0.2).astype(np.float32)
    depth = rng.uniform(0.75, 1.18, (n, H, H)).astype(np.float32)
    images = rng.integers(0, 256, (n, 2, H, H, 3)).astype(np.float32)
    args = get_args("data_gen_train_val", argv=["--img_size", str(H), str(H)])

    jgen = object.__new__(jsg.SyntheticShapeDataGenerator)
    jgen.data_path, jgen.cfg = str(tmp_path / "jax"), sg.SyntheticShapeDataGenerator(
        args, device="cpu").cfg
    jgen.images_aif, jgen.boundary_locations, jgen.image_depths = aif, bloc, depth
    jgen.images = images
    jgen._write_previews("train")

    pgen = sg.SyntheticShapeDataGenerator(args, device="cpu", previews=True)
    pgen.data_path, pgen.images = str(tmp_path / "port"), images.astype(np.uint8)
    pgen._write_previews("train", {"images_aif": aif, "boundary_locations": bloc,
                                   "image_depths": depth})
    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert names == sorted(os.listdir(tmp_path / "port" / "train")) and len(names) == 5 * n
    for name in names:
        a = cv2.imread(str(tmp_path / "jax" / "train" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "port" / "train" / name), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape and a.dtype == b.dtype and (a == b).all(), name


def test_shape_generator_writes_previews_when_asked(tmp_path):
    argv = ["--img_size", "41", "41", "--num_sample_train", "3", "--num_sample_val", "2",
            "--data_path", str(tmp_path)]
    gen = sg.SyntheticShapeDataGenerator(get_args("data_gen_train_val", argv=argv),
                                         device="cpu", previews=True)
    gen.generate_synthetic_data(train=True)
    names = sorted(os.listdir(tmp_path / "train"))
    assert len(names) == 5 * 3 and "clean_2_1.png" in names and "depth_0.png" in names
    clean = cv2.imread(str(tmp_path / "train" / "clean_1_0.png"))
    np.testing.assert_array_equal(clean, gen.images[1, 0])
    off = sg.SyntheticShapeDataGenerator(get_args("data_gen_train_val", argv=argv[:-1] + [
        str(tmp_path / "off")]), device="cpu")
    off.generate_synthetic_data(train=True)
    assert not (tmp_path / "off" / "train").exists()
