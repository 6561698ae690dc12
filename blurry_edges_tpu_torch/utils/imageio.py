"""The port's counterpart of ``cv2.imread(path)`` and ``cv2.imwrite(path,
uint8)`` as the JAX package uses them: images come back as ``uint8``
tensors of shape (H, W, 3) in BGR order, as OpenCV's ``IMREAD_COLOR``
gives them, on ``device``.

- **PNG** (8-bit gray, gray + alpha, RGB, RGBA and palette, not
  interlaced) is decoded with ``zlib`` and numpy on any device, bit for bit
  as OpenCV reads it: gray is replicated into three channels, alpha is
  dropped, palette indices are looked up. The five row filters are undone
  along the anti-diagonals of the image (a pixel needs its left, upper and
  upper-left neighbours), so each step is one numpy operation over a
  diagonal. ``imwrite_png`` writes gray (H, W), BGR (H, W, 3) and BGRA
  (H, W, 4) ``uint8`` arrays.
- **JPEG on a CUDA device** goes through nvJPEG, the CUDA toolkit's JPEG
  decoder (``csrc/jpeg_decode.cu``, built at the first decode into its own
  ``_build/libimage_<hash>.so``), straight into device memory. A JPEG that
  nvJPEG refuses raises naming the file; nothing falls back to a CPU
  decoder. It is not a port of a TPU kernel: the JAX package decodes with a
  library too (OpenCV's libjpeg).
- **JPEG on the CPU** is ``cv2.imread``, imported when it is needed; without
  OpenCV it raises ``ImportError``.

Where nvJPEG and OpenCV are likely to disagree, and what is done:

- EXIF orientation: ``cv2.imread`` applies the orientation tag (APP1,
  tag 0x0112) by default; nvJPEG ignores it. ``jpeg_orientation`` reads
  the tag and ``apply_orientation`` flips and transposes the decoded
  image as OpenCV's ``ExifTransform`` does.
- Grayscale JPEGs: ``IMREAD_COLOR`` gives three equal channels. nvJPEG
  decodes the one component as ``NVJPEG_OUTPUT_Y`` and it is replicated.
  (The JAX loader's ``arr.ndim == 2`` skip never fires under
  ``IMREAD_COLOR``, so gray images are kept here too.)
- Progressive JPEGs: decoded by ``nvjpegDecode`` like baseline ones.
- CMYK / Adobe JPEGs (four components): refused with ``ValueError``.
- Chroma upsampling and colour conversion: libjpeg-turbo upsamples
  chroma with its "fancy" triangular filter; nvJPEG's own BGR output
  differs from it by tens of levels at chroma edges. So nvJPEG gives the
  YCbCr planes and ``ycc_to_bgr`` upsamples and converts them as libjpeg
  does. Chroma subsampled other than by 1 or 2 along each axis (4:1:1)
  raises ``ValueError`` naming the file. What remains is the IDCT's
  rounding, measured on the card (``chip_smoke.py``, phase 7c), not
  hidden.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"
# nvjpegStatus_t codes (nvjpeg.h)
NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
                 4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
                 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
                 10: "INCOMPLETE_BITSTREAM"}
CUDA_ERROR_BASE = 1000       # jpeg_decode.cu returns 1000 + cudaError_t for CUDA errors

_launches = {"nvjpeg_decode": 0}
_lock = threading.Lock()


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# --------------------------------------------------------------------- PNG

def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (none, sub, up, average, Paeth) on
    ``raw`` (H, 1 + W * bpp). Pixel (y, x) depends on (y, x - 1), (y - 1, x)
    and (y - 1, x - 1) only, so the anti-diagonals y + x = d are decoded
    one after another, each in one step."""
    kinds = raw[:, 0].astype(np.int16)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int16)
    if (kinds == 0).all():
        return filt.astype(np.uint8)
    out = np.zeros((H + 1, W + 1, bpp), np.int16)        # a zero row and column before
    rows = np.arange(H)
    for d in range(H + W - 1):
        y = rows[max(0, d - W + 1):min(H, d + 1)]
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kinds[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR, as ``cv2.imread(path)``."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{name}: only 8-bit non-interlaced PNGs are read "
                         f"(bit depth {depth}, color type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw[:H * (1 + W * channels)].reshape(H, 1 + W * channels), H, W, channels)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        rgb = palette[img[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(img[..., :1], 3, axis=2)
    else:
        rgb = img[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """A gray (H, W), BGR (H, W, 3) or BGRA (H, W, 4) uint8 array as PNG
    bytes, as ``cv2.imwrite`` stores it (RGB order in the file); every row
    with filter 0."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color, pix = 0, a[..., None]
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = 2 if a.shape[2] == 3 else 6
        pix = np.concatenate([a[..., 2::-1], a[..., 3:]], axis=2)
    else:
        raise ValueError(f"PNG writer takes (H, W), (H, W, 3) or (H, W, 4), got {a.shape}")
    H, W = pix.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), pix.reshape(H, -1)], axis=1)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def imwrite_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -------------------------------------------------------------------- JPEG

def jpeg_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of JPEG bytes, 1 without one: the
    tag 0x0112 of IFD0 in an APP1 ``Exif`` segment before the first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                     # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):             # start of scan, end of image
            return 1
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return _exif_orientation(body[6:])
        pos += 2 + length
    return 1


def _exif_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(e + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:        # SHORT
            value = struct.unpack(e + "H", entry[8:10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """(H, W, C) as OpenCV's ExifTransform turns it for ``orientation``:
    2 flip left-right, 3 rotate 180, 4 flip up-down, 5 transpose, 6
    transpose then flip left-right (90 clockwise), 7 transpose then rotate
    180, 8 transpose then flip up-down (90 counter-clockwise)."""
    if orientation >= 5:
        img = img.transpose(0, 1)
    flip = {2: [1], 3: [0, 1], 4: [0], 6: [1], 7: [0, 1], 8: [0]}.get(orientation)
    if flip:
        img = img.flip(flip)
    return img.contiguous()


# libjpeg's YCbCr -> RGB tables (jdcolor.c, build_ycc_rgb_table): 16-bit
# fixed point, FIX(x) = round(x * 2^16)
_FIX = lambda x: int(x * 65536 + 0.5)                                    # noqa: E731


def _ycc_tables(device):
    x = torch.arange(256, dtype=torch.int64, device=device) - 128
    half = 1 << 15
    return ((_FIX(1.40200) * x + half) >> 16, (_FIX(1.77200) * x + half) >> 16,
            -_FIX(0.71414) * x, -_FIX(0.34414) * x + half)


def fancy_upsample(c: torch.Tensor, h: int, v: int, H: int, W: int) -> torch.Tensor:
    """libjpeg-turbo's "fancy" chroma upsampling (jdsample.c, its default,
    which OpenCV keeps) of a (ch, cw) plane by h x v in {1, 2}, cropped to
    (H, W): each output sample 3/4 of its nearer and 1/4 of its farther
    input neighbour along each doubled axis (edges replicated), in
    libjpeg's integer rounding (h2v2: sums of 16ths, +8 or +7; h2v1 and
    h1v2: quarters, +1 or +2)."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    if (h == 2 and cw <= 2) or (v == 2 and ch <= 1):        # libjpeg's plain replication
        return c.repeat_interleave(v, 0).repeat_interleave(h, 1)[:H, :W]
    if v == 2:
        idx = torch.arange(ch, device=c.device)
        up, down = c[(idx - 1).clamp(min=0)], c[(idx + 1).clamp(max=ch - 1)]
        rows = torch.stack([3 * c + up, 3 * c + down], 1).reshape(2 * ch, cw)   # colsums
    else:
        rows = 4 * c
    if h == 2:
        idx = torch.arange(cw, device=c.device)
        left, right = rows[:, (idx - 1).clamp(min=0)], rows[:, (idx + 1).clamp(max=cw - 1)]
        if v == 2:
            out = torch.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4], 2)
        else:
            out = torch.stack([(3 * rows + left + 4) >> 4, (3 * rows + right + 8) >> 4], 2)
        out = out.reshape(rows.shape[0], 2 * cw)
    elif v == 2:
        out = torch.stack([(rows[0::2] + 1) >> 2, (rows[1::2] + 2) >> 2], 1).reshape(2 * ch, cw)
    else:
        out = c
    return out[:H, :W]


def ycc_to_bgr(y, cb, cr, h: int, v: int) -> torch.Tensor:
    """libjpeg's decoding of YCbCr planes (chroma subsampled by h x v) into
    (H, W, 3) uint8 BGR: ``fancy_upsample``, then jdcolor.c's
    ``ycc_rgb_convert`` with its tables and range limit."""
    H, W = y.shape
    cr_r, cb_b, cr_g, cb_g = _ycc_tables(y.device)
    cb = fancy_upsample(cb, h, v, H, W).long()
    cr = fancy_upsample(cr, h, v, H, W).long()
    y = y.long()
    b = y + cb_b[cb]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    r = y + cr_r[cr]
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)


def _decode_jpeg_cuda(data: bytes, device: torch.device, name: str) -> torch.Tensor:
    from ..ops._build import load_image_library

    lib = load_image_library().cdll
    comps, widths, heights = ctypes.c_int(), (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    _raise_on(lib.jpeg_info(data, len(data), idx, ctypes.byref(comps), widths, heights),
              name, "reading the header")
    if comps.value not in (1, 3):
        raise ValueError(f"{name}: a JPEG of {comps.value} components (CMYK or Adobe) is "
                         f"not decoded; only gray and YCbCr JPEGs are")
    H, W = heights[0], widths[0]
    if comps.value == 1:
        form, shapes, factors = 1, [(H, W)], None
    else:
        factors = chroma_factors(H, W, list(widths[1:3]), list(heights[1:3]), name)
        form, shapes = 2, [(heights[c], widths[c]) for c in range(3)]
    planes = [torch.empty(s, dtype=torch.uint8, device=device) for s in shapes]
    ptrs = [p.data_ptr() for p in planes] + [None] * (3 - len(planes))
    pitches = (ctypes.c_int * 3)(*[p.stride(0) for p in planes], *[0] * (3 - len(planes)))
    stream = torch.cuda.current_stream(device).cuda_stream
    with _lock:
        rc = lib.jpeg_decode(data, len(data), idx, form, *ptrs, pitches, stream)
        _launches["nvjpeg_decode"] += 1
    _raise_on(rc, name, "decoding")
    if form == 1:
        return planes[0][..., None].expand(H, W, 3).contiguous()
    return ycc_to_bgr(*planes, *factors)


def chroma_factors(H: int, W: int, widths, heights, name: str) -> tuple[int, int]:
    """The (horizontal, vertical) subsampling of a YCbCr JPEG's Cb and Cr
    planes, of sizes ``widths`` x ``heights``, against its (H, W) luma:
    1 or 2 along each axis, both planes alike, as ``fancy_upsample`` takes
    them. Any other layout (4:1:1, planes of unequal size) raises
    ``ValueError`` naming the file: nvJPEG's own conversion would differ
    from OpenCV's by tens of levels."""
    fh = {W: 1, (W + 1) // 2: 2}.get(widths[0])
    fv = {H: 1, (H + 1) // 2: 2}.get(heights[0])
    if fh and fv and widths[0] == widths[1] and heights[0] == heights[1]:
        return fh, fv
    raise ValueError(f"{name}: chroma planes of {widths[0]}x{heights[0]} and "
                     f"{widths[1]}x{heights[1]} against luma {W}x{H} are not subsampled "
                     f"by 1 or 2 along each axis; only those layouts are decoded as "
                     f"OpenCV decodes them")


def _raise_on(rc: int, name: str, what: str) -> None:
    if rc == 0:
        return
    if rc >= CUDA_ERROR_BASE:
        raise RuntimeError(f"{name}: CUDA error {rc - CUDA_ERROR_BASE} while {what}")
    raise ValueError(f"{name}: nvJPEG refused it while {what}: "
                     f"NVJPEG_STATUS_{NVJPEG_STATUS.get(rc, rc)}")


def _decode_jpeg_cpu(path: str) -> np.ndarray | None:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: a JPEG on the CPU is decoded by OpenCV (cv2.imread), "
                          f"which is not installed; decode on a CUDA device (nvJPEG) "
                          f"instead") from e
    return cv2.imread(path)


def decode_jpeg(data: bytes, device, name: str = "JPEG") -> torch.Tensor:
    """JPEG bytes -> (H, W, 3) uint8 BGR on a CUDA ``device`` through nvJPEG,
    EXIF orientation applied: nvJPEG's YCbCr planes go through
    ``ycc_to_bgr`` (libjpeg's chroma upsampling and colour conversion, as
    OpenCV decodes), a gray JPEG's one plane is replicated."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{name}: decode_jpeg takes a CUDA device, got {dev}")
    return apply_orientation(_decode_jpeg_cuda(data, dev, name), jpeg_orientation(data))


def imread(path: str, device="cuda") -> torch.Tensor | None:
    """``cv2.imread(path)`` on ``device``: (H, W, 3) uint8 BGR, or None for a
    file that is missing or is neither PNG nor JPEG (as OpenCV returns
    None)."""
    dev = torch.device(device)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(PNG_SIGNATURE):
        return torch.from_numpy(decode_png(data, path)).to(dev)
    if not data.startswith(JPEG_SOI):
        return None
    if dev.type == "cuda":
        return decode_jpeg(data, dev, path)
    arr = _decode_jpeg_cpu(path)
    return None if arr is None else torch.from_numpy(arr)

