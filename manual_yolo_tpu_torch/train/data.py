"""Host-side dataset loading and augmentation, without OpenCV or PyYAML.

Counterpart of ``manual_yolo_tpu/train/data.py``. Every function keeps its
signature and draws from the ``np.random.Generator`` in the same order and
number as the JAX package's, so one seed gives the same crops, boxes, masks
and generator state. The pixel operations stand in for cv2's:

  * ``cv2.imread`` -> ``runtime/png.py::imread_bgr``: PNG, JPEG and BMP
    files (``runtime/jpeg.py``, ``runtime/bmp.py``), the same bytes as cv2.
    Any other file, or one the readers cannot take, raises ``ValueError``
    naming the file (the JAX package skips a file cv2 cannot decode);
  * uint8 ``INTER_LINEAR`` resize -> the host library's ``resize_u8``, byte
    for byte; the f32 one -> ``ops/image.py::cv_resize``;
  * ``INTER_AREA`` downscale -> ``resize_area_u8``, byte for byte;
  * ``cvtColor`` BGR<->HSV and the LUT jitter -> ``hsv_jitter_u8``: BGR to
    HSV is cv2's integer algorithm, HSV to BGR its vectorised float path,
    both byte for byte;
  * bilinear ``warpAffine`` with a constant border of 114 ->
    ``warp_affine_u8``: cv2's float path (fused multiply-adds included);
  * ``yaml.safe_load`` of ``data.yaml`` -> ``load_yolo_names`` reads the
    ``names`` forms YOLO datasets use (a flow list, a block list, an index
    to name mapping).

The warp and the HSV jitter run in the host library (``csrc/host.cpp``)
where it is built; ``warp_affine_u8_plain`` and ``hsv_jitter_u8_plain``
are their numpy twins.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from manual_yolo_tpu_torch.ops.image import cv_resize
from manual_yolo_tpu_torch.runtime import native
from manual_yolo_tpu_torch.runtime.png import imread_bgr

f32 = np.float32

# ---------------------------------------------------------------------------
# cv2 pixel operations
# ---------------------------------------------------------------------------


def resize_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR) of a uint8 image."""
    return native.resize_u8(img, (out_h, out_w))


def _area_taps(n_in: int, n_out: int):
    """One axis of cv2's ``INTER_AREA`` (``computeResizeAreaTab``): per
    output index its source indices and f32 weights, padded to a fixed
    number of taps with weight 0, in cv2's summation order."""
    scale = n_in / n_out
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    t = max(len(r) for r in taps)
    idx = np.zeros((n_out, t), np.int64)
    w = np.zeros((n_out, t), f32)
    for d, row in enumerate(taps):
        for k, (s, a) in enumerate(row):
            idx[d, k], w[d, k] = s, f32(a)
    return idx, w


def resize_area_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_AREA)`` for a
    uint8 (H, W, C) downscale, byte for byte. Integer factors average their
    cell with the sum rounded half up; other factors accumulate the f32
    cell weights row by row in cv2's order and round half to even."""
    h, w = img.shape[:2]
    if out_w > w or out_h > h:
        raise ValueError(f"resize_area_u8 only downscales: {w}x{h} -> {out_w}x{out_h}")
    if w % out_w == 0 and h % out_h == 0:
        fx, fy = w // out_w, h // out_h
        s = img.astype(np.int64).reshape(out_h, fy, out_w, fx, -1).sum(axis=(1, 3))
        area = fx * fy
        return ((s + area // 2) // area).astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])
    xi, xw = _area_taps(w, out_w)
    yi, yw = _area_taps(h, out_h)
    src = img.astype(f32).reshape(h, w, -1)
    buf = np.zeros((h, out_w, src.shape[2]), f32)
    for k in range(xi.shape[1]):
        buf = buf + src[:, xi[:, k]] * xw[None, :, k, None]
    acc = np.zeros((out_h, out_w, src.shape[2]), f32)
    for k in range(yi.shape[1]):
        acc = acc + yw[:, k, None, None] * buf[yi[:, k]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV = np.zeros(256, np.int64)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` for uint8, byte for byte (H in
    [0, 180)): cv2's 12-bit fixed-point division tables."""
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` for uint8 as cv2's vectorised
    path computes it: f32 sector arithmetic on s and v scaled by 1/255, the
    result times 255 truncated. Equal to cv2 on every uint8 HSV triple."""
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    one = f32(1.0)
    # cv2 forms 1 - s*h with one rounding (a fused multiply-add); the f64
    # product is exact and matches it on every uint8 HSV triple
    fnma = lambda a, b: (1.0 - a.astype(np.float64) * b).astype(f32)
    tab = np.stack([v, v * (one - s), v * fnma(s, h), v * fnma(s, one - h)], axis=-1)
    out = np.take_along_axis(tab, _SECTORS[sector % 6], axis=-1)
    return np.clip(np.trunc(out * f32(255.0)), 0, 255).astype(np.uint8)


def hsv_luts(r: np.ndarray) -> np.ndarray:
    """The (3, 256) uint8 lookup tables of the HSV gain ``r`` (``_hsv_jitter``)."""
    x = np.arange(256, dtype=np.int16)
    return np.stack([((x * r[0]) % 180), np.clip(x * r[1], 0, 255),
                     np.clip(x * r[2], 0, 255)]).astype(np.uint8)


def hsv_jitter_u8_plain(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """BGR -> HSV, each channel through its table, HSV -> BGR."""
    hsv = bgr_to_hsv_u8(img)
    return hsv_to_bgr_u8(np.stack([luts[c][hsv[..., c]] for c in range(3)], axis=-1))


def hsv_jitter_u8(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """``hsv_jitter_u8_plain`` in the host library."""
    return native.hsv_jitter_u8(img, luts)


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """cv2's ``invertAffineTransform`` in f64, then cast to f32 as its
    float warp path holds the matrix."""
    m = m.astype(np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]]).astype(f32)


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` with one rounding, as cv2's fused multiply-adds: the
    f64 product of two f32 values is exact."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(f32)


def warp_affine_u8_plain(img: np.ndarray, m: np.ndarray, size: int, border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, m, (size, size), borderValue=(border,) * 3)``,
    bilinear, for a uint8 (H, W, 3) image, as cv2's float path computes it:
    each output pixel's source point from the inverted matrix in f32, its
    four neighbours (``border`` outside the image) blended by fused
    multiply-adds in f32, rounded half to even."""
    a = _inverse_affine(m)
    hh, ww = img.shape[:2]
    xs = np.arange(size, dtype=f32)[None, :]
    ys = np.arange(size, dtype=f32)[:, None]
    sxf = _fma(a[0, 0], xs, a[0, 1] * ys + a[0, 2])
    syf = _fma(a[1, 0], xs, a[1, 1] * ys + a[1, 2])
    sx = np.floor(sxf).astype(np.int64)
    sy = np.floor(syf).astype(np.int64)
    fx = (sxf - sx.astype(f32))[..., None]
    fy = (syf - sy.astype(f32))[..., None]
    src = img.astype(f32)

    def at(y, x):
        inside = (y >= 0) & (y < hh) & (x >= 0) & (x < ww)
        return np.where(inside[..., None], src[np.clip(y, 0, hh - 1), np.clip(x, 0, ww - 1)],
                        f32(border))

    p00, p01, p10, p11 = at(sy, sx), at(sy, sx + 1), at(sy + 1, sx), at(sy + 1, sx + 1)
    top = _fma(fx, p01 - p00, p00)
    bot = _fma(fx, p11 - p10, p10)
    return np.clip(np.rint(_fma(fy, bot - top, top)), 0, 255).astype(np.uint8)


def warp_affine_u8(img: np.ndarray, m: np.ndarray, size: int, border: int = 114) -> np.ndarray:
    """``warp_affine_u8_plain`` in the host library."""
    return native.warp_affine_u8(img, _inverse_affine(m), size, border)


# ---------------------------------------------------------------------------
# Classification folder dataset
# ---------------------------------------------------------------------------


def load_classify_folder(
    root: str, size: int = 64
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Load ``root/<class>/*`` -> (images (N,size,size,3) [0,1] RGB, labels, names).
    Every file must be a PNG or a JPEG (``ValueError`` otherwise)."""
    names = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    imgs, labels = [], []
    for ci, cname in enumerate(names):
        d = os.path.join(root, cname)
        for f in sorted(os.listdir(d)):
            img = imread_bgr(os.path.join(d, f))
            h, w = img.shape[:2]
            s = size / min(h, w)
            nh, nw = max(size, round(h * s)), max(size, round(w * s))
            img = resize_u8(img, nw, nh)
            top, left = (nh - size) // 2, (nw - size) // 2
            img = img[top : top + size, left : left + size]
            imgs.append(img[..., ::-1].astype(np.float32) / 255.0)  # BGR->RGB
            labels.append(ci)
    return np.stack(imgs), np.asarray(labels, np.int32), names


def augment_classify_batch(rng: np.random.Generator, batch: np.ndarray) -> np.ndarray:
    """Random resized crop + flip + erasing + brightness/contrast jitter."""
    n, size = batch.shape[0], batch.shape[1]
    out = np.empty_like(batch)
    for i in range(n):
        img = batch[i]
        # random resized crop: area scale [0.3, 1.0], aspect [3/4, 4/3]
        for _ in range(4):
            area = rng.uniform(0.3, 1.0) * size * size
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(area * ar)))
            ch = int(round(np.sqrt(area / ar)))
            if cw <= size and ch <= size:
                x0 = rng.integers(0, size - cw + 1)
                y0 = rng.integers(0, size - ch + 1)
                img = cv_resize(img[y0 : y0 + ch, x0 : x0 + cw], (size, size), cubic=False)
                break
        if rng.random() < 0.5:
            img = img[:, ::-1]
        # light photometric jitter
        img = np.clip(img * rng.uniform(0.8, 1.2) + rng.uniform(-0.08, 0.08), 0, 1)
        # random erasing p=0.4
        if rng.random() < 0.4:
            ew = rng.integers(size // 8, size // 2)
            eh = rng.integers(size // 8, size // 2)
            x0 = rng.integers(0, size - ew + 1)
            y0 = rng.integers(0, size - eh + 1)
            img = img.copy()
            img[y0 : y0 + eh, x0 : x0 + ew] = rng.random()
        out[i] = img
    return out


# ---------------------------------------------------------------------------
# YOLO detection dataset
# ---------------------------------------------------------------------------


@dataclass
class DetectSample:
    image: np.ndarray  # HWC uint8 BGR (as decoded)
    boxes: np.ndarray  # (M, 4) xyxy pixels
    classes: np.ndarray  # (M,) int32


def load_yolo_split(
    root: str, split: str, max_side: Optional[int] = None
) -> List[DetectSample]:
    """Load a YOLO-txt split (``<root>/<split>/{images,labels}``).

    ``max_side`` pre-downscales decoded images once at load (``INTER_AREA``,
    boxes scaled accordingly). Files named ``.jpg``/``.jpeg``/``.png`` are
    read; one that is not a PNG or a JPEG raises ``ValueError``.
    """
    img_dir = os.path.join(root, split, "images")
    lbl_dir = os.path.join(root, split, "labels")
    out = []
    for f in sorted(os.listdir(img_dir)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = imread_bgr(os.path.join(img_dir, f))
        if max_side and max(img.shape[:2]) > max_side:
            scale = max_side / max(img.shape[:2])
            img = resize_area_u8(img, round(img.shape[1] * scale), round(img.shape[0] * scale))
        h, w = img.shape[:2]
        stem = os.path.splitext(f)[0]
        lbl_path = os.path.join(lbl_dir, stem + ".txt")
        boxes, classes = [], []
        if os.path.exists(lbl_path):
            with open(lbl_path) as fh:
                for line in fh:
                    parts = line.split()
                    if len(parts) < 5:
                        continue
                    c, xc, yc, bw, bh = (float(v) for v in parts[:5])
                    boxes.append([(xc - bw / 2) * w, (yc - bh / 2) * h,
                                  (xc + bw / 2) * w, (yc + bh / 2) * h])
                    classes.append(int(c))
        out.append(
            DetectSample(
                image=img,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                classes=np.asarray(classes, np.int32),
            )
        )
    return out


def _scalar(text: str):
    """A YAML plain or quoted scalar as ``yaml.safe_load`` reads a class name."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return ast.literal_eval(text)
    return text


def _flow_list(text: str, path: str) -> List[str]:
    inner = text.strip()
    if not (inner.startswith("[") and inner.endswith("]")):
        raise ValueError(f"{path}: cannot read names: {text!r}")
    items, cur, quote = [], "", None
    for ch in inner[1:-1]:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return [_scalar(i) for i in items]


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def load_yolo_names(root: str) -> Dict[int, str]:
    """Class names from ``<root>/data.yaml``: ``names`` as a flow list
    (``names: ['a', 'b']``), a block list (``- a`` lines) or an index to
    name mapping (``0: a`` lines), as ``yaml.safe_load`` reads them."""
    path = os.path.join(root, "data.yaml")
    with open(path) as f:
        lines = [_strip_comment(l) for l in f.read().splitlines()]
    for i, line in enumerate(lines):
        if not line.startswith("names:"):
            continue
        rest = line[len("names:"):].strip()
        if rest:
            return dict(enumerate(_flow_list(rest, path)))
        block = []
        for sub in lines[i + 1:]:
            if not sub.strip():
                continue
            if not sub[0].isspace() and not sub.startswith("-"):
                break
            block.append(sub.strip())
        if block and all(b.startswith("-") for b in block):
            return dict(enumerate(_scalar(b[1:]) for b in block))
        out = {}
        for b in block:
            k, sep, v = b.partition(":")
            if not sep:
                raise ValueError(f"{path}: cannot read names entry {b!r}")
            out[int(k)] = _scalar(v)
        return out
    raise ValueError(f"{path}: no 'names' entry")


def _letterbox_np(img, boxes, imgsz, pad_val=114):
    h, w = img.shape[:2]
    r = min(imgsz / h, imgsz / w)
    nh, nw = round(h * r), round(w * r)
    resized = resize_u8(img, nw, nh)
    canvas = np.full((imgsz, imgsz, 3), pad_val, img.dtype)
    top = (imgsz - nh) // 2
    left = (imgsz - nw) // 2
    canvas[top : top + nh, left : left + nw] = resized
    if len(boxes):
        boxes = boxes * r + np.array([left, top, left, top], np.float32)
    return canvas, boxes


def _hsv_jitter(rng, img, hgain=0.015, sgain=0.7, vgain=0.4):
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    return hsv_jitter_u8(img, hsv_luts(r))


def _affine(rng, img, boxes, classes, imgsz, scale=0.5, translate=0.1):
    s = rng.uniform(1 - scale, 1 + scale)
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * imgsz - imgsz * s / 2
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * imgsz - imgsz * s / 2
    M = np.array([[s, 0, tx], [0, s, ty]], np.float32)
    out = warp_affine_u8(img, M, imgsz)
    if len(boxes):
        b = boxes * s + np.array([tx, ty, tx, ty], np.float32)
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, imgsz)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, imgsz)
        keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
        boxes, classes = b[keep], classes[keep]
    return out, boxes, classes


def _mosaic(rng, samples: Sequence[DetectSample], imgsz: int):
    """4-image mosaic on a 2*imgsz canvas, then scaled back to imgsz."""
    idxs = rng.integers(0, len(samples), 4)
    big = np.full((imgsz * 2, imgsz * 2, 3), 114, np.uint8)
    cx = int(rng.uniform(imgsz * 0.5, imgsz * 1.5))
    cy = int(rng.uniform(imgsz * 0.5, imgsz * 1.5))
    all_boxes, all_classes = [], []
    quads = [(0, 0, cx, cy), (cx, 0, 2 * imgsz, cy), (0, cy, cx, 2 * imgsz), (cx, cy, 2 * imgsz, 2 * imgsz)]
    for q, i in zip(quads, idxs):
        smp = samples[int(i)]
        x1, y1, x2, y2 = q
        qw, qh = x2 - x1, y2 - y1
        if qw < 2 or qh < 2:
            continue
        h, w = smp.image.shape[:2]
        r = max(qw / w, qh / h)
        nw, nh = max(qw, int(np.ceil(w * r))), max(qh, int(np.ceil(h * r)))
        resized = resize_u8(smp.image, nw, nh)
        ox = int(rng.uniform(0, max(nw - qw, 0) + 1e-9))
        oy = int(rng.uniform(0, max(nh - qh, 0) + 1e-9))
        big[y1:y2, x1:x2] = resized[oy : oy + qh, ox : ox + qw]
        if len(smp.boxes):
            b = smp.boxes * r - np.array([ox, oy, ox, oy], np.float32)
            b += np.array([x1, y1, x1, y1], np.float32)
            b[:, [0, 2]] = b[:, [0, 2]].clip(x1, x2)
            b[:, [1, 3]] = b[:, [1, 3]].clip(y1, y2)
            keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
            all_boxes.append(b[keep])
            all_classes.append(smp.classes[keep])
    img = resize_u8(big, imgsz, imgsz)
    if all_boxes:
        boxes = np.concatenate(all_boxes) * 0.5
        classes = np.concatenate(all_classes)
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int32)
    return img, boxes, classes


def make_detect_batch(
    rng: np.random.Generator,
    samples: Sequence[DetectSample],
    batch_size: int,
    imgsz: int,
    max_boxes: int = 160,
    mosaic: bool = True,
    augment: bool = True,
    fliplr: float = 0.5,
):
    """Build one fixed-shape training batch.

    Returns (images (B,imgsz,imgsz,3) uint8 RGB,
             targets (B,max_boxes,5) [cls,x1,y1,x2,y2] canvas pixels,
             mask (B,max_boxes) bool).
    """
    B = batch_size
    # uint8 batches: 4x less host->device transfer; /255 happens on device
    imgs = np.empty((B, imgsz, imgsz, 3), np.uint8)
    tgts = np.zeros((B, max_boxes, 5), np.float32)
    mask = np.zeros((B, max_boxes), bool)
    for bi in range(B):
        if augment and mosaic:
            img, boxes, classes = _mosaic(rng, samples, imgsz)
        else:
            smp = samples[int(rng.integers(0, len(samples)))]
            img, boxes = _letterbox_np(smp.image, smp.boxes.copy(), imgsz)
            classes = smp.classes
        if augment:
            img, boxes, classes = _affine(rng, img, boxes, classes, imgsz)
            img = _hsv_jitter(rng, img)
            if rng.random() < fliplr:
                img = img[:, ::-1]
                if len(boxes):
                    boxes = boxes.copy()
                    boxes[:, [0, 2]] = imgsz - boxes[:, [2, 0]]
        imgs[bi] = img[..., ::-1]  # BGR->RGB
        n = min(len(boxes), max_boxes)
        if n:
            tgts[bi, :n, 0] = classes[:n]
            tgts[bi, :n, 1:] = boxes[:n]
            mask[bi, :n] = True
    return imgs, tgts, mask


def make_eval_batch(samples: Sequence[DetectSample], imgsz: int, max_boxes: int = 160):
    """Letterbox-only batch over ALL samples (for validation)."""
    B = len(samples)
    imgs = np.empty((B, imgsz, imgsz, 3), np.float32)
    tgts = np.zeros((B, max_boxes, 5), np.float32)
    mask = np.zeros((B, max_boxes), bool)
    metas = []
    for bi, smp in enumerate(samples):
        img, boxes = _letterbox_np(smp.image, smp.boxes.copy(), imgsz)
        imgs[bi] = img[..., ::-1].astype(np.float32) / 255.0
        n = min(len(boxes), max_boxes)
        if n:
            tgts[bi, :n, 0] = smp.classes[:n]
            tgts[bi, :n, 1:] = boxes[:n]
            mask[bi, :n] = True
        metas.append(smp)
    return imgs, tgts, mask, metas
