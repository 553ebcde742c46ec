"""Image ops of the OCR preprocessing, as stock torch ops on (N, H, W) batches.

Counterpart of ``manual_yolo_tpu/ops/image.py``, which writes each op for one
(H, W) image and lets ``vmap`` batch it; here every op takes a batch of gray
images in [0, 1] and runs on the batch's device. Histogram ops (CLAHE, Otsu)
quantise to 256 bins exactly as the JAX package does: ``(x * 255)`` in f32,
truncated to int32.

Otsu's class statistics are cumulative sums of integer bin counts, exact on
any device, so the card and the CPU pick the same threshold bin.

Also here: ``cv_resize``, a numpy resize equal to ``cv2.resize`` on f32
images (INTER_CUBIC and INTER_LINEAR), for the recognizer's host
preprocessing and the CRAFT canvas; the card's host has no OpenCV.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

BINS = 256


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (...) luma, matching cv2's BGR2GRAY coefficients."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> int64 bin 0..255, truncating as the JAX package's astype(int32)."""
    return (x * (BINS - 1)).to(torch.int32).clamp(0, BINS - 1).long()


def _bincount(q: torch.Tensor) -> torch.Tensor:
    """(..., P) bins -> (..., 256) f32 counts (exact integers)."""
    out = torch.zeros(q.shape[:-1] + (BINS,), dtype=torch.float32, device=q.device)
    return out.scatter_add_(-1, q, torch.ones(q.shape, dtype=torch.float32, device=q.device))


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,) Otsu's threshold value in [0, 1] (cv2.THRESH_OTSU)."""
    n = gray.shape[0]
    counts = torch.zeros((n, BINS), dtype=torch.int64, device=gray.device)
    counts.scatter_add_(1, _quantize(gray).reshape(n, -1),
                        torch.ones((n, gray[0].numel()), dtype=torch.int64, device=gray.device))
    levels = torch.arange(BINS, dtype=torch.int64, device=gray.device)
    total = counts.sum(dim=1, keepdim=True).clamp(min=1).float()
    omega = counts.cumsum(dim=1).float() / total
    mu = (counts * levels).cumsum(dim=1).float() / total
    mu_t = mu[:, -1:]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-9, (mu_t * omega - mu) ** 2 / denom.clamp(min=1e-9), 0.0)
    return torch.argmax(sigma_b, dim=1).float() / (BINS - 1)


def otsu_binarize(gray: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    t = otsu_threshold(gray)[:, None, None]
    out = (gray > t).to(gray.dtype)
    return 1.0 - out if inverse else out


_CV2_FIXED_KERNELS = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> torch.Tensor:
    if sigma <= 0:
        # cv2.getGaussianKernel's fixed kernels for small sizes when sigma <= 0
        if ksize in _CV2_FIXED_KERNELS:
            return torch.tensor(_CV2_FIXED_KERNELS[ksize], dtype=torch.float32)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # cv2 default rule
    x = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2
    k = torch.exp(-(x**2) / (2 * sigma**2))
    return k / torch.sum(k)


def _sep_conv(gray: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 2D filter on (N, H, W) with edge replication."""
    k = k1d.shape[0]
    pad = k // 2
    w = k1d.to(gray.device, torch.float32)
    x = F.pad(gray[:, None], (pad, pad, pad, pad), mode="replicate")
    y = F.conv2d(x, w.reshape(1, 1, k, 1))
    y = F.conv2d(y, w.reshape(1, 1, 1, k))
    return y[:, 0]


def gaussian_blur(gray: torch.Tensor, ksize: int = 3, sigma: float = 0.0) -> torch.Tensor:
    return _sep_conv(gray, gaussian_kernel1d(ksize, sigma))


def sharpen(gray: torch.Tensor) -> torch.Tensor:
    """The 3x3 sharpen kernel [[-1..],[-1,9,-1],[-1..]], clipped to [0, 1]."""
    k = torch.tensor([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], dtype=torch.float32,
                     device=gray.device)
    x = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")
    return torch.clamp(F.conv2d(x, k.reshape(1, 1, 3, 3))[:, 0], 0.0, 1.0)


def adaptive_threshold_gaussian(
    gray: torch.Tensor, block: int = 11, c: float = 2.0 / 255.0
) -> torch.Tensor:
    """cv2.adaptiveThreshold(GAUSSIAN_C, BINARY, block, C) equivalent."""
    local = _sep_conv(gray, gaussian_kernel1d(block))
    return (gray > local - c).to(gray.dtype)


def _window_max(gray: torch.Tensor, k: int, pad_value: float) -> torch.Tensor:
    lo, hi = k // 2, (k - 1) // 2  # asymmetric for even kernels (cv2 anchor)
    x = F.pad(gray[:, None], (lo, hi, lo, hi), value=pad_value)
    return F.max_pool2d(x, k, stride=1)[:, 0]


def erode(gray: torch.Tensor, k: int = 2) -> torch.Tensor:
    # cv2 erode border default acts as +inf: borders never erode inward
    return -_window_max(-gray, k, -1.0)


def dilate(gray: torch.Tensor, k: int = 2) -> torch.Tensor:
    return _window_max(gray, k, 0.0)


def morph_open(gray: torch.Tensor, k: int = 2) -> torch.Tensor:
    return dilate(erode(gray, k), k)


def morph_close(gray: torch.Tensor, k: int = 2) -> torch.Tensor:
    return erode(dilate(gray, k), k)


def clahe(
    gray: torch.Tensor,
    clip_limit: float = 3.0,
    tiles: Tuple[int, int] = (8, 8),
) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation (cv2.createCLAHE) of
    (N, H, W): per-tile clipped-histogram CDF mappings, bilinear between
    tile centers."""
    n, H, W = gray.shape
    ty, tx = tiles
    th, tw = -(-H // ty), -(-W // tx)  # ceil tile size
    dev = gray.device
    padded = F.pad(gray[:, None], (0, tx * tw - W, 0, ty * th - H), mode="replicate")[:, 0]
    q = _quantize(padded)
    tiles_q = q.reshape(n, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(n, ty * tx, th * tw)
    hists = _bincount(tiles_q)  # (N, T, BINS)

    # clip histogram and redistribute excess uniformly (OpenCV semantics)
    npix = th * tw
    limit = max(clip_limit * npix / BINS, 1.0)
    clipped = torch.clamp(hists, max=limit)
    excess = torch.sum(hists - clipped, dim=-1, keepdim=True)
    clipped = clipped + excess / BINS
    cdf = torch.cumsum(clipped, dim=-1)
    cdf_min = cdf[..., :1]
    denom = torch.clamp(npix - cdf_min, min=1.0)
    mapping = torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0).reshape(n, ty, tx, BINS)

    # bilinear interpolation between the 4 surrounding tile mappings
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - th / 2 + 0.5) / th
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - tw / 2 + 0.5) / tw
    y0 = torch.clamp(torch.floor(ys), 0, ty - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, tx - 1).long()
    y1 = torch.clamp(y0 + 1, 0, ty - 1)
    x1 = torch.clamp(x0 + 1, 0, tx - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]

    qq = _quantize(gray)
    b = torch.arange(n, device=dev)[:, None, None]
    m00 = mapping[b, y0[None, :, None], x0[None, None, :], qq]
    m01 = mapping[b, y0[None, :, None], x1[None, None, :], qq]
    m10 = mapping[b, y1[None, :, None], x0[None, None, :], qq]
    m11 = mapping[b, y1[None, :, None], x1[None, None, :], qq]
    top = m00 * (1 - fx) + m01 * fx
    bot = m10 * (1 - fx) + m11 * fx
    return top * (1 - fy) + bot * fy


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of ``jax.image.resize(..., "bilinear")`` on one
    axis: a triangle kernel at half-pixel centers, widened by the scale when
    shrinking (antialias), taps outside the input dropped and the rest
    renormalised."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix for one axis of cv2.INTER_CUBIC:
    Keys bicubic kernel with a = -0.75, half-pixel-centered source
    coordinates, replicate-clamped borders."""
    a = -0.75
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    ix = np.floor(x).astype(np.int64)
    f = x - ix  # in [0, 1)
    t = np.stack([1.0 + f, f, 1.0 - f, 2.0 - f])  # |distance| per tap
    w = np.where(
        t <= 1.0,
        ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a,
    )  # (4, n_out); rows already sum to 1
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for k in range(4):
        cols = np.clip(ix + (k - 1), 0, n_in - 1)
        np.add.at(mat, (np.arange(n_out), cols), w[k])
    return mat.astype(np.float32)


def _cv_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of one axis of cv2.INTER_LINEAR: half-pixel
    centres, no antialias at any scale, the source index clamped at 0 and
    at the last pixel."""
    x = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    ix = np.floor(x).astype(np.int64)
    f = x - ix.astype(np.float32)
    f = np.where((ix < 0) | (ix >= n_in - 1), np.float32(0.0), f)
    ix = np.clip(ix, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(mat, (rows, ix), np.float32(1.0) - f)
    np.add.at(mat, (rows, np.minimum(ix + 1, n_in - 1)), f)
    return mat


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W) -> (N, out_h, out_w), as ``jax.image.resize(..., "bilinear")``."""
    wy = torch.from_numpy(_linear_resize_matrix(img.shape[-2], out_hw[0])).to(img.device)
    wx = torch.from_numpy(_linear_resize_matrix(img.shape[-1], out_hw[1])).to(img.device)
    return wy @ img @ wx.T


def resize_cubic(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W) -> (N, out_h, out_w), cv2.resize(..., INTER_CUBIC) parity:
    out = Wy @ img @ Wx.T, no range clamp."""
    wy = torch.from_numpy(_cubic_resize_matrix(img.shape[-2], out_hw[0])).to(img.device)
    wx = torch.from_numpy(_cubic_resize_matrix(img.shape[-1], out_hw[1])).to(img.device)
    return wy @ img @ wx.T


def cv_resize(img: np.ndarray, out_hw: Tuple[int, int], cubic: bool) -> np.ndarray:
    """Host ``cv2.resize(img, (out_w, out_h), interpolation=INTER_CUBIC if
    cubic else INTER_LINEAR)`` for f32 (H, W) or (H, W, C) images."""
    h, w = img.shape[:2]
    mat = _cubic_resize_matrix if cubic else _cv_linear_matrix
    wy, wx = mat(h, out_hw[0]), mat(w, out_hw[1])
    x = np.asarray(img, np.float32)
    if x.ndim == 2:
        return wy @ x @ wx.T
    return np.einsum("oh,hwc->owc", wy, np.einsum("pw,hwc->hpc", wx, x))


RESIZE_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS: coefficients in units of 1/2048


def _cv_linear_fixed(n_in: int, n_out: int):
    """One axis of cv2's fixed-point INTER_LINEAR: (index of the first source
    pixel, its weight, the next pixel's weight), weights in 1/2048. The
    position is f32 of an f64 product, the weights are rounded half to
    even, as cv2 computes them."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    edge = (i < 0) | (i >= n_in - 1)
    f = np.where(edge, np.float32(0.0), f)
    i = np.clip(i, 0, n_in - 1)
    one = np.float32(1 << RESIZE_COEF_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return i, w0, w1


def cv_resize_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host ``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)``
    for uint8 (H, W) or (H, W, C) images, bit for bit.

    cv2's 8-bit path is fixed point: a horizontal pass of integer sums with
    11-bit weights, then a vertical pass that keeps 12 bits of each row sum,
    multiplies by the 11-bit row weight, drops 16 bits, and rounds the last
    2 away (``VResizeLinear``'s uint8 specialisation). Source rows are
    clamped at the edges; edge columns take one pixel at full weight."""
    x = np.asarray(img)
    if x.dtype != np.uint8:
        raise TypeError(f"cv_resize_u8 takes uint8 images, got {x.dtype}")
    h, w = x.shape[:2]
    out_h, out_w = out_hw
    if (out_h, out_w) == (h, w):
        return x.copy()
    xi, xw0, xw1 = _cv_linear_fixed(w, out_w)
    xj = np.minimum(xi + 1, w - 1)
    shape = (1, out_w) + (1,) * (x.ndim - 2)
    s = x.astype(np.int64)
    rows = s[:, xi] * xw0.reshape(shape) + s[:, xj] * xw1.reshape(shape)
    scale = 1.0 / (out_h / h)
    fy = ((np.arange(out_h, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    yi = np.floor(fy).astype(np.int64)
    fy = fy - yi.astype(np.float32)
    one = np.float32(1 << RESIZE_COEF_BITS)
    yw0 = np.rint((np.float32(1.0) - fy) * one).astype(np.int64)
    yw1 = np.rint(fy * one).astype(np.int64)
    r0 = rows[np.clip(yi, 0, h - 1)] >> 4
    r1 = rows[np.clip(yi + 1, 0, h - 1)] >> 4
    shape = (out_h,) + (1,) * (x.ndim - 1)
    out = (((yw0.reshape(shape) * r0) >> 16) + ((yw1.reshape(shape) * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def enhance_for_ocr_standard(gray: torch.Tensor) -> torch.Tensor:
    """'standard' enhancement: CLAHE clip=2."""
    return clahe(gray, clip_limit=2.0)


def enhance_for_ocr_card(gray: torch.Tensor, upscale: int = 3) -> torch.Tensor:
    """'card_rank' enhancement chain: 3x cubic upscale -> CLAHE(3) -> blur ->
    sharpen -> adaptive threshold -> morph close."""
    h, w = gray.shape[-2:]
    up = torch.clamp(resize_cubic(gray, (h * upscale, w * upscale)), 0.0, 1.0)
    x = clahe(up, clip_limit=3.0)
    x = gaussian_blur(x, 3)
    x = sharpen(x)
    x = adaptive_threshold_gaussian(x, 11)
    return morph_close(x, 2)


def estimate_skew_angle(gray: torch.Tensor, max_deg: float = 15.0) -> torch.Tensor:
    """(N, H, W) -> (N,) text-line skew (radians) from the second moments of
    the ink mask, clamped to +-``max_deg``; near-empty masks give 0.

    The moments are summed in f64, so the f32 angle is the same on every
    device: ``deskew`` feeds CLAHE, whose 256-bin quantisation turns a
    last-bit difference in the rotated pixels into a different histogram."""
    thr = otsu_threshold(gray)[:, None, None]
    # ink = darker-than-threshold by default; pick the minority side so
    # light-on-dark UIs work too
    dark = (gray < thr).double()
    mask = torch.where(dark.mean(dim=(1, 2), keepdim=True) <= 0.5, dark, 1.0 - dark)
    h, w = gray.shape[-2:]
    ys = torch.arange(h, dtype=torch.float64, device=gray.device)[:, None]
    xs = torch.arange(w, dtype=torch.float64, device=gray.device)[None, :]
    m = mask.sum(dim=(1, 2)) + 1e-6
    cy = (mask * ys).sum(dim=(1, 2)) / m
    cx = (mask * xs).sum(dim=(1, 2)) / m
    dx, dy = xs - cx[:, None, None], ys - cy[:, None, None]
    mu20 = (mask * dx**2).sum(dim=(1, 2)) / m
    mu02 = (mask * dy**2).sum(dim=(1, 2)) / m
    mu11 = (mask * dx * dy).sum(dim=(1, 2)) / m
    ang = 0.5 * torch.atan2(2.0 * mu11, mu20 - mu02 + 1e-9)
    lim = math.radians(max_deg)
    ang = torch.clamp(ang, -lim, lim).float()
    # too little ink -> unreliable estimate -> no-op
    return torch.where(m > 8.0, ang, 0.0)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c in f32, rounded once (a fused multiply-add, computed in f64)."""
    return (a.double() * b.double() + c).float()


def rotate_bilinear(gray: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W) image of the batch by ``angle[n]`` radians about its
    center (bilinear, edge-clamped).

    The rotation feeds CLAHE's 256-bin quantisation, which turns a last-bit
    difference into another histogram, so its rounding is pinned: the cosine
    and sine are taken in f64 and rounded to f32, and the coordinates and the
    interpolation round where the JAX package's compiled CPU program does (a
    fused multiply-add for the first product of each sum). The same bits come
    out on every device."""
    n, h, w = gray.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=gray.device)[:, None] - cy
    xs = torch.arange(w, dtype=torch.float32, device=gray.device)[None, :] - cx
    a = angle.double()[:, None, None]
    c, s = torch.cos(a).float(), torch.sin(a).float()
    sx = torch.clamp(_fma(c, xs, cx) - s * ys, 0.0, w - 1.0)
    sy = torch.clamp(_fma(s, xs, cy) + c * ys, 0.0, h - 1.0)
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = sx - x0
    fy = sy - y0
    flat = gray.float().reshape(n, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(n, -1)).reshape(n, h, w)

    top = _fma(at(y0, x0), 1 - fx, at(y0, x1) * fx)
    bot = _fma(at(y1, x0), 1 - fx, at(y1, x1) * fx)
    return _fma(top, 1 - fy, bot * fy)


def deskew(gray: torch.Tensor, max_deg: float = 15.0) -> torch.Tensor:
    """Moment-based deskew: estimate each image's skew and rotate it out
    (``rotate_bilinear`` inverse-maps, so the estimated angle itself is the
    corrective rotation)."""
    return rotate_bilinear(gray, estimate_skew_angle(gray, max_deg))
