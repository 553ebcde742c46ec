"""CRAFT text detector (region/affinity heatmaps) as a PyTorch module.

Counterpart of ``manual_yolo_tpu/models/craft.py`` (inference only): a
VGG16-BN feature extractor, a dilated stride-32 extension, U-Net merges with
the stride 16, 8, 4 and 2 features, and a 2-channel head (region, affinity)
at stride 2.

  * BN is applied unfolded with eps 1e-5 (torchvision's, not the detector's
    1e-3): ``(y - mean) * (gamma / sqrt(var + eps)) + beta``, as the JAX
    package computes it;
  * the input side must be a multiple of 32, so that every upsampling is an
    exact 2x; there ``jax.image.resize``'s bilinear equals
    ``F.interpolate(mode="bilinear", align_corners=False)``, edges included;
  * ``text_regions_from_scores`` labels 4-connected components in numpy,
    numbered in raster order of their first pixel as
    ``cv2.connectedComponents`` numbers them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manual_yolo_tpu_torch.core.device import full_f32
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.core.weights import conv_hwio_to_oihw

BN_EPS = 1e-5  # torchvision VGG BN default

# VGG16-BN conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]


class ConvBN(nn.Module):
    """Conv (no bias) + unfolded BN, or conv + bias when ``bn`` is False."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, bn: bool = True):
        super().__init__()
        pad = ((k - 1) * dilation) // 2
        self.conv = nn.Conv2d(cin, cout, k, padding=pad, dilation=dilation, bias=not bn)
        self.bn = bn
        if bn:
            for name in ("gamma", "beta", "mean", "var"):
                self.register_buffer(name, torch.zeros(cout))

    def forward(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        y = self.conv(x)
        if self.bn:
            scale = self.gamma * torch.rsqrt(self.var + BN_EPS)
            y = (y - self.mean[:, None, None]) * scale[:, None, None] + self.beta[:, None, None]
        return F.relu(y) if act else y


class UpConv(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int):
        super().__init__()
        self.c1 = ConvBN(cin, cmid, 1)
        self.c2 = ConvBN(cmid, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class CRAFT(nn.Module):
    def __init__(self):
        super().__init__()
        vgg, cin = [], 3
        for cout, _ in _VGG_PLAN:
            vgg.append(ConvBN(cin, cout, 3))
            cin = cout
        self.vgg = nn.ModuleList(vgg)
        self.ext = nn.ModuleList([ConvBN(512, 1024, 3, dilation=6), ConvBN(1024, 1024, 1)])
        self.ups = nn.ModuleList([
            UpConv(1024 + 512, 512, 256),
            UpConv(256 + 512, 256, 128),
            UpConv(128 + 256, 128, 64),
            UpConv(64 + 128, 64, 32),
        ])
        self.head = nn.ModuleList([
            ConvBN(32, 32, 3), ConvBN(32, 32, 3), ConvBN(32, 16, 3), ConvBN(16, 16, 1),
            ConvBN(16, 2, 1, bn=False),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) RGB [0, 1], H and W multiples of 32 ->
        (N, H/2, W/2, 2) raw region/affinity scores, f32."""
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"CRAFT input sides must be multiples of 32, got {tuple(x.shape[1:3])}")
        with full_f32():
            feats: List[torch.Tensor] = []
            y = x.permute(0, 3, 1, 2)
            for conv, (_, pool) in zip(self.vgg, _VGG_PLAN):
                if pool:
                    feats.append(y)
                    y = F.max_pool2d(y, 2)
                y = conv(y)
            feats.append(y)  # stride 16
            y = self.ext[1](self.ext[0](F.max_pool2d(y, 2)))  # stride 32
            # U-Net merges with the stride 16, 8, 4, 2 features
            for up, skip in zip(self.ups, feats[::-1]):
                y = F.interpolate(y, size=skip.shape[2:], mode="bilinear", align_corners=False)
                y = up(torch.cat([y, skip], dim=1))
            for i, conv in enumerate(self.head):
                y = conv(y, act=i < len(self.head) - 1)
            return y.permute(0, 2, 3, 1)


def from_jax_params(params: Dict, device="cpu") -> CRAFT:
    """Build CRAFT from the JAX package's parameter tree (numpy leaves)."""
    model = CRAFT()
    state = {}

    def put(path: str, p: Dict):
        state[f"{path}.conv.weight"] = torch.from_numpy(
            np.array(conv_hwio_to_oihw(np.asarray(p["w"])), np.float32, order="C"))
        if "bn" in p:
            for k in ("gamma", "beta", "mean", "var"):
                state[f"{path}.{k}"] = torch.from_numpy(np.asarray(p["bn"][k], np.float32))
        else:
            state[f"{path}.conv.bias"] = torch.from_numpy(np.asarray(p["b"], np.float32))

    for i, p in enumerate(params["vgg"]):
        put(f"vgg.{i}", p)
    for i, p in enumerate(params["ext"]):
        put(f"ext.{i}", p)
    for i, up in enumerate(params["ups"]):
        put(f"ups.{i}.c1", up["c1"])
        put(f"ups.{i}.c2", up["c2"])
    for i, p in enumerate(params["head"]):
        put(f"head.{i}", p)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def load_npz(path: str, device="cpu") -> CRAFT:
    """Load CRAFT from the native npz checkpoint format."""
    params, _meta = load_params(path)
    return from_jax_params(params, device)


def connected_components(binary: np.ndarray) -> Tuple[int, np.ndarray]:
    """4-connected labelling of a 2-D 0/1 map: (count including background 0,
    int32 labels). Components are numbered 1.. in raster order of their first
    pixel, as ``cv2.connectedComponents(binary, connectivity=4)`` does.

    Works on horizontal runs: a run joins every run of the row above that it
    overlaps in a column, through union-find with the smaller id as root."""
    h, w = binary.shape
    runs: List[Tuple[int, int, int]] = []  # (row, start, end) in raster order
    row_runs: List[List[int]] = []  # run ids per row
    for y in range(h):
        d = np.diff(np.concatenate(([0], (binary[y] != 0).astype(np.int8), [0])))
        starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
        ids = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            ids.append(len(runs))
            runs.append((y, s, e))
        row_runs.append(ids)
    parent = list(range(len(runs)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for y in range(1, h):
        above = row_runs[y - 1]
        for r in row_runs[y]:
            _, s, e = runs[r]
            for a in above:
                _, sa, ea = runs[a]
                if sa < e and s < ea:  # share a column
                    ra, rb = find(a), find(r)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
    labels = np.zeros((h, w), np.int32)
    label_of: Dict[int, int] = {}
    for r, (y, s, e) in enumerate(runs):  # roots are first in raster order
        labels[y, s:e] = label_of.setdefault(find(r), len(label_of) + 1)
    return len(label_of) + 1, labels


def _split_line_bands(
    prof: np.ndarray, low: float, prominence: float = 0.08, min_rows: int = 2
) -> List[Tuple[int, int]]:
    """1-D watershed over a component's row profile -> per-text-line bands:
    a cut at the minimum between consecutive local maxima, where it dips
    ``prominence`` below both peaks."""
    n = len(prof)
    p = prof
    if n >= 3:
        p = np.convolve(prof, [0.25, 0.5, 0.25], mode="same")
    peaks = [
        i for i in range(n)
        if p[i] > low
        and (i == 0 or p[i] >= p[i - 1])
        and (i == n - 1 or p[i] > p[i + 1])
    ]
    cuts: List[int] = []
    last = -1
    for pk in peaks:
        if last < 0:
            last = pk
            continue
        seg = p[last:pk + 1]
        vi = last + int(seg.argmin())
        if seg.min() <= min(p[last], p[pk]) - prominence:
            cuts.append(vi)
            last = pk
        elif p[pk] > p[last]:
            last = pk  # same band, keep the taller peak as its anchor
    edges = [0] + cuts + [n]
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b - a >= min_rows]


def text_regions_from_scores(
    scores: np.ndarray,
    text_threshold: float = 0.7,
    link_threshold: float = 0.4,
    low_text: float = 0.4,
    split_lines: bool = True,
) -> List[Tuple[int, int, int, int]]:
    """Host postprocess: (h, w, 2) region+affinity heatmaps -> text-line boxes
    (x1, y1, x2, y2) in image pixels (heatmap coordinates * 2). Components
    whose region row profile is multimodal are split into one box per line."""
    region = scores[..., 0]
    link = scores[..., 1]
    binary = ((region > low_text) | (link > link_threshold)).astype(np.uint8)
    n, labels = connected_components(binary)
    out = []
    for comp in range(1, n):
        mask = labels == comp
        if region[mask].max() < text_threshold:
            continue
        ys, xs = np.nonzero(mask)
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        whole = (int(xs.min()) * 2, y0 * 2, (int(xs.max()) + 1) * 2, y1 * 2)
        sub = np.where(mask[y0:y1], region[y0:y1], 0.0)
        bands = _split_line_bands(sub.max(axis=1), low_text) if split_lines else []
        if len(bands) < 2:
            out.append(whole)
            continue
        for a, b in bands:
            if sub[a:b].max() < text_threshold:
                continue
            sy, sx = np.nonzero(mask[y0 + a:y0 + b])
            if sy.size == 0:
                continue
            out.append((int(sx.min()) * 2, (y0 + a + int(sy.min())) * 2,
                        (int(sx.max()) + 1) * 2, (y0 + a + int(sy.max()) + 1) * 2))
    return out
