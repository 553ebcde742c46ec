"""Parallel detector train steps over a ``Mesh`` (``parallel/mesh.py``).

Counterpart of ``manual_yolo_tpu/parallel/trainer.py``, with its contract:
a sharded step computes the single-device step on the global batch. JAX
gets there from sharding annotations (GSPMD inserts the collectives); here
each rank runs the step body of ``train/detector.py`` (train-mode forward,
``train/loss.py``, the caller's optimizer, the EMA) on its shard, with the
collectives written out:

  * **data** (``make_dp_train_step``): the batch is split over the data
    ranks. BN's batch statistics are global: the mean, then the mean
    squared deviation, are summed over the ranks with an all-reduce whose
    backward all-reduces the gradient (over one rank the module's own BN
    runs: the step is then ``detect_step``'s, bit for bit). The loss
    normaliser (the target-score sum) is summed over the ranks too, so the
    ranks' losses add up to the global loss and the gradients are
    **summed** (not averaged).
  * **data x spatial** (``spatial_axis``): each rank also holds a band of
    every feature map's rows. Convs and SPPF's max pools read their halo
    rows from the ranks that own them (zeros beyond the image for a conv,
    -inf for a pool); the exchange gathers each rank's edge rows, as many
    as the widest halo needs and up to its whole band, so a halo wider than
    a band (SPPF's 2 rows on a 1-row P5) reaches past the neighbour. Its
    backward sends each halo row's gradient to the rank that owns the row.
    The head's outputs are gathered over the rows before the loss (the task
    aligned assignment sees all of an image's anchors).
  * **data x model** (``make_tp_train_step``): every conv whose out-channel
    count divides over the model ranks and is at least 16 (JAX's
    ``channel_shardings`` rule) keeps only its slice of the out-channels:
    its OIHW kernel's dim 0, its BN vectors and statistics, and with them
    the AdamW moments and the EMA copy. Its output is all-gathered over the
    channels before the next layer; the gather's backward sums over the
    ranks and keeps this rank's slice (a reduce-scatter).

A loss replicated over the model or spatial ranks is back-propagated
divided by their count, so that every replicated activation holds a part of
its gradient on each rank and the parts sum to the whole: the gathers'
backward sums them, and the gradients of replicated parameters are summed
over every rank, those of channel-sharded ones over the data ranks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from manual_yolo_tpu_torch.core.device import precision_for
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.parallel.mesh import Mesh
from manual_yolo_tpu_torch.train.ema import ema_tensors, ema_update
from manual_yolo_tpu_torch.train.loss import detection_loss
from manual_yolo_tpu_torch.train.optim import clip_by_global_norm

MIN_CHANNEL = 16  # JAX's channel_shardings: narrower trailing dims stay replicated


# --- collectives with gradients -----------------------------------------------


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


class _Gather(torch.autograd.Function):
    """Concatenate the ranks' ``x`` along ``dim`` in rank order; the backward
    sums the gradient over the ranks and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        ctx.rank, ctx.n = dist.get_rank(group), n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


class _Halo(torch.autograd.Function):
    """(N, C, h, W) band of rows -> (N, C, top + h + bottom, W): ``top`` rows
    from the ranks above and ``bottom`` from the ranks below, ``fill``
    beyond the image. Every rank's first ``bottom`` and last ``top`` rows
    (at most its band) are all-gathered; the backward all-reduces the
    gradients of those edge rows and adds this rank's own back."""

    @staticmethod
    def forward(ctx, x, top, bottom, fill, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        h = x.shape[2]
        et, eb = min(bottom, h), min(top, h)  # rows each rank sends up / down
        ctx.group, ctx.shape, ctx.r, ctx.n, ctx.e = group, x.shape, r, n, (et, eb)
        ctx.top, ctx.bottom = top, bottom
        piece = torch.cat([x[:, :, :et], x[:, :, h - eb:]], dim=2).contiguous()
        pieces = [torch.empty_like(piece) for _ in range(n)]
        dist.all_gather(pieces, piece, group=group)
        above = [_band_row(pieces, g, h, et, eb, x, fill) for g in range(r * h - top, r * h)]
        below = [_band_row(pieces, g, h, et, eb, x, fill) for g in range((r + 1) * h, (r + 1) * h + bottom)]
        return torch.cat(above + [x] + below, dim=2)

    @staticmethod
    def backward(ctx, g):
        n, r, (et, eb) = ctx.n, ctx.r, ctx.e
        h = ctx.shape[2]
        g = g.contiguous()
        gx = g[:, :, ctx.top:ctx.top + h].clone()
        buf = g.new_zeros((n,) + tuple(ctx.shape[:2]) + (et + eb, ctx.shape[3]))
        rows = list(range(r * h - ctx.top, r * h)) + list(range((r + 1) * h, (r + 1) * h + ctx.bottom))
        taken = list(range(ctx.top)) + list(range(ctx.top + h, ctx.top + h + ctx.bottom))
        for gi, k in zip(rows, taken):
            owner, loc = divmod(gi, h)
            if not 0 <= owner < n:
                continue  # fill rows take no gradient
            buf[owner, :, :, _piece_row(loc, h, et, eb)] += g[:, :, k]
        dist.all_reduce(buf, group=ctx.group)
        own = buf[r]
        gx[:, :, :et] += own[:, :, :et]
        gx[:, :, h - eb:] += own[:, :, et:]
        return gx, None, None, None, None


def _piece_row(loc: int, h: int, et: int, eb: int) -> int:
    """Where row ``loc`` of a band sits in its rank's sent piece."""
    if loc >= h - eb:
        return et + loc - (h - eb)
    if loc < et:
        return loc
    raise AssertionError(f"row {loc} of a band of {h} is not an edge row ({et}, {eb})")


def _band_row(pieces, gi: int, h: int, et: int, eb: int, x, fill):
    owner, loc = divmod(gi, h)
    if not 0 <= owner < len(pieces):
        return x.new_full(x.shape[:2] + (1,) + x.shape[3:], fill)
    k = _piece_row(loc, h, et, eb)
    return pieces[owner][:, :, k:k + 1]


def halo(x: torch.Tensor, top: int, bottom: int, fill: float, group) -> torch.Tensor:
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, fill, group)


# --- the parallel forward -----------------------------------------------------


@dataclass
class Layout:
    """Which collectives a rank's forward and step run."""

    mesh: Mesh
    data_axis: str = "data"
    spatial_axis: Optional[str] = None
    model_axis: Optional[str] = None
    n_spatial: int = 1
    n_model: int = 1
    stats_ranks: int = 1
    groups: Dict[str, object] = field(default_factory=dict)

    @classmethod
    def of(cls, mesh: Mesh, data_axis="data", spatial_axis=None, model_axis=None) -> "Layout":
        lay = cls(mesh, data_axis, spatial_axis, model_axis,
                  mesh.shape[spatial_axis] if spatial_axis else 1,
                  mesh.shape[model_axis] if model_axis else 1)
        stats = (data_axis, spatial_axis) if spatial_axis else (data_axis,)
        lay.groups = {
            "data": mesh.group(data_axis),
            "stats": mesh.group(*stats),  # BN batch statistics
            "all": mesh.group(*mesh.axes),
            "spatial": mesh.group(spatial_axis) if spatial_axis else None,
            "model": mesh.group(model_axis) if model_axis else None,
        }
        lay.stats_ranks = dist.get_world_size(lay.groups["stats"])
        return lay


def _group_bn(y: torch.Tensor, bn: nn.BatchNorm2d, group) -> torch.Tensor:
    """Train-mode BN of (N, C, h, w) f32 on statistics over every rank of
    ``group``: the mean, then the biased variance as the mean squared
    deviation (two reductions, as ``nn.BatchNorm2d`` computes them); the
    running statistics move as the module moves them (momentum, unbiased
    variance) with the global count."""
    count = torch.tensor([y.numel() // y.shape[1]], dtype=y.dtype, device=y.device)
    dist.all_reduce(count, group=group)
    n = float(count)
    mean = all_reduce(y.sum(dim=(0, 2, 3)), group) / n
    d = y - mean[None, :, None, None]
    var = all_reduce((d * d).sum(dim=(0, 2, 3)), group) / n
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps)
    return d * (inv * bn.weight)[None, :, None, None] + bn.bias[None, :, None, None]


def _conv(blk, x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """``TrainConvBlock.forward`` on this rank's rows and out-channels."""
    c = blk.conv
    k, s = c.kernel_size[0], c.stride[0]
    p = k // 2
    pad_h = p
    if lay.spatial_axis:
        x = halo(x, p, k - p - s, 0.0, lay.groups["spatial"])
        pad_h = 0
    y = F.conv2d(x.to(blk.compute_dtype), c.weight.to(blk.compute_dtype), None, c.stride,
                 (pad_h, p))
    if blk.bn is not None and lay.stats_ranks > 1:
        y = _group_bn(y.float(), blk.bn, lay.groups["stats"])
    elif blk.bn is not None:  # one rank's statistics are the global ones
        y = blk.normalize(y.float())
    else:
        y = y + (blk.bias.to(y.dtype) if blk.act else blk.bias)[:, None, None]
    y = F.silu(y) if blk.act else y
    if getattr(blk, "tp_sharded", False):
        y = gather(y, 1, lay.groups["model"])
    return y


def _pool(v: torch.Tensor, k: int, lay: Layout) -> torch.Tensor:
    if lay.spatial_axis:
        v = halo(v, k // 2, k // 2, float("-inf"), lay.groups["spatial"])
        return F.max_pool2d(v, k, 1, (0, k // 2))
    return F.max_pool2d(v, k, 1, k // 2)


def _c2f(mod, x, lay):
    y = _conv(mod.cv1, x, lay)
    parts = list(y.chunk(2, dim=1))
    for b in mod.m:
        z = _conv(b.cv2, _conv(b.cv1, parts[-1], lay), lay)
        parts.append(parts[-1] + z if b.shortcut else z)
    return _conv(mod.cv2, torch.cat(parts, dim=1), lay)


def _sppf(mod, x, lay):
    y = _conv(mod.cv1, x, lay)
    p1 = _pool(y, mod.k, lay)
    p2 = _pool(p1, mod.k, lay)
    p3 = _pool(p2, mod.k, lay)
    return _conv(mod.cv2, torch.cat([y, p1, p2, p3], dim=1), lay)


class ParallelDetect:
    """``YOLOv8Detect.forward`` of a train model on this rank's shard: (N,
    h, W, 3) rows -> per level (box_dist, cls_logit) NHWC over all rows."""

    def __init__(self, model: yolov8.YOLOv8Detect, lay: Layout):
        self.model, self.lay = model, lay
        self.spec, self.compute_dtype = model.spec, model.compute_dtype

    def __call__(self, images: torch.Tensor):
        spec, lay = self.spec, self.lay
        feats: List[torch.Tensor] = []
        y = images.permute(0, 3, 1, 2)
        with self.model._precision():
            for layer, mod in zip(spec.layers, self.model.layers):
                if layer.kind == "conv":
                    y = _conv(mod, y, lay)
                elif layer.kind == "c2f":
                    y = _c2f(mod, y, lay)
                elif layer.kind == "sppf":
                    y = _sppf(mod, y, lay)
                elif layer.kind == "upsample":
                    y = F.interpolate(y, scale_factor=2, mode="nearest")
                elif layer.kind == "concat":
                    y = torch.cat([y, feats[layer.src[1]]], dim=1)
                else:
                    break
                feats.append(y)
            det = self.model.layers[-1]
            out = []
            for b, c, f in zip(det.box, det.cls, [feats[s] for s in spec.layers[-1].src]):
                for branch in (b, c):
                    v = f
                    for blk in branch:
                        v = _conv(blk, v, lay)
                    out.append(v.permute(0, 2, 3, 1))
        if lay.spatial_axis:
            out = [gather(v, 1, lay.groups["spatial"]) for v in out]
        return list(zip(out[0::2], out[1::2]))


# --- channel sharding ---------------------------------------------------------


def _conv_blocks(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    return [(n, m) for n, m in model.named_modules() if isinstance(m, yolov8.TrainConvBlock)]


def channel_shardings(mesh: Mesh, model: nn.Module, model_axis: str = "model") -> Dict[str, bool]:
    """Per parameter and BN statistic (by name): True where its conv's
    out-channel count divides over ``model_axis`` and is at least 16 (JAX's
    rule on the trailing, out-channel dim of the HWIO tree)."""
    n = mesh.shape[model_axis]
    out = {}
    for name, blk in _conv_blocks(model):
        cout = blk.conv.out_channels
        sharded = cout % n == 0 and cout >= MIN_CHANNEL
        for pn, _ in list(blk.named_parameters()) + list(blk.named_buffers()):
            if not pn.endswith("num_batches_tracked"):
                out[f"{name}.{pn}"] = sharded
    return out


@torch.no_grad()
def _shard_block(blk, n: int, r: int, moved: Dict[int, nn.Parameter]) -> None:
    cout = blk.conv.out_channels
    sl = slice(r * cout // n, (r + 1) * cout // n)

    def param(mod, attr):
        old = getattr(mod, attr)
        new = nn.Parameter(old.data[sl].clone(), requires_grad=old.requires_grad)
        setattr(mod, attr, new)
        moved[id(old)] = new

    param(blk.conv, "weight")
    if blk.bn is not None:
        param(blk.bn, "weight")
        param(blk.bn, "bias")
        blk.bn.running_mean = blk.bn.running_mean[sl].clone()
        blk.bn.running_var = blk.bn.running_var[sl].clone()
        blk.bn.num_features = cout // n
    else:
        param(blk, "bias")
    blk.tp_sharded = True


def shard_channels(mesh: Mesh, model: nn.Module, model_axis: str = "model") -> Dict[int, nn.Parameter]:
    """Keep this rank's out-channel slice of every sharded conv (in place);
    -> {id(old parameter): new parameter}."""
    n, r = mesh.shape[model_axis], mesh.coord(model_axis)
    moved: Dict[int, nn.Parameter] = {}
    for _, blk in _conv_blocks(model):
        cout = blk.conv.out_channels
        if cout % n == 0 and cout >= MIN_CHANNEL:
            _shard_block(blk, n, r, moved)
    return moved


@torch.no_grad()
def gather_channels(mesh: Mesh, model: nn.Module, model_axis: str = "model") -> nn.Module:
    """A full copy of a channel-sharded model (every rank gets it)."""
    group = mesh.group(model_axis)
    full = yolov8.build_model(model.spec, model.compute_dtype, train=True).to(
        next(model.parameters()).device)
    src = dict(list(model.named_parameters()) + list(model.named_buffers()))
    for name, t in list(full.named_parameters()) + list(full.named_buffers()):
        v = src[name]
        if v.shape != t.shape:
            parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, v.contiguous(), group=group)
            v = torch.cat(parts, dim=0)
        t.copy_(v)
    return full


# --- the steps ----------------------------------------------------------------


def _sum_grads(params: List[nn.Parameter], group) -> None:
    grads = [p.grad for p in params]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(v)


def _make_step(lay: Layout, clip_norm: Optional[float]):
    def step(model, ema, opt, it, x, t, m):
        """One update on this rank's shard (x: (B/data, H/spatial, W, 3);
        t, m: (B/data, M, ...)); -> (global loss, global aux), detached."""
        data = lay.groups["data"]
        H, W = x.shape[1] * lay.n_spatial, x.shape[2]
        net = ParallelDetect(model, lay)
        with precision_for(model.compute_dtype):  # TF32 off in the backward too
            loss, aux = detection_loss(net, x, t, m, hw=(H, W),
                                       reduce_sum=lambda s: all_reduce(s.detach(), data))
            opt.zero_grad(set_to_none=True)
            (loss / (lay.n_spatial * lay.n_model)).backward()
        sharded = [p for _, blk in _conv_blocks(model) if getattr(blk, "tp_sharded", False)
                   for p in blk.parameters()]
        ids = {id(p) for p in sharded}
        _sum_grads([p for p in sharded if p.grad is not None], data)
        _sum_grads([p for p in model.parameters() if id(p) not in ids and p.grad is not None],
                   lay.groups["all"])
        if clip_norm is not None:
            _clip(model, ids, lay, clip_norm)
        opt.step()
        ema_update(ema_tensors(ema), ema_tensors(model), int(it))
        out = torch.stack([loss.detach()] + [aux[k].detach().float() for k in ("box", "cls", "dfl", "num_fg")])
        dist.all_reduce(out, group=data)
        return out[0], {"box": out[1], "cls": out[2], "dfl": out[3], "num_fg": out[4]}

    return step


@torch.no_grad()
def _clip(model, sharded_ids, lay: Layout, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the global gradient (with every
    gradient whole on each rank, ``train/optim.py``'s, as ``detect_step``
    clips)."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not sharded_ids:
        clip_by_global_norm([p.grad for p in params], max_norm)
        return
    sq_sh = sum((p.grad.float() ** 2).sum() for p in params if id(p) in sharded_ids)
    sq_rep = sum((p.grad.float() ** 2).sum() for p in params if id(p) not in sharded_ids)
    sq_sh = torch.as_tensor(sq_sh, dtype=torch.float32, device=params[0].device)
    if lay.model_axis:
        dist.all_reduce(sq_sh, group=lay.groups["model"])
    norm = float(torch.sqrt(sq_sh + sq_rep))
    if norm >= max_norm:
        for p in params:
            p.grad.div_(norm).mul_(max_norm)


def make_dp_train_step(mesh: Mesh, data_axis: str = "data", spatial_axis: Optional[str] = None,
                       clip_norm: Optional[float] = None) -> Callable:
    """``step(model, ema, opt, it, x, t, m) -> (loss, aux)`` with the batch
    split over ``data_axis`` (and the rows over ``spatial_axis``), the model,
    the EMA and the caller's optimizer (``opt``, as JAX's ``tx``; its learning
    rate is the caller's) replicated. ``clip_norm`` clips the global gradient
    as optax does (None: no clip, as the JAX dry run's ``adamw(1e-3)``)."""
    return _make_step(Layout.of(mesh, data_axis, spatial_axis), clip_norm)


def make_tp_train_step(mesh: Mesh, data_axis: str = "data", model_axis: str = "model",
                       clip_norm: Optional[float] = None):
    """Tensor-parallel + data-parallel step over a (data, model) mesh.
    Returns ``(step, place)``: ``place(model, ema, opt, x, t, m)`` keeps this
    rank's out-channel slices of the model and the EMA (and of AdamW's
    moments, rebinding ``opt``'s groups) and its slice of the batch;
    ``step`` is ``make_dp_train_step``'s on the sharded state."""
    lay = Layout.of(mesh, data_axis, model_axis=model_axis)
    step = _make_step(lay, clip_norm)

    def place(model, ema, opt, x, t, m):
        moved = shard_channels(mesh, model, model_axis)
        shard_channels(mesh, ema, model_axis)
        n, r = mesh.shape[model_axis], mesh.coord(model_axis)
        for g in opt.param_groups:
            new = []
            for p in g["params"]:
                q = moved.get(id(p), p)
                if q is not p and p in opt.state:
                    st = opt.state.pop(p)
                    size = p.shape[0] // n
                    opt.state[q] = {k: (v[r * size:(r + 1) * size].clone() if torch.is_tensor(v) and v.dim() else v)
                                    for k, v in st.items()}
                new.append(q)
            g["params"] = new
        from manual_yolo_tpu_torch.parallel.mesh import shard_batch

        return (model, ema, opt) + tuple(shard_batch(mesh, (x, t, m), data_axis))

    return step, place
