"""Appearance (re-id) embedder trainer. Counterpart of ``manual_yolo_tpu/train/embedder.py``.

The objective is the JAX trainer's: each labeled box of a YOLO dataset is
one identity; two tracker-realistic views of it (a jittered re-crop,
photometric jitter, an occasional 3x3 blur; no flips) are a positive pair,
every other view in the batch a negative (NT-Xent over the 2N views); the
backbone is yolov8n-cls (warm-started from the rank classifier) with a
projection MLP used only in training. Runtime matching
(``runtime/embedder.py::AppearanceEmbedder``) uses the pooled backbone
features, so the checkpoint is written in the classifier-npz layout with
the JAX trainer's meta and loads there (and in the JAX package) unchanged.

Where the JAX trainer differs from the port's other trainers, the port
follows it:

  * ``optax.adamw`` without a mask decays every leaf: one AdamW group holds
    every parameter, BN and biases included; the classify head, which the
    loss never reaches, gets zero gradients (so it decays, as optax decays
    a leaf whose gradient is zero), and the BN statistics no forward
    updated (the head's) decay by ``lr * weight_decay`` as optax's leaves do;
  * the host view sampler is the JAX one line for line (its numpy dtype
    promotions and its order of ``rng`` draws), with ``cv2.resize`` and
    ``cv2.GaussianBlur`` replaced by ``ops/image.py::cv_resize_u8`` and
    ``gaussian_blur3_u8``, both bit for bit cv2's;
  * the projection head is drawn from an explicit ``torch.Generator`` (the
    JAX package draws it from ``jax.random``); ``train_embedder`` takes
    ``proj_init`` to start from a given head.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from manual_yolo_tpu_torch.core.device import precision_for, resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, save_params
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops.image import cv_resize_u8, gaussian_blur3_u8
from manual_yolo_tpu_torch.train.data import load_yolo_split
from manual_yolo_tpu_torch.train.optim import adamw, set_lr, warmup_cosine


@dataclass
class ReidTrainConfig:
    data_root: str  # YOLO-format dataset root (train/ valid/ splits)
    out_path: str = "weights/reid_embedder.npz"
    epochs: int = 8
    batch: int = 48  # instances per step (2 views each -> 2*batch forward)
    imgsz: int = 64
    lr: float = 5e-4
    weight_decay: float = 1e-4
    temperature: float = 0.1
    proj_dim: int = 128
    scale: str = "n"
    seed: int = 0
    init_from_npz: Optional[str] = "weights/rank_classifier_matched.npz"
    min_box: int = 8  # skip degenerate labeled boxes below this pixel size
    context_pad: float = 0.25  # instance context window beyond the box
    compute_dtype: str = "float32"
    device: str = "cuda"


# ---------------------------------------------------------------------------
# instance extraction + tracker-realistic view sampling (host numpy)


def extract_instances(
    samples, min_box: int = 8, context_pad: float = 0.25, imgsz: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """(context windows u8 (N, S, S, 3), class ids (N,)) from labeled boxes:
    each box widened by ``context_pad`` on every side, clipped to the image,
    resized to a 2 * imgsz canvas (room for the view sampler's re-crops)."""
    side = imgsz * 2
    crops: List[np.ndarray] = []
    classes: List[int] = []
    for s in samples:
        h, w = s.image.shape[:2]
        for box, cid in zip(s.boxes, s.classes):
            x1, y1, x2, y2 = box
            bw, bh = x2 - x1, y2 - y1
            if bw < min_box or bh < min_box:
                continue
            px, py = bw * context_pad, bh * context_pad
            cx1 = max(int(x1 - px), 0)
            cy1 = max(int(y1 - py), 0)
            cx2 = min(int(x2 + px), w)
            cy2 = min(int(y2 + py), h)
            win = s.image[cy1:cy2, cx1:cx2]
            if win.size == 0:
                continue
            crops.append(cv_resize_u8(win, (side, side)))
            classes.append(int(cid))
    return np.stack(crops), np.asarray(classes, np.int32)


def sample_views(
    rng: np.random.Generator, windows: np.ndarray, imgsz: int = 64
) -> np.ndarray:
    """One view per context window: a re-crop of 0.75-1.0 of the window at a
    random offset (box noise), resized to ``imgsz``, blurred one time in
    five, BGR -> RGB in [0, 1], a global gain, a per-channel bias and (half
    the time) gaussian noise. windows (N, 2*imgsz, 2*imgsz, 3) u8 -> views
    (N, imgsz, imgsz, 3) f32."""
    n, side = windows.shape[0], windows.shape[1]
    out = np.empty((n, imgsz, imgsz, 3), np.float32)
    for i in range(n):
        cs = int(side * rng.uniform(0.75, 1.0))
        ox = rng.integers(0, side - cs + 1)
        oy = rng.integers(0, side - cs + 1)
        v = windows[i, oy : oy + cs, ox : ox + cs]
        v = cv_resize_u8(v, (imgsz, imgsz))
        if rng.random() < 0.2:
            v = gaussian_blur3_u8(v)
        f = v[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB
        # photometric: global gain + per-channel bias + gaussian noise
        f = f * rng.uniform(0.85, 1.15) + rng.uniform(-0.06, 0.06, (1, 1, 3))
        if rng.random() < 0.5:
            f = f + rng.normal(0.0, 0.015, f.shape)
        out[i] = np.clip(f, 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# model: classify backbone + training-only projection head


def init_projection(g: torch.Generator, in_dim: int, proj_dim: int) -> Dict[str, np.ndarray]:
    """The head's weights in the JAX layout: ``w1`` (in, in) and ``w2``
    (in, proj) normal with std sqrt(2 / in), ``b1`` zero."""
    s = (2.0 / in_dim) ** 0.5
    w1 = torch.randn((in_dim, in_dim), generator=g) * s
    w2 = torch.randn((in_dim, proj_dim), generator=g) * s
    return {"w1": w1.numpy(), "b1": np.zeros(in_dim, np.float32), "w2": w2.numpy()}


class ProjectionHead(nn.Module):
    """relu(x @ w1 + b1) @ w2, L2-normalised (floor 1e-6); f32."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        super().__init__()
        for k in ("w1", "b1", "w2"):
            setattr(self, k, nn.Parameter(torch.from_numpy(np.array(weights[k], np.float32))))

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        h = torch.relu(pooled @ self.w1 + self.b1)
        z = h @ self.w2
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-6)


def pooled_features(model, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) RGB in [0, 1] -> the last backbone feature map, mean over
    space in f32: (N, C)."""
    with model._precision():
        feats = model.forward_features(x.permute(0, 3, 1, 2))
    return feats[-1].float().mean(dim=(2, 3))


def nt_xent_loss(z: torch.Tensor, temperature: float) -> torch.Tensor:
    """z: (2N, D) unit vectors, views 2i and 2i+1 are a positive pair."""
    n2 = z.shape[0]
    sim = z @ z.T / temperature
    sim = sim - 1e9 * torch.eye(n2, dtype=sim.dtype, device=sim.device)  # mask self-similarity
    idx = torch.arange(n2, device=z.device)
    return (-sim[idx, idx ^ 1] + torch.logsumexp(sim, dim=-1)).mean()


def _bn_modules(model) -> List[nn.BatchNorm2d]:
    return [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]


def embed_step(model, head: ProjectionHead, opt, views: torch.Tensor, lr: float,
               temperature: float, weight_decay: float) -> torch.Tensor:
    """One update of the JAX trainer's ``train_step``: NT-Xent of the
    train-mode forward (BN on the batch statistics, which also moves the
    running statistics), AdamW at ``lr`` on every parameter (a parameter
    the loss does not reach gets a zero gradient), then the BN statistics
    the forward did not move decay by ``lr * weight_decay``."""
    set_lr(opt, lr)
    bns = _bn_modules(model)
    seen = [int(m.num_batches_tracked) for m in bns]
    with precision_for(model.compute_dtype):  # TF32 off in the backward too
        loss = nt_xent_loss(head(pooled_features(model, views)), temperature)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    for g in opt.param_groups:
        for p in g["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    keep = float(np.float32(1.0) - np.float32(lr) * np.float32(weight_decay))
    with torch.no_grad():
        for m, n in zip(bns, seen):
            if int(m.num_batches_tracked) == n:
                m.running_mean.mul_(keep)
                m.running_var.mul_(keep)
    return loss.detach()


# ---------------------------------------------------------------------------
# verification evaluation (the tracker's actual decision problem)


def verification_auc(
    embed_fn, windows: np.ndarray, classes: np.ndarray, imgsz: int,
    rng: np.random.Generator, n_neg: int = 4000,
) -> Dict[str, float]:
    """AUC of same-instance vs different-instance cosine similarity, for all
    negative pairs and for the same-class ones (the pairs DeepSORT's cosine
    gate has to split). Positives: two independent views of one instance."""
    va = embed_fn(sample_views(rng, windows, imgsz))
    vb = embed_fn(sample_views(rng, windows, imgsz))
    n = len(windows)
    pos = np.sum(va * vb, axis=-1)

    idx_a = rng.integers(0, n, n_neg)
    idx_b = rng.integers(0, n, n_neg)
    keep = idx_a != idx_b
    idx_a, idx_b = idx_a[keep], idx_b[keep]
    neg = np.sum(va[idx_a] * vb[idx_b], axis=-1)
    same_cls = classes[idx_a] == classes[idx_b]

    def auc(p, q):
        if not len(p) or not len(q):
            return float("nan")
        order = np.concatenate([p, q])
        ranks = order.argsort().argsort()[: len(p)] + 1
        return float(
            (ranks.sum() - len(p) * (len(p) + 1) / 2) / (len(p) * len(q))
        )

    return {
        "auc_all": auc(pos, neg),
        "auc_same_class": auc(pos, neg[same_cls]),
        "pos_mean": float(pos.mean()),
        "neg_mean": float(neg.mean()),
        "neg_same_class_mean": float(neg[same_cls].mean())
        if same_cls.any() else float("nan"),
    }


EVAL_BATCH = 256  # views per eval forward


def embedder_fn(model, device: torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """views (N, H, W, 3) f32 -> (N, C) unit vectors of the eval-mode
    (running statistics) pooled features; the model returns to train mode."""

    def fn(views: np.ndarray) -> np.ndarray:
        model.eval()
        out = []
        try:
            with torch.inference_mode():
                for i in range(0, len(views), EVAL_BATCH):
                    x = torch.from_numpy(np.ascontiguousarray(views[i : i + EVAL_BATCH])).to(device)
                    pooled = pooled_features(model, x)
                    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-6)
                    out.append((pooled / norm).cpu().numpy())
        finally:
            model.train()
        return np.concatenate(out)

    return fn


def _score(m: Dict[str, float]) -> float:
    # NaN-safe checkpoint score: the hard same-class AUC, else all-pairs
    for k in ("auc_same_class", "auc_all"):
        v = m.get(k, float("nan"))
        if v == v:
            return float(v)
    return 0.0


def train_embedder(cfg: ReidTrainConfig, log=print,
                   proj_init: Optional[Dict[str, np.ndarray]] = None,
                   timings: Optional[Dict[str, List[float]]] = None) -> Dict[str, float]:
    """Train, evaluate each epoch, checkpoint the best epoch (its score the
    same-class AUC, NaN-safe). ``timings``, when given, collects per-step
    ``step_ms`` (device), ``sample_ms`` (host views of one batch) and
    ``loss``."""
    dev = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    train = load_yolo_split(cfg.data_root, "train")
    valid = load_yolo_split(cfg.data_root, "valid")
    w_train, c_train = extract_instances(train, cfg.min_box, cfg.context_pad, cfg.imgsz)
    w_val, c_val = extract_instances(valid, cfg.min_box, cfg.context_pad, cfg.imgsz)
    log(f"instances: train {len(w_train)}, valid {len(w_val)}")

    # 13 is the rank-classifier head size: the head is unused, but the
    # classifier layout lets AppearanceEmbedder.from_npz load the checkpoint
    spec = yolov8.build_spec("classify", cfg.scale, 13)
    if cfg.init_from_npz and os.path.exists(cfg.init_from_npz):
        params, _ = load_params(cfg.init_from_npz)
        log(f"warm-started from {cfg.init_from_npz}")
    else:
        params = yolov8.init_params(torch.Generator().manual_seed(cfg.seed), spec)
    model = yolov8.load_jax_params(yolov8.build_model(spec, cdt, train=True), params).to(dev)
    model.train()
    in_dim = spec.layers[-1].cin
    if proj_init is None:
        proj_init = init_projection(torch.Generator().manual_seed(cfg.seed + 1), in_dim,
                                    cfg.proj_dim)
    head = ProjectionHead(proj_init).to(dev)

    steps_per_epoch = max(1, len(w_train) // cfg.batch)
    total_steps = steps_per_epoch * cfg.epochs
    sched = warmup_cosine(cfg.lr * 0.05, cfg.lr, max(total_steps // 20, 1), total_steps,
                          cfg.lr * 0.02)
    opt = adamw(list(model.parameters()) + list(head.parameters()), cfg.weight_decay)

    embed = embedder_fn(model, dev)
    base = verification_auc(embed, w_val, c_val, cfg.imgsz, np.random.default_rng(1234))
    log(f"pre-train verification: {base}")

    t0 = time.time()
    best = dict(base)
    # the best TRAINED epoch is always written, even below the warm start
    best_score = -float("inf")
    step = 0
    for epoch in range(cfg.epochs):
        perm = rng.permutation(len(w_train))
        ep_loss, nst = 0.0, 0
        for s in range(steps_per_epoch):
            idx = perm[s * cfg.batch : (s + 1) * cfg.batch]
            win = w_train[idx]
            ts = time.perf_counter()
            va = sample_views(rng, win, cfg.imgsz)
            vb = sample_views(rng, win, cfg.imgsz)
            # interleave so views 2i, 2i+1 pair up
            views = np.empty((2 * len(win), cfg.imgsz, cfg.imgsz, 3), np.float32)
            views[0::2], views[1::2] = va, vb
            tv = time.perf_counter()
            loss = embed_step(model, head, opt, torch.from_numpy(views).to(dev), sched(step),
                              cfg.temperature, cfg.weight_decay)
            loss = float(loss)  # waits for the step
            if timings is not None:
                timings.setdefault("sample_ms", []).append((tv - ts) * 1e3)
                timings.setdefault("step_ms", []).append((time.perf_counter() - tv) * 1e3)
                timings.setdefault("loss", []).append(loss)
            ep_loss += loss
            nst += 1
            step += 1
        m = verification_auc(embed, w_val, c_val, cfg.imgsz, np.random.default_rng(1234))
        log(f"epoch {epoch + 1}/{cfg.epochs} loss {ep_loss / max(nst, 1):.4f} "
            f"auc_all {m['auc_all']:.4f} auc_same_class "
            f"{m['auc_same_class']:.4f} ({time.time() - t0:.0f}s)")
        if _score(m) >= best_score:
            best_score = _score(m)
            best = dict(m)
            save_params(
                cfg.out_path, yolov8.export_params(model),
                meta={
                    "spec": {"variant": "classify", "scale": cfg.scale, "nc": 13},
                    "type": "reid_embedder",
                    "objective": "nt_xent",
                    "imgsz": cfg.imgsz,
                    "metrics": {k: round(v, 4) for k, v in m.items()},
                    "pre_train": {k: round(v, 4) for k, v in base.items()},
                },
            )
    best["pre_auc_all"] = base["auc_all"]
    best["pre_auc_same_class"] = base["auc_same_class"]
    return best
