"""CRAFT text-detector training on synthetic multi-line scenes. Counterpart of
``manual_yolo_tpu/train/craft.py``.

Scenes are 1-4 text lines on poker-UI-like backgrounds (or real labelled
crops and panels composited), supervised with CRAFT's gaussians: a region
heatmap of per-character gaussians and an affinity heatmap between
neighbours, at half resolution. For one ``np.random.default_rng(seed)`` the
renders equal the JAX package's: text from the committed glyph table
(``runtime/truetype.py``), crop resizes with cv2's uint8 linear
(``ops/image.py::cv_resize_u8``).

A train step gathers a batch from the uint8 pools resident on the device,
runs the train-mode forward (batch BN statistics; bf16 convs by default,
as the JAX trainer runs them), the MSE loss, clips the gradient to a
global norm of 5, takes an AdamW step (optax's defaults, over the
warmup-cosine schedule) and then writes the BN running statistics. Index
draws use the JAX trainer's chunk shapes. Every ``eval_every`` steps the
line F1 of the eval-mode forward on a batch of pool scenes picks the
checkpoint.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import precision_for, resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, save_params
from manual_yolo_tpu_torch.models import craft
from manual_yolo_tpu_torch.ops.image import cv_resize_u8
from manual_yolo_tpu_torch.runtime import truetype
from manual_yolo_tpu_torch.train.ocr import FONTS, WEIGHT_DECAY, pool_u8, random_sample
from manual_yolo_tpu_torch.train.optim import adamw, clip_by_global_norm, set_lr, warmup_cosine

CLIP_NORM = 5.0


def _gauss2d(h: int, w: int, cy: float, cx: float, sy: float, sx: float):
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    return np.exp(-(((ys - cy) ** 2) / (2 * sy**2) + ((xs - cx) ** 2) / (2 * sx**2)))


def render_scene(rng, size: int = 256) -> Tuple[np.ndarray, np.ndarray, List]:
    """-> (rgb (size, size, 3) [0, 1], heat (size/2, size/2, 2), line boxes px)."""
    style = rng.random()
    if style < 0.5:
        bg = rng.uniform(0.05, 0.25)
    elif style < 0.8:
        bg = rng.uniform(0.25, 0.5)
    else:
        bg = rng.uniform(0.75, 0.95)
    img = np.full((size, size, 3), bg, np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)

    hh = size // 2
    heat = np.zeros((hh, hh, 2), np.float32)
    n_lines = int(rng.integers(1, 5))
    boxes = []
    used_rows: List[Tuple[int, int]] = []
    canvas = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    for _ in range(n_lines):
        text = random_sample(rng)[0][:16]
        if not text.strip():
            continue
        fsize = int(rng.integers(14, 30))
        font = truetype.truetype(FONTS[rng.integers(0, len(FONTS))], fsize)
        bbox = font.getbbox(text)
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        if tw >= size - 8 or th >= size // 3:
            continue
        x0 = int(rng.integers(2, size - tw - 4))
        y0 = int(rng.integers(2, size - th - 4))
        if any(abs(y0 - r0) < th + 6 for r0, _ in used_rows):
            continue  # keep lines vertically separated
        used_rows.append((y0, y0 + th))
        light = bg < 0.5
        fill = int(rng.uniform(200, 255)) if light else int(rng.uniform(0, 60))
        truetype.draw_text(canvas, (x0 - bbox[0], y0 - bbox[1]), text, font, (fill,) * 3)
        boxes.append((x0, y0, x0 + tw, y0 + th))

        # per-character gaussians (region) and between characters (affinity)
        centers = []
        cx = x0
        for ch in text:
            cw = max(font.getlength(ch), 1.0)
            if ch != " ":
                centers.append((x0 - bbox[0] + (cx - x0) + cw / 2, y0 + th / 2, cw))
            cx += cw
        for (ccx, ccy, cw) in centers:
            heat[..., 0] = np.maximum(
                heat[..., 0],
                _gauss2d(hh, hh, ccy / 2, ccx / 2, max(th / 5, 1.2), max(cw / 5, 1.0)),
            )
        for (a, b) in zip(centers, centers[1:]):
            mx, my = (a[0] + b[0]) / 2, (a[1] + b[1]) / 2
            heat[..., 1] = np.maximum(
                heat[..., 1],
                _gauss2d(hh, hh, my / 2, mx / 2, max(th / 5, 1.2), max((b[0] - a[0]) / 3.5, 1.0)),
            )

    img = canvas.astype(np.float32) / 255.0
    img = np.clip(img * rng.uniform(0.8, 1.15) + rng.uniform(-0.08, 0.08), 0, 1)
    return img.astype(np.float32), heat, boxes


@dataclass
class CraftTrainConfig:
    out_path: str = "weights/craft_synth.npz"
    steps: int = 3000
    batch: int = 8
    size: int = 256
    lr: float = 5e-4
    seed: int = 0
    eval_every: int = 250
    pool_size: int = 2000
    compute_dtype: str = "bfloat16"
    # real labelled UI crops composited into scenes (line-level supervision)
    real_labels: str = ""
    real_splits: Tuple[str, ...] = ("train", "valid")
    real_scene_frac: float = 0.5
    # scenes tiled with whole labelled panels of the dataset's screenshots
    panel_scene_frac: float = 0.0
    panel_splits: Tuple[str, ...] = ("train", "valid")
    init_from: str = ""
    device: str = "cuda"


def _paste_crop_heat(heat, x0, y0, w, h, n_chars):
    """Line-level supervision for a pasted real crop: character centres
    evenly spaced across the crop's width."""
    hh = heat.shape[0]
    n = max(int(n_chars), 1)
    cw = w / n
    cy = y0 + h / 2
    for ci in range(n):
        cx = x0 + (ci + 0.5) * cw
        heat[..., 0] = np.maximum(
            heat[..., 0],
            _gauss2d(hh, hh, cy / 2, cx / 2, max(h / 5, 1.2), max(cw / 5, 1.0)),
        )
        if ci:
            mx = x0 + ci * cw
            heat[..., 1] = np.maximum(
                heat[..., 1],
                _gauss2d(hh, hh, cy / 2, mx / 2, max(h / 5, 1.2), max(cw / 3.5, 1.0)),
            )


def render_scene_real(rng, real_pool, size: int = 256):
    """Scene composited from real UI crops: 1-3 groups, each one crop or a
    vertically stacked pair 2-8 px apart (the name-over-stack panel)."""
    style = rng.random()
    if style < 0.6:
        bg = rng.uniform(0.05, 0.25)
    elif style < 0.85:
        bg = rng.uniform(0.25, 0.5)
    else:
        bg = rng.uniform(0.75, 0.95)
    img = np.full((size, size, 3), bg, np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    hh = size // 2
    heat = np.zeros((hh, hh, 2), np.float32)
    boxes = []
    used_rows = []
    for _ in range(int(rng.integers(1, 4))):
        pair = rng.random() < 0.5
        members = []
        for _m in range(2 if pair else 1):
            crop, text = real_pool[int(rng.integers(0, len(real_pool)))]
            ch, cw = crop.shape[:2]
            scale = rng.uniform(0.8, 1.4)
            nh = int(np.clip(ch * scale, 12, size // 4))
            nw = int(np.clip(cw * scale, 8, size - 8))
            members.append((cv_resize_u8(crop, (nh, nw)), text))
        gap = int(rng.integers(2, 9)) if pair else 0
        gh = sum(m[0].shape[0] for m in members) + gap * (len(members) - 1)
        gw = max(m[0].shape[1] for m in members)
        if gw >= size - 8 or gh >= size - 8:
            continue
        x0 = int(rng.integers(4, size - gw - 4))
        y0 = int(rng.integers(4, size - gh - 4))
        if any(not (y0 + gh < r0 - 4 or y0 > r1 + 4) for r0, r1 in used_rows):
            continue  # groups must not overlap vertically
        used_rows.append((y0, y0 + gh))
        yy = y0
        for m_img, m_text in members:
            mh, mw = m_img.shape[:2]
            # crops are BGR; scenes are RGB, as read_region feeds them
            img[yy: yy + mh, x0: x0 + mw] = m_img[..., ::-1].astype(np.float32) / 255.0
            boxes.append((x0, yy, x0 + mw, yy + mh))
            _paste_crop_heat(heat, x0, yy, mw, mh, len(m_text))
            yy += mh + gap
    img = np.clip(img * rng.uniform(0.85, 1.1) + rng.uniform(-0.05, 0.05), 0, 1)
    return img.astype(np.float32), heat, boxes


def build_panel_pool(splits=("train", "valid")) -> List:
    """Whole labelled panels cut from the dataset's screenshots: the region
    (its own background included) and its text-line boxes."""
    from manual_yolo_tpu_torch.cli.eval_craft import build_regions, load_labeled_images
    from manual_yolo_tpu_torch.cli.eval_ocr import imread_or_none

    pool = []
    for img_path, fields in load_labeled_images(splits):
        img = imread_or_none(img_path)
        if img is None:
            continue
        h, w = img.shape[:2]
        for (rx1, ry1, rx2, ry2), lines in build_regions(fields, w, h):
            crop = img[ry1:ry2, rx1:rx2]
            if crop.size == 0 or crop.shape[0] < 14 or crop.shape[1] < 14:
                continue
            rel = [(x1 - rx1, y1 - ry1, x2 - rx1, y2 - ry1) for x1, y1, x2, y2 in lines]
            pool.append((crop, rel))
    return pool


def render_scene_panel(rng, panel_pool, size: int = 256):
    """Scene tiled with real labelled panels at jittered scale and brightness."""
    bg = rng.uniform(0.05, 0.4)
    img = np.full((size, size, 3), bg, np.float32)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    hh = size // 2
    heat = np.zeros((hh, hh, 2), np.float32)
    boxes = []
    used_rows = []
    for _ in range(int(rng.integers(1, 4))):
        crop, rel = panel_pool[int(rng.integers(0, len(panel_pool)))]
        ch, cw = crop.shape[:2]
        scale = rng.uniform(0.75, 1.5)
        nh = int(np.clip(ch * scale, 14, size - 8))
        nw = int(np.clip(cw * scale, 14, size - 8))
        sy, sx = nh / ch, nw / cw
        patch = cv_resize_u8(crop, (nh, nw))
        x0 = int(rng.integers(2, max(3, size - nw - 2)))
        y0 = int(rng.integers(2, max(3, size - nh - 2)))
        if any(not (y0 + nh < r0 - 2 or y0 > r1 + 2) for r0, r1 in used_rows):
            continue
        used_rows.append((y0, y0 + nh))
        gain = rng.uniform(0.85, 1.1)
        img[y0:y0 + nh, x0:x0 + nw] = np.clip(
            patch[..., ::-1].astype(np.float32) / 255.0 * gain, 0, 1)
        for lx1, ly1, lx2, ly2 in rel:
            bx1, by1 = x0 + lx1 * sx, y0 + ly1 * sy
            bx2, by2 = x0 + lx2 * sx, y0 + ly2 * sy
            bw, bh = bx2 - bx1, by2 - by1
            if bw < 4 or bh < 4:
                continue
            n_chars = int(np.clip(round(bw / max(bh * 0.6, 1)), 1, 24))
            _paste_crop_heat(heat, bx1, by1, bw, bh, n_chars)
            boxes.append((int(bx1), int(by1), int(bx2), int(by2)))
    img = np.clip(img + rng.uniform(-0.04, 0.04), 0, 1)
    return img.astype(np.float32), heat, boxes


def build_pool(rng, cfg: CraftTrainConfig, real_pool=None, panel_pool=None):
    imgs = np.zeros((cfg.pool_size, cfg.size, cfg.size, 3), np.float32)
    heats = np.zeros((cfg.pool_size, cfg.size // 2, cfg.size // 2, 2), np.float32)
    metas = []
    for i in range(cfg.pool_size):
        r = rng.random()
        if panel_pool and r < cfg.panel_scene_frac:
            imgs[i], heats[i], boxes = render_scene_panel(rng, panel_pool, cfg.size)
        elif real_pool and r < cfg.panel_scene_frac + cfg.real_scene_frac:
            imgs[i], heats[i], boxes = render_scene_real(rng, real_pool, cfg.size)
        else:
            imgs[i], heats[i], boxes = render_scene(rng, cfg.size)
        metas.append(boxes)
    return imgs, heats, metas


def _iou(a, b) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1)


def _line_f1(pred_boxes, gt_boxes, iou_thr=0.3) -> float:
    """Greedy line-box F1 (recall alone would reward over-segmentation)."""
    if not gt_boxes:
        return 1.0 if not pred_boxes else 0.0
    if not pred_boxes:
        return 0.0
    matched = set()
    hit = 0
    for g in gt_boxes:
        for pi, p in enumerate(pred_boxes):
            if pi in matched:
                continue
            if _iou(g, p) >= iou_thr:
                matched.add(pi)
                hit += 1
                break
    rec = hit / len(gt_boxes)
    prec = hit / len(pred_boxes)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def craft_step(model: craft.CRAFT, opt, params: List[torch.Tensor], x: torch.Tensor,
               y: torch.Tensor, lr: float) -> torch.Tensor:
    """One train step on (N, S, S, 3) scenes and (N, S/2, S/2, 2) heatmaps;
    returns the MSE. The BN running statistics move after the update."""
    model.train()
    with precision_for(model.compute_dtype):  # TF32 off in an f32 backward too
        loss = torch.mean((model(x) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    clip_by_global_norm([p.grad for p in params], CLIP_NORM)
    set_lr(opt, lr)
    opt.step()
    craft.apply_bn_updates(model)
    return loss.detach()


def train_craft(cfg: CraftTrainConfig, log=print) -> Dict:
    """Returns the JAX trainer's ``best_line_f1`` and ``wall_s``, plus
    ``pool_s`` and ``history``: per eval the step, MSE, line F1 and the
    seconds spent in train steps so far."""
    dev = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if cfg.init_from and os.path.exists(cfg.init_from):
        params, _meta = load_params(cfg.init_from)
        log(f"warm-start from {cfg.init_from}")
    else:
        params = craft.init_params(torch.Generator().manual_seed(cfg.seed))
    model = craft.from_jax_params(params, dev)
    model.compute_dtype = cdt
    trainable = list(model.parameters())
    sched = warmup_cosine(cfg.lr * 0.05, cfg.lr, min(200, cfg.steps // 5), cfg.steps, cfg.lr * 0.05)
    opt = adamw(trainable, WEIGHT_DECAY)

    t0 = time.time()
    real_pool = None
    if cfg.real_labels and os.path.exists(cfg.real_labels):
        from manual_yolo_tpu_torch.cli.eval_ocr import load_real_crops

        real_pool = [(crop, text) for crop, _cname, text in
                     load_real_crops(cfg.real_labels, splits=tuple(cfg.real_splits))]
        log(f"real crop pool: {len(real_pool)} crops from {cfg.real_splits}")
    panel_pool = None
    if cfg.panel_scene_frac > 0:
        try:
            panel_pool = build_panel_pool(cfg.panel_splits)
            log(f"panel pool: {len(panel_pool)} labeled panels from {cfg.panel_splits}")
        except Exception as e:
            log(f"panel pool unavailable ({e}); skipping panel scenes")
    log(f"rendering {cfg.pool_size}-scene pool...")
    imgs, heats, metas = build_pool(rng, cfg, real_pool, panel_pool)
    pool_s = time.time() - t0
    log(f"pool ready in {pool_s:.0f}s")
    d_imgs, d_heats = pool_u8(imgs, dev), pool_u8(heats, dev)

    chunk = max(1, cfg.eval_every // 2)
    best, history, train_s = -1.0, [], 0.0
    s = 0
    loss = torch.zeros(())
    while s < cfg.steps:
        n = min(chunk, cfg.steps - s)
        idx = torch.from_numpy(rng.integers(0, cfg.pool_size, (n, cfg.batch)).astype(np.int64)).to(dev)
        ts = time.perf_counter()
        for j in range(n):
            x = d_imgs[idx[j]].float() / 255.0
            y = d_heats[idx[j]].float() / 255.0
            loss = craft_step(model, opt, trainable, x, y, sched(s + j))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s += time.perf_counter() - ts
        s += n
        if s % cfg.eval_every == 0 or s >= cfg.steps:
            eidx = rng.integers(0, cfg.pool_size, cfg.batch).astype(np.int64)
            model.eval()
            with torch.no_grad():
                scores = model(d_imgs[torch.from_numpy(eidx).to(dev)].float() / 255.0)
            scores = scores.float().cpu().numpy()
            f1 = float(np.mean([
                _line_f1(craft.text_regions_from_scores(scores[i]), metas[int(e)])
                for i, e in enumerate(eidx)
            ]))
            history.append({"step": s, "mse": float(loss), "line_f1": f1, "train_s": train_s})
            log(f"step {s}/{cfg.steps} mse {float(loss):.5f} line_f1 {f1:.3f} "
                f"({time.time()-t0:.0f}s)")
            if f1 >= best:
                best = f1
                save_params(cfg.out_path, craft.to_jax_params(model),
                            meta={"size": cfg.size, "line_f1": f1, "step": s})
    return {"best_line_f1": best, "wall_s": time.time() - t0, "pool_s": pool_s,
            "history": history}
