"""Rank-classifier trainer. Counterpart of ``manual_yolo_tpu/train/classifier.py``.

Fine-tunes yolov8n-cls on a folder dataset (``<root>/{train,valid}/<class>/``,
PNG files), as the reference's ``class.py``: a train step of a forward with
batch-statistics BN and cross-entropy, AdamW with warmup and cosine decay
(``train/optim.py``), early stopping on validation top-1 (on the worse of
the folder and the matched split when ``matched_npz`` is given), the best
checkpoint written to ``out_path`` with ``args.json``, ``results.csv`` and
``confusion_matrix.csv`` beside it.

Weight decay follows ``_partition_decay`` of the JAX trainer: conv and
linear kernels decay; BN parameters and biases do not. An f32 run keeps
TF32 off in the forward and the backward.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from manual_yolo_tpu_torch.core.device import precision_for, resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, save_params
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.train.data import augment_classify_batch, load_classify_folder
from manual_yolo_tpu_torch.train.optim import adamw, set_lr, warmup_cosine


@dataclass
class ClsTrainConfig:
    data_root: str
    out_path: str = "runs_torch/rank_classifier/best.npz"
    epochs: int = 50
    batch: int = 64
    imgsz: int = 64
    patience: int = 10
    lr: float = 1e-3
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    label_smoothing: float = 0.0
    scale: str = "n"
    seed: int = 0
    init_from: Optional[str] = None  # a .pt warm start: not ported yet
    init_from_npz: Optional[str] = None  # native checkpoint warm start
    # optional distribution-matched crops (train/matched_crops.py): co-trained
    # with the folder dataset and evaluated as a second validation axis
    matched_npz: Optional[str] = None
    compute_dtype: str = "float32"
    device: str = "cuda"


def decay_groups(model: torch.nn.Module, weight_decay: float) -> List[dict]:
    """Two AdamW groups as ``_partition_decay`` splits the tree: conv and
    linear kernels decay, BN parameters and biases do not."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        (no_decay if ".bn." in name or name.endswith("bias") else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def classify_step(model, opt, x: torch.Tensor, y: torch.Tensor, lr: float,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """One update: cross-entropy of the train-mode forward, AdamW at ``lr``."""
    nc = model.spec.nc
    set_lr(opt, lr)
    with precision_for(model.compute_dtype):  # TF32 off in the backward too
        logits = model(x)
        labels = F.one_hot(y.long(), nc).float()
        if label_smoothing:
            labels = labels * (1 - label_smoothing) + label_smoothing / nc
        loss = -(labels * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_logits(model, x: np.ndarray, device: torch.device) -> np.ndarray:
    """Logits of the eval-mode model (BN on its running statistics)."""
    was_training = model.training
    model.eval()
    try:
        return model(torch.from_numpy(np.ascontiguousarray(x)).to(device)).cpu().numpy()
    finally:
        model.train(was_training)


def evaluate(model, x: np.ndarray, y: np.ndarray, device) -> Tuple[float, float]:
    """(top-1, top-5) of ``model`` on crops ``x`` with labels ``y``."""
    logits = eval_logits(model, x, device)
    top1 = float(np.mean(logits.argmax(-1) == y))
    top5 = float(np.mean([t in row.argsort()[-5:] for t, row in zip(y, logits)]))
    return top1, top5


def train_classifier(cfg: ClsTrainConfig, log=print) -> Dict[str, float]:
    dev = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    x_train, y_train, names = load_classify_folder(os.path.join(cfg.data_root, "train"), cfg.imgsz)
    x_val, y_val, names_v = load_classify_folder(os.path.join(cfg.data_root, "valid"), cfg.imgsz)
    if names != names_v:
        raise ValueError(f"train/valid class folders differ: {names} vs {names_v}")
    nc = len(names)
    x_val_m = y_val_m = None
    if cfg.matched_npz:
        from manual_yolo_tpu_torch.train.matched_crops import load_matched_dataset

        matched, names_m = load_matched_dataset(cfg.matched_npz)
        if names != names_m:
            raise ValueError(f"matched dataset class order differs: {names_m}")
        xm, ym = matched["train"]
        x_train = np.concatenate([x_train, xm])
        y_train = np.concatenate([y_train, ym])
        if "valid" in matched:
            x_val_m, y_val_m = matched["valid"]
        log(f"co-training with {len(xm)} matched crops "
            f"(+{len(x_val_m) if x_val_m is not None else 0} matched valid)")
    log(f"train {len(x_train)} imgs, valid {len(x_val)} imgs, {nc} classes")

    spec = yolov8.build_spec("classify", cfg.scale, nc)
    if cfg.init_from:
        raise NotImplementedError(
            "init_from (a .pt checkpoint) is not ported: the .pt import is ROADMAP "
            "Queue 1 item 2; warm-start from a native checkpoint with init_from_npz")
    if cfg.init_from_npz:
        params, _meta = load_params(cfg.init_from_npz)
        log(f"warm-started from {cfg.init_from_npz}")
    else:
        params = yolov8.init_params(torch.Generator().manual_seed(cfg.seed), spec)
    model = yolov8.load_jax_params(yolov8.build_model(spec, cdt, train=True), params).to(dev)

    steps_per_epoch = max(1, len(x_train) // cfg.batch)
    total_steps = steps_per_epoch * cfg.epochs
    warmup_steps = min(int(cfg.warmup_epochs * steps_per_epoch), max(total_steps // 3, 1))
    sched = warmup_cosine(cfg.lr * 0.01, cfg.lr, warmup_steps, total_steps, cfg.lr * 0.01)
    opt = adamw(decay_groups(model, cfg.weight_decay), cfg.weight_decay)

    best_top1, best_epoch, t0 = -1.0, -1, time.time()
    history = []
    step = 0
    for epoch in range(cfg.epochs):
        perm = rng.permutation(len(x_train))
        ep_loss = 0.0
        step_ms, batch_ms = [], []
        for s in range(steps_per_epoch):
            idx = perm[s * cfg.batch : (s + 1) * cfg.batch]
            tb = time.perf_counter()
            xb = augment_classify_batch(rng, x_train[idx])
            ts = time.perf_counter()
            loss = classify_step(model, opt, torch.from_numpy(xb).to(dev),
                                 torch.from_numpy(y_train[idx]).to(dev), sched(step),
                                 cfg.label_smoothing)
            ep_loss += float(loss)  # waits for the device
            step_ms.append((time.perf_counter() - ts) * 1e3)
            batch_ms.append((ts - tb) * 1e3)
            step += 1
        top1, top5 = evaluate(model, x_val, y_val, dev)
        top1_m = None
        if x_val_m is not None:
            top1_m = float(np.mean(eval_logits(model, x_val_m, dev).argmax(-1) == y_val_m))
        # selection score: worst of the two validation distributions
        score = top1 if top1_m is None else min(top1, top1_m)
        history.append({"epoch": epoch + 1, "loss": ep_loss / steps_per_epoch,
                        "top1": top1, "top5": top5, "top1_matched": top1_m,
                        "step_ms": statistics.median(step_ms),
                        "batch_ms": statistics.median(batch_ms)})
        log(
            f"epoch {epoch+1}/{cfg.epochs} loss {ep_loss/steps_per_epoch:.4f} "
            f"top1 {top1:.4f} top5 {top5:.4f}"
            + (f" top1_matched {top1_m:.4f}" if top1_m is not None else "")
            + f" ({time.time()-t0:.1f}s)"
        )
        if score > best_top1:
            best_top1, best_epoch = score, epoch
            meta = {
                "names": {i: n for i, n in enumerate(names)},
                "spec": {"variant": "classify", "scale": cfg.scale, "nc": nc},
                "top1": top1,
                "top5": top5,
                "epoch": epoch + 1,
            }
            if top1_m is not None:
                meta["top1_matched"] = top1_m
            save_params(cfg.out_path, yolov8.export_params(model), meta=meta)
        if epoch - best_epoch >= cfg.patience:
            log(f"early stop at epoch {epoch+1} (best {best_top1:.4f} @ {best_epoch+1})")
            break

    # training artifacts, mirroring the reference run directory
    run_dir = os.path.dirname(os.path.abspath(cfg.out_path))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    with open(os.path.join(run_dir, "results.csv"), "w") as f:
        f.write("epoch,train_loss,top1,top5,top1_matched\n")
        for h in history:
            m = h.get("top1_matched")
            f.write(
                f"{h['epoch']},{h['loss']:.5f},{h['top1']:.5f},{h['top5']:.5f},"
                + (f"{m:.5f}\n" if m is not None else "\n")
            )
    best_params, _ = load_params(cfg.out_path)
    best = yolov8.load_jax_params(yolov8.build_model(spec, cdt, train=True), best_params).to(dev)
    pred = eval_logits(best, x_val, dev).argmax(-1)
    cm = np.zeros((nc, nc), np.int32)
    for t, p in zip(y_val, pred):
        cm[t, p] += 1
    np.savetxt(
        os.path.join(run_dir, "confusion_matrix.csv"), cm, fmt="%d", delimiter=",",
        header=",".join(names), comments="",
    )
    return {
        "best_top1": best_top1,
        "best_epoch": best_epoch + 1,
        "wall_s": time.time() - t0,
        "history": history,
    }
