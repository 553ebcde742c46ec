"""Detector trainer. Counterpart of ``manual_yolo_tpu/train/detector.py``.

A train step is the train-mode forward (batch-statistics BN), the TAL /
CIoU / DFL / BCE loss (``train/loss.py``), the gradient clipped to a global
norm of 10 as optax clips it, AdamW on every parameter, then the EMA over
the parameters and BN statistics, in the JAX trainer's order. Four host
threads build the augmented batches (``train/data.py``, seeds ``seed+1+i``)
while the card steps.

Every ``eval_every`` epochs (and the last) ``evaluate_detector`` folds the
EMA weights and measures mAP on the validation split; the best checkpoint
(EMA weights, f16) goes to ``out_path``. ``last_<scale>.npz`` beside it
holds params, EMA and the AdamW moments in f32, in the JAX trainer's layout:
its optimizer leaves are optax's ``[count, *mu, *nu, count]`` over the
sorted-key params tree (the JAX package reads the file).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import queue as queue_mod
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import precision_for, resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, save_params
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops.nms import nms_batch
from manual_yolo_tpu_torch.train import data as data_lib
from manual_yolo_tpu_torch.train.ema import ema_tensors, ema_update
from manual_yolo_tpu_torch.train.loss import detection_loss
from manual_yolo_tpu_torch.train.metrics import mean_average_precision
from manual_yolo_tpu_torch.train.optim import adamw, clip_by_global_norm, set_lr, warmup_cosine

CLIP_NORM = 10.0
PRODUCERS = 4


@dataclass
class DetTrainConfig:
    data_root: str
    out_path: str = "runs_torch/detector/best.npz"
    epochs: int = 150
    batch: int = 16
    imgsz: int = 640
    max_boxes: int = 160
    patience: int = 50
    lr: float = 1e-3
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    close_mosaic: int = 10
    scale: str = "n"
    seed: int = 0
    steps_per_epoch: Optional[int] = None
    compute_dtype: str = "bfloat16"
    eval_every: int = 5
    conf_eval: float = 0.001
    # resume an interrupted run from last_<scale>.npz next to out_path
    resume: bool = False
    device: str = "cuda"


def evaluate_detector(
    params, spec, samples, imgsz, conf=0.001, iou=0.7, batch=8,
    compute_dtype=torch.float32, device="cuda",
) -> Dict[str, float]:
    """mAP of a folded parameter tree on letterboxed canvases (GT mapped into
    canvas space). Batches of ``batch`` frames (the last padded with zero
    frames) go through the forward, the box decode and ``nms_batch``: one
    NMS-kernel launch per batch on the card."""
    dev = resolve_device(device)
    imgs, tgts, tmask, _ = data_lib.make_eval_batch(samples, imgsz)
    model = yolov8.load_jax_params(yolov8.build_model(spec, compute_dtype), params).to(dev).eval()
    preds = []
    with torch.inference_mode():
        for i in range(0, len(imgs), batch):
            n = len(imgs[i : i + batch])
            xb = np.zeros((batch,) + imgs.shape[1:], imgs.dtype)
            xb[:n] = imgs[i : i + batch]
            raw = model(torch.from_numpy(xb).to(dev))
            boxes, scores = yolov8.decode_boxes(raw, (imgsz, imgsz), spec.strides)
            det = nms_batch(boxes, scores, conf_thres=conf, iou_thres=iou, pre_nms=512, max_det=300)
            det = [t.cpu().numpy() for t in det]
            for j in range(n):
                c = int(det[3][j])
                preds.append({"boxes": det[0][j, :c], "scores": det[1][j, :c],
                              "classes": det[2][j, :c]})
    gts = [{"boxes": tgts[bi, tmask[bi], 1:], "classes": tgts[bi, tmask[bi], 0].astype(int)}
           for bi in range(len(imgs))]
    return mean_average_precision(preds, gts)


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """The inverse of ``tree_leaves`` on the structure of ``like``."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rec(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)

    return rec(like)


def _moment_model(model, opt, key: Optional[str]):
    """A copy of ``model`` whose parameters hold AdamW's ``key`` moment (zeros
    where there is none yet) and whose BN statistics are zero, as optax's
    moments of the never-differentiated BN statistics are."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            st = opt.state.get(p, {})
            q.copy_(st[key] if key in st else torch.zeros_like(p))
        for name, b in twin.named_buffers():
            if not name.endswith("num_batches_tracked"):
                b.zero_()
    return twin


def opt_leaves(model, opt) -> List[np.ndarray]:
    """AdamW's state as ``jax.tree_util.tree_leaves`` of the JAX trainer's
    ``optax.chain(clip_by_global_norm, adamw)`` state."""
    count = 0
    for st in opt.state.values():
        count = int(st["step"])
        break
    c = np.asarray(count, np.int32)
    mu = tree_leaves(yolov8.export_params(_moment_model(model, opt, "exp_avg")))
    nu = tree_leaves(yolov8.export_params(_moment_model(model, opt, "exp_avg_sq")))
    return [c, *mu, *nu, c]


def load_opt_leaves(model, opt, leaves: List[np.ndarray]) -> None:
    """Restore ``opt_leaves`` into a fresh AdamW over ``model``'s parameters."""
    like = yolov8.export_params(model)
    n = len(tree_leaves(like))
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {2 * n + 2}")
    count = int(np.asarray(leaves[0]))
    twins = []
    for part in (leaves[1 : 1 + n], leaves[1 + n : 1 + 2 * n]):
        twin = copy.deepcopy(model)
        yolov8.load_jax_params(twin, tree_unflatten(like, list(part)))
        twins.append(list(twin.parameters()))
    for p, m, v in zip(model.parameters(), *twins):
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m.detach().clone(),
                        "exp_avg_sq": v.detach().clone()}


def detect_step(model, ema, opt, x, t, m, step: int, lr: float):
    """One update in the JAX trainer's order: loss and gradients (BN
    statistics updated by the forward), global-norm clip, AdamW, EMA."""
    set_lr(opt, lr)
    with precision_for(model.compute_dtype):  # TF32 off in the backward too
        loss, aux = detection_loss(model, x, t, m)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    clip_by_global_norm([p.grad for p in model.parameters()], CLIP_NORM)
    opt.step()
    ema_update(ema_tensors(ema), ema_tensors(model), step)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


class _Producers:
    """Host threads building augmented batches into a bounded queue. A
    failure in a thread is handed to the consumer, which raises it."""

    def __init__(self, cfg: DetTrainConfig, samples):
        self.q: "queue_mod.Queue" = queue_mod.Queue(maxsize=4)
        self.stop_flag = threading.Event()
        self.mosaic = threading.Event()
        self.mosaic.set()
        self.build_ms: List[float] = []
        self.threads = [threading.Thread(target=self._run, args=(cfg, samples, i), daemon=True)
                        for i in range(PRODUCERS)]
        for th in self.threads:
            th.start()

    def _run(self, cfg, samples, idx):
        # distinct stream per thread, else all producers emit identical batches
        prng = np.random.default_rng(cfg.seed + 1 + idx)
        while not self.stop_flag.is_set():
            t0 = time.perf_counter()
            try:
                item = data_lib.make_detect_batch(prng, samples, cfg.batch, cfg.imgsz,
                                                  cfg.max_boxes, mosaic=self.mosaic.is_set())
                self.build_ms.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # handed to the consumer, which raises it
                item = e
            while not self.stop_flag.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
            if isinstance(item, Exception):
                return

    def get(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise RuntimeError("a batch producer failed") from item
        return item

    def stop(self):
        self.stop_flag.set()
        for th in self.threads:
            th.join(timeout=60)


def train_detector(cfg: DetTrainConfig, log=print) -> Dict[str, Any]:
    dev = resolve_device(cfg.device)
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    # pre-downscale to ~1.5x the train canvas: mosaic sources never need more
    train_samples = data_lib.load_yolo_split(cfg.data_root, "train", max_side=cfg.imgsz * 3 // 2)
    val_samples = data_lib.load_yolo_split(cfg.data_root, "valid")
    names = data_lib.load_yolo_names(cfg.data_root)
    nc = len(names)
    log(f"train {len(train_samples)} imgs, valid {len(val_samples)} imgs, {nc} classes")

    spec = yolov8.build_spec("detect", cfg.scale, nc)
    model = yolov8.build_model(spec, cdt, train=True)
    yolov8.load_jax_params(model, yolov8.init_params(torch.Generator().manual_seed(cfg.seed), spec))
    model.to(dev)
    ema = copy.deepcopy(model)

    steps_per_epoch = cfg.steps_per_epoch or max(1, len(train_samples) // cfg.batch)
    total_steps = steps_per_epoch * cfg.epochs
    warmup = min(int(cfg.warmup_epochs * steps_per_epoch), max(total_steps // 3, 1))
    sched = warmup_cosine(cfg.lr * 0.01, cfg.lr, warmup, total_steps, cfg.lr * 0.01)
    opt = adamw(model.parameters(), cfg.weight_decay)

    last_path = os.path.join(os.path.dirname(os.path.abspath(cfg.out_path)), f"last_{cfg.scale}.npz")
    start_epoch, step = 0, 0
    best_map, best_epoch = -1.0, -1
    if cfg.resume and os.path.exists(last_path):
        ckpt, cmeta = load_params(last_path, dtype=None)
        yolov8.load_jax_params(model, ckpt["params"])
        yolov8.load_jax_params(ema, ckpt["ema"])
        load_opt_leaves(model, opt, ckpt["opt"])
        start_epoch = int(cmeta["epoch"])
        step = int(cmeta["step"])
        best_map = float(cmeta["best_map"])
        best_epoch = int(cmeta["best_epoch"])
        log(f"resumed from {last_path}: epoch {start_epoch}, step {step}, "
            f"best map50 {best_map:.4f} @ {best_epoch+1}")
    model.train()
    ema.eval()
    spec_meta = {"variant": "detect", "scale": cfg.scale, "nc": nc}
    names_meta = {int(k): v for k, v in names.items()}

    def save_last(epoch_done: int):
        # full precision: f16 would corrupt the Adam moments
        save_params(last_path, {"params": yolov8.export_params(model),
                                "ema": yolov8.export_params(ema),
                                "opt": opt_leaves(model, opt)},
                    meta={"epoch": epoch_done, "step": step, "best_map": best_map,
                          "best_epoch": best_epoch, "spec": spec_meta, "names": names_meta},
                    dtype=None)

    producers = _Producers(cfg, train_samples)
    t0 = time.time()
    history = []
    try:
        for epoch in range(start_epoch, cfg.epochs):
            if epoch < cfg.epochs - cfg.close_mosaic:
                producers.mosaic.set()
            else:
                producers.mosaic.clear()
            ep = {"loss": 0.0, "box": 0.0, "cls": 0.0, "dfl": 0.0}
            step_ms, wait_ms = [], []
            for _ in range(steps_per_epoch):
                tw = time.perf_counter()
                x, t, m = producers.get()
                ts = time.perf_counter()
                loss, aux = detect_step(model, ema, opt, torch.from_numpy(x).to(dev),
                                        torch.from_numpy(t).to(dev), torch.from_numpy(m).to(dev),
                                        step, sched(step))
                step += 1
                ep["loss"] += float(loss)  # waits for the device
                for k in ("box", "cls", "dfl"):
                    ep[k] += float(aux[k])
                step_ms.append((time.perf_counter() - ts) * 1e3)
                wait_ms.append((ts - tw) * 1e3)
            for k in ep:
                ep[k] /= steps_per_epoch
            line = (f"epoch {epoch+1}/{cfg.epochs} loss {ep['loss']:.3f} "
                    f"(box {ep['box']:.3f} cls {ep['cls']:.3f} dfl {ep['dfl']:.3f})")
            if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1:
                m50 = evaluate_detector(
                    yolov8.fold_params(yolov8.export_params(ema), spec), spec, val_samples,
                    cfg.imgsz, cfg.conf_eval, compute_dtype=cdt, device=dev,
                )
                line += f" map50 {m50['map50']:.4f} map50-95 {m50['map50_95']:.4f}"
                history.append({"epoch": epoch + 1, **ep, **m50,
                                "step_ms": statistics.median(step_ms),
                                "wait_ms": statistics.median(wait_ms),
                                "build_ms": statistics.median(producers.build_ms)})
                if m50["map50"] > best_map:
                    best_map, best_epoch = m50["map50"], epoch
                    save_params(cfg.out_path, yolov8.export_params(ema),
                                meta={"names": names_meta, "spec": spec_meta,
                                      "map50": m50["map50"], "map50_95": m50["map50_95"],
                                      "epoch": epoch + 1, "imgsz": cfg.imgsz})
                if epoch - best_epoch >= cfg.patience:
                    log(line)
                    log(f"early stop (best map50 {best_map:.4f} @ epoch {best_epoch+1})")
                    save_last(epoch + 1)
                    break
            save_last(epoch + 1)
            log(line + f" ({time.time()-t0:.0f}s)")
    finally:
        producers.stop()
    # artifacts next to the checkpoint (args + per-eval metrics)
    run_dir = os.path.dirname(os.path.abspath(cfg.out_path))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, f"args_{cfg.scale}.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    with open(os.path.join(run_dir, f"results_{cfg.scale}.csv"), "w") as f:
        f.write("epoch,loss,box,cls,dfl,map50,map50_95\n")
        for h in history:
            f.write(f"{h['epoch']},{h['loss']:.5f},{h['box']:.5f},{h['cls']:.5f},"
                    f"{h['dfl']:.5f},{h['map50']:.5f},{h['map50_95']:.5f}\n")
    return {
        "best_map50": best_map,
        "best_epoch": best_epoch + 1,
        "wall_s": time.time() - t0,
        "history": history,
    }
