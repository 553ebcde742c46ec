"""Run the PyTorch port's single-screenshot path on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

  1. print the card's name and power limit (nvidia-smi);
  2. build the greedy-NMS kernel (csrc/nms_keep.cu) with nvcc and print the
     compiler's register / shared-memory report;
  3. hold the kernel against its plain PyTorch version on the card, bit for
     bit: K=512 at B=1 and B=4 on seeded boxes with class offsets, the empty
     case, and the candidates decoded from docs/examples/poker_labeled.png;
  4. with the launch counter at 0, drive the main path at full width
     (YOLOv8s detector in bf16, yolov8n-cls in f32): process_screenshot on
     the PNG and process_frame on a seeded 1200x1920 frame; read the counter;
  5. run the same calls on the CPU in f32 and compare: the same class list,
     boxes within 5 px, the same rank text (the tolerance of
     tests/test_golden_e2e.py), the same result JSON but for its time field
     and button centers within 5 px;
  6. fail if the kernel was not launched by the main path;
  7. time the kernel at the main path's K=512 (its device time from a
     torch.profiler trace, and the wrapper's time per call with CUDA events)
     and its plain version, the frame latency with the host clock, and the
     frame's device time by kernel; print them and a JSON line listing every
     kernel with its bound;
  8. print the device line last.

Without a card (``torch.cuda.is_available()`` false) it exits 1 before any
result is printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import manual_yolo_tpu_torch
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops import nms_kernel
from manual_yolo_tpu_torch.ops.letterbox import letterbox
from manual_yolo_tpu_torch.runtime.shot import (
    imread_bgr, load_fused_pipeline, process_screenshot,
)

REPO = os.path.dirname(os.path.abspath(__file__))
DETECTOR = os.path.join(REPO, "weights", "poker_detector.npz")
CLASSIFIER = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
CONF, IOU, IMGSZ, K = 0.5, 0.7, 640, 512
BOX_TOL_PX = 5

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
AREA_OPS = 5  # 2 sub, 2 max, 1 mul per candidate
PAIR_OPS = 14  # 4 max/min, 2 sub, 2 max, 1 mul, add, sub, add, div, compare


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def random_candidates(rng, b: int, n_valid, clustered: bool):
    """Score-descending (B, K, 4) boxes with class offsets, and a valid prefix."""
    if clustered:  # few centers -> heavy overlap, many suppressions
        centers = rng.uniform(50, 600, (8, 2))[rng.integers(0, 8, (b, K))]
        xy = centers + rng.normal(0, 6, (b, K, 2))
    else:
        xy = rng.uniform(0, 600, (b, K, 2))
    wh = rng.uniform(10, 90, (b, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = rng.integers(0, 4, (b, K)).astype(np.float32)
    boxes = boxes + cls[..., None] * np.float32(nms_ops.MAX_WH)
    valid = np.arange(K)[None, :] < np.asarray(n_valid)[:, None]
    return boxes, valid


def image_candidates(pipeline, frame_bgr: np.ndarray) -> nms_ops.Candidates:
    """The main path's NMS input for one frame, computed on the card."""
    with torch.inference_mode():
        rgb = torch.from_numpy(frame_bgr).to(pipeline.device).flip(-1)
        canvas, _, _ = letterbox(rgb, (IMGSZ, IMGSZ))
        raw = pipeline.det_model(canvas[None])
        boxes, scores = yolov8.decode_boxes(raw, (IMGSZ, IMGSZ), pipeline.det_model.spec.strides)
        return nms_ops.nms_candidates(boxes[0], scores[0], conf_thres=CONF, pre_nms=K)


def compare_dets(tag: str, got, ref) -> None:
    order = lambda d: (d["class_id"], d["bbox"][0], d["bbox"][1])
    got, ref = sorted(got, key=order), sorted(ref, key=order)
    if [d["class_name"] for d in got] != [d["class_name"] for d in ref]:
        fail(f"{tag}: class lists differ:\n{[d['class_name'] for d in got]}\n"
             f"{[d['class_name'] for d in ref]}")
    for d, r in zip(got, ref):
        err = int(np.abs(np.asarray(d["bbox"]) - np.asarray(r["bbox"])).max())
        if err > BOX_TOL_PX:
            fail(f"{tag}: {d['class_name']} box {d['bbox']} vs {r['bbox']}")
        if r["class_name"].endswith("_rank") and d["ocr_text"] != r["ocr_text"]:
            fail(f"{tag}: {d['class_name']} reads {d['ocr_text']!r}, CPU f32 {r['ocr_text']!r}")


def compare_results(got: dict, ref: dict) -> None:
    got, ref = dict(got), dict(ref)
    got.pop("time"), ref.pop("time")
    gb, rb = got.pop("buttons"), ref.pop("buttons")
    if got != ref:
        fail(f"result JSON differs:\n{got}\n{ref}")
    if [b["button"] for b in gb] != [b["button"] for b in rb]:
        fail(f"buttons differ: {gb} vs {rb}")
    for g, r in zip(gb, rb):
        if np.abs(np.asarray(g["center"]) - np.asarray(r["center"])).max() > BOX_TOL_PX:
            fail(f"button {g['button']} center {g['center']} vs {r['center']}")


def cuda_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps: int):
    """(wall ms of ``reps`` calls, [(name, device us)] of every device event)
    from torch.profiler's CUDA trace; [] if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
    return wall_ms, events


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(manual_yolo_tpu_torch.__file__)))
    if pkg != REPO:
        fail(f"manual_yolo_tpu_torch was imported from {pkg}, not from this checkout {REPO}")
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib_path, ptxas = nms_kernel.build()
    print(f"built {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # 3. kernel vs plain, bit for bit
    gpu = load_fused_pipeline(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=CONF, iou=IOU,
                              compute_dtype="bfloat16", device=dev)
    frame_img = imread_bgr(IMAGE)
    rng = np.random.default_rng(0)
    cases = {
        "random_b1": random_candidates(rng, 1, [300], clustered=False),
        "clustered_b4": random_candidates(rng, 4, [0, 77, 300, K], clustered=True),
        "empty": (np.zeros((1, K, 4), np.float32), np.zeros((1, K), bool)),
    }
    cand = image_candidates(gpu, frame_img)
    real = (cand.nms_boxes[None].contiguous(), cand.valid[None].contiguous())
    mismatches, max_abs_err = 0, 0.0
    for name, (boxes, valid) in {**cases, "poker_labeled": real}.items():
        boxes = torch.as_tensor(boxes, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        got = nms_kernel.nms_keep(boxes, valid, IOU)
        ref = nms_kernel.nms_keep_plain(boxes, valid, IOU)
        torch.cuda.synchronize()
        diff = (got.int() - ref.int()).abs()
        mismatches += int(diff.sum())
        max_abs_err = max(max_abs_err, float(diff.max()) if diff.numel() else 0.0)
        print(f"nms_keep {name}: B={boxes.shape[0]} K={boxes.shape[1]} "
              f"valid={int(valid.sum())} kept={int(got.sum())} mismatches={int(diff.sum())}")
    if mismatches:
        fail(f"kernel and plain keep masks differ in {mismatches} entries")

    # 4. the main path on the card, counted
    frame_rand = np.random.default_rng(0).integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        nms_kernel.nms_keep.launches = 0
        res_gpu = process_screenshot(gpu, IMAGE, os.path.join(tmp, "gpu.json"))
        dets_gpu_rand = gpu.process_frame(frame_rand)
        torch.cuda.synchronize()
        launches = nms_kernel.nms_keep.launches
        dets_gpu_img = gpu.process_frame(frame_img)

        # 5. the same on the CPU in f32
        cpu = load_fused_pipeline(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=CONF, iou=IOU,
                                  compute_dtype="float32", device="cpu")
        res_cpu = process_screenshot(cpu, IMAGE, os.path.join(tmp, "cpu.json"))
        with open(os.path.join(tmp, "gpu.json")) as f:
            if json.load(f) != res_gpu:
                fail("poker_result.json on disk differs from the returned result")
    dets_cpu_img = cpu.process_frame(frame_img)
    dets_cpu_rand = cpu.process_frame(frame_rand)
    compare_dets("poker_labeled", dets_gpu_img, dets_cpu_img)
    compare_dets("seeded 1200x1920", dets_gpu_rand, dets_cpu_rand)
    compare_results(res_gpu, res_cpu)
    print(f"main path: poker_labeled {len(dets_gpu_img)} detections "
          f"({sum(bool(d['ocr_text']) for d in dets_gpu_img)} ranks read), "
          f"seeded frame {len(dets_gpu_rand)}; matches CPU f32")
    print("result:", json.dumps({k: v for k, v in res_gpu.items() if k != "time"}))

    # 6. the main path went through the kernel
    if launches < 2:
        fail(f"nms_keep launched {launches} times on the main path, expected 2")

    # 7. timings at the main path's shapes
    kboxes, kvalid = real
    call = lambda: nms_kernel.nms_keep(kboxes, kvalid, IOU)
    call_ms = cuda_ms(call, reps=200, warmup=20)  # bounded by the host's enqueue
    _, events = device_events(call, reps=50)
    kernel_us = [us for name, us in events if "nms_keep_kernel" in name]
    ms = sum(kernel_us) / len(kernel_us) / 1e3 if kernel_us else call_ms
    plain_ms = cuda_ms(lambda: nms_kernel.nms_keep_plain(kboxes, kvalid, IOU), reps=5, warmup=1)
    keep = nms_kernel.nms_keep_plain(kboxes, kvalid, IOU)[0].cpu().numpy()
    n_valid = int(kvalid.sum())
    pairs = int(sum(keep[:i].sum() for i in range(n_valid)))  # kept j < i, as the kernel tests
    bytes_moved = kboxes.numel() * 4 + kvalid.numel() + keep.size
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (K * AREA_OPS + pairs * PAIR_OPS) / F32_OPS_PER_S * 1e3
    frame_ms = []
    for _ in range(3):
        gpu.process_frame(frame_img)
    for _ in range(10):
        t0 = time.perf_counter()
        gpu.process_frame(frame_img)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"frame_ms": {"median": statistics.median(frame_ms), "min": min(frame_ms),
                                   "shape": list(frame_img.shape), "n_valid": n_valid,
                                   "tested_pairs": pairs}}))
    wall_ms, events = device_events(lambda: gpu.process_frame(frame_img), reps=5)
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / 5
    busy_ms = sum(by_name.values())
    print(json.dumps({"frame_profile": {
        "wall_ms_per_frame": wall_ms / 5, "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1 - busy_ms / (wall_ms / 5) if events else None,
        "device_events_per_frame": len(events) / 5,
        "top": sorted(([n[:80], t] for n, t in by_name.items()), key=lambda x: -x[1])[:8],
    }}))
    print(json.dumps({"nms_keep_timing": {
        "kernel_ms": ms, "source": "torch.profiler" if kernel_us else "cuda_events",
        "wrapper_call_ms": call_ms, "plain_ms": plain_ms}}))
    print(json.dumps({"kernels": [{
        "name": "nms_keep",
        "route": "cuda",
        "source": "manual_yolo_tpu_torch/csrc/nms_keep.cu",
        "replaces": "manual_yolo_tpu/ops/pallas_nms.py:36",
        "launches": launches,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))

    # 8. the device line
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
