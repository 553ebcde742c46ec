"""Run the PyTorch port's paths on one CUDA card, and check them: the
single-screenshot path, the live loop, the hand session, multi-table
serving, serving's delta codec, training, the reference's own file
formats (JPEG screenshots, an ultralytics .pt classifier), what the
screenshot and live CLIs write (the annotated image, JPEG files, the
vision-LLM request, unlabelled rank crops), OCR and re-id embedder
training, the parallel paths, the tooling and the one-call frame program
(``manual_yolo_tpu_torch/entry.py``).

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

  1. print the card's name and power limit (nvidia-smi);
  2. build the greedy-NMS kernel (csrc/nms_keep.cu) with nvcc and print the
     compiler's register / shared-memory report;
  3. build the host C++ library (csrc/host.cpp) with g++ and hold it against
     its plain twins: ctc_beam and ctc_score_multi on seeded log-probs, and the
     PNG row unfilter on the committed example and on a Paeth re-encode of it
     written here with zlib; time both PNG reads; decode every committed JPEG
     fixture (tests/torch_jpeg/: the example at each chroma sampling,
     progressive, with restarts, and a 1200x1920 frame) to the bytes
     cv2.imread gives (the SHA-256 in tests/torch_jpeg/cv2_decode.json, as
     this host has no cv2), and time each decode against png.imread_bgr of
     the same frame as a PNG (``jpeg_decode``);
  4. hold the kernel against its plain PyTorch version on the card, bit for
     bit: K=512 at B=1 and B=4 on seeded boxes with class offsets, the empty
     case, all 512 candidates valid and clustered (full_chain), 16 seeded
     frames of 0 to 512 valid candidates (mixed_b16), and the candidates
     decoded from docs/examples/poker_labeled.png, alone and repeated 4 and
     16 times (batch4, batch16);
  5. OCR: build the default OCR engine (three CRNNs and CRAFT) on the card and
     on the CPU; read every OCR-class crop of the example (boxes of the CPU f32
     pipeline at conf 0.25, and the game id box the example's annotation
     draws) with read_fields_conf on both, and a two-line villain panel with
     read_region on both: the same texts and boxes, confidences within 1e-3,
     no caught error;
  6. with the launch counter at 0, drive the main path at full width, as the
     CLI does (YOLOv8s detector in bf16, yolov8n-cls in f32, OCR on):
     process_screenshot on the PNG, and process_frame on a seeded 1200x1920
     frame; read the counter;
  7. run the same calls on the CPU in f32 and compare: the same class list,
     boxes within 5 px, the same rank text (the tolerance of
     tests/test_golden_e2e.py), the same result JSON but for its time field,
     button centers within 5 px and the OCR fields of boxes that moved (a
     moved box is another crop; those reads are printed); and the screenshot
     with OCR on the card with the f32 detector: the CPU's result exactly;
  8. fail if the kernel was not launched by the main path;
  9. the live loop, as cli/detect.py builds it (YOLOv8s bf16 at imgsz 640,
     conf 0.25, the rank classifier, OCR on): with the launch counter at 0,
     20 frames (the example and copies shifted by a few pixels) through
     LiveLoop.step; one launch per frame, no caught error; the time per step
     (``live_ms``) and the stage stats; then the first 5 frames in f32 on
     the card and on the CPU: the same detections.jsonl rows less
     timestamps and the same game JSON (box corners within 1 px, printed
     where they differ);
 10. the hand session, as cli/pipe.py builds it (YOLOv8s bf16 at imgsz 1280,
     conf 0.35, 640-px tiles at 0.2, DeepSORT with weights/reid_embedder.npz,
     OCR on): with the launch counter at 0, 8 steps on a seeded 1200x1920
     frame (12 tiles) and 8 on the example; every tiled batch is one launch;
     the time per step (``hands_ms``), tiles and launches per step, stage
     stats, and one torch.profiler trace of a tiled step (``hands_profile``);
     the kernel against its plain version on the 12 tiles' candidates
     (tiles12); then 3 steps of each in f32 on the card and on the CPU: the
     same track ids, classes and buttons at every step, boxes within 1 px;
 11. serving, as cli/serve.py runs it: with the launch counter at 0, a
     BatchStream of 16 tables (YOLOv8s bf16 at 640, conf 0.25, OCR off) over
     48 ticks of the table-sim fleet (the example at 1920x1200, per table and
     tick a repaint at 0.08 and a photometric shift at 0.02), the first 8 a
     warm-up: one launch per tick; the loop step (``serve_ms``), frames per
     second, modes, memo hits, readback overflows and stage stats; one trace
     of 4 steady ticks (``serve_profile``); the kernel against its plain
     version on the last tick's 16 frames (serve16); 4 tables over 6 ticks in
     f32 on the card and on the CPU (``serve_f32_vs_cpu``): the same modes
     and classes, box corners within 1 px, confidences within 0.002, the
     card's texts equal to the CPU's host tail run on the card's readbacks
     and the f32 rank probabilities within 1e-5 (and, as a control, how far
     a TF32 classifier misses); bf16 tick 0 (``serve_bf16_tick0``, conf 0.5)
     under the golden tolerance (boxes within 5 px; confidences within, and
     class lists equal but for detections within, the margin of the gate
     measured in tests/torch_serve_cases.py), its rank texts equal to the
     JAX package's bf16 on that tick (tests/torch_serve_golden.json) and to
     the CPU's f32 but where the JAX package's own bf16 and f32 read a card
     differently in the same way, and to the CPU's host tail on the card's
     readback; StreamingEngine over 20 frames, counted (``streaming_ms``),
     and 6 frames in f32 on the card and the CPU (rank texts equal where
     the box is the same, those of moved boxes printed); cli.serve --ocr
     over 4 tables and 8 ticks, and a FieldOCRMemo pass on the card: exit 0,
     no caught error;
 12. serving's delta codec: 16 tables (YOLOv8s bf16 at 640, conf 0.25, OCR
     off), every table changing every tick as bench.py's jittered stream
     does (a global jitter within [-6, 6] per channel after a persisting
     local repaint): the first tick, 24 jittered ticks (segs with the fused
     classify), per-pixel noise within +-3 (tribit), table 0 at another
     letterbox geometry (raw) and noise within +-7 there (nibble); with the
     launch counter at 0, cli/serve.py's loop over them (one launch per
     tick, the planned mode on each), then the same with delta=False:
     upload MB per tick against raw_active's, submit_encode, submit_crops
     and dispatch p50, the loop step, fused hits and misses, and a trace of
     4 jittered ticks each (``codec_ms``, ``codec_profile``); each tick alone
     in bf16 and in f32 with the resident canvas and predicted crop plane
     held byte for byte against the host's after every tick, the results
     equal to delta=False's (every detection; every rank text but where the
     fused classify took a near-miss prediction's row, listed); one trace of
     the decode of one segs, tribit and nibble payload: launches and device
     ms per tick (``codec_decode``, ``codec_checks``);
 13. training, through the CLIs: data/rank_matched.npz written as a PNG
     folder dataset (1536 train, 67 valid crops); the warm start
     (weights/rank_classifier_matched.npz) read by the trainer's evaluate
     must give 64/67; cli.train_cls warm-started, 2 epochs at batch 64
     (``train_cls``: step and batch-build medians, crops/s, losses, top-1;
     the best checkpoint through load_params and RankClassifier); a YOLO
     dataset of PNGs (the example and the seeded frame, shifted: 16 train,
     4 valid; labels the f32 detections of poker_detector_n at conf 0.25;
     the taxonomy's 64 names in data.yaml); with the launch counter at 0,
     cli.train_det (YOLOv8n, imgsz 640, batch 16, bf16) for 2 epochs of 4
     steps with an eval each, then resumed to a third (``train_det``: step,
     batch wait and batch build medians, images/s, losses, mAP, one launch
     per eval batch of 8); one profiled train step (``train_step_profile``);
     three f32 steps of each model on the card and the CPU
     (``train_f32_vs_cpu``, tolerances at TRAIN_LR below), and the
     detector's first f32 gradients four ways, the card with and without
     cuDNN and the CPU in f32 and f64, with SPPF's ties
     (``detector_grad0_four_ways``); cli.eval_det of
     poker_detector_n on the valid split on the card (counted) and the CPU,
     mAP within 1e-3 (``eval_det``); the kernel bit for bit on both eval
     batches (eval8: the trainer's first; eval8_det_n: cli.eval_det's);
 14. the reference's formats: a .pt written by tests/torch_pt_cases.py from
     weights/rank_classifier_matched.npz (fp16 tensors, an ema entry) loads
     on the card; classify_crops on the example's rank crops equals the
     CPU's names, confidences within 1e-5, and the .pt logits equal the .npz
     classifier's (``pt_classifier``); with the launch counter at 0,
     cli.shot on the JPEG example with the .pt classifier: one launch, and
     the result JSON of cli.shot on the same decoded pixels as a PNG with the
     .npz classifier, the time field aside (``jpeg_shot``);
     build_matched_rank_dataset on a YOLO set of the JPEG fixtures (labels
     and rank crop names written here) equal on the card and the CPU
     (``matched_crops``);
 15. what the CLIs write: with the launch counter at 0, cli.shot on the
     example with its default --output-image in a scratch directory: one
     launch, poker_labeled.png read back equal to runtime/draw.py's
     annotate() of the run's detections and to the input outside the drawn
     boxes and labels; again with --output-image x.jpg (one launch, the
     file encode_jpeg of the annotation); the wall time the image adds to
     the screenshot with OCR (``annotated_shot``); encode_jpeg of the
     example and the seeded frame at 95 and 85 and a gray crop at 50 to the
     SHA-256 of cv2.imencode's bytes in tests/torch_jpeg/cv2_encode.json,
     each timed against png.write_png (``jpeg_encode``); a screenshot with
     use_llm_fallback=True, no OCR and urllib.request.urlopen stubbed (no
     network): one request, its image encode_jpeg of the collage at 85, the
     stub's answer validated into each escalated field, one launch
     (``llm_fallback``); LiveLoop(save_screenshots=True,
     screenshot_interval=0) over 4 frames: one launch and one .jpg a frame,
     each encode_jpeg of its frame and read back by the port's reader
     (``live_screenshots``); cli.unlabel on the training phase's YOLO
     dataset: a crop per rank label, each encode_jpeg of its slice
     (``unlabel``);
 16. the one-call frame program: with the launch counter at 0, entry()'s
     fn (YOLOv8n and yolov8n-cls in bf16, weights/poker_detector_n.npz and
     rank_classifier_matched.npz) on its seeded 1200x1920 frame and on the
     example scaled to 1200x1920: one launch a call, the keep masks bit for
     bit against the plain version, each against the CPU's f32 run of the
     same program (the same count and class list, boxes within 5 px, scores
     within the golden margin, the same eight rank rows, the same rank
     argmax on the same crops and on every own row whose box lies within
     0.1 px); the call's and the detector forward's median and min ms,
     flops_per_image and the TFLOP/s they give (``entry``);
 17. time the kernel's device time from a torch.profiler trace at
     poker_labeled, full_chain, batch4, batch16, tiles12, the example's 6
     tiles (tiles6_poker_labeled), serve16, eval8 and eval8_det_n (each shape's launches
     inside a record_function range; a range without all of its kernel
     events fails), each beside its bound; the wrapper's time per call with
     CUDA events and the plain version at the main path's shape; the frame
     latency and the screenshot latency with OCR with the host clock, the
     frame's device time by kernel, and one trace of the screenshot with OCR
     (device busy and idle share, the OCR pass's share, recognizer calls per
     kind, the host time of the beam and rescore); print them, and after
     21 a JSON line listing every kernel with its bound and its launches on
     each path;
 18. OCR training and evaluation: cli.train_ocr at the CLI's widths (CRNN
     hidden 256, width 256, img_h 32, batch 64, f32; the pool cut to 2048
     renders, 120 steps, an eval every 40): the pool's host ms per sample,
     the step and samples/s after the first eval, the CTC loss and exact
     match at each eval, one profiled step (``train_ocr``); the checkpoint
     equal to the saved model in f16, through load_params and an OCREngine
     reading the example's fields; cli.train_craft at its defaults (256x256,
     batch 8, bf16; 256 scenes, 40 steps, an eval every 20): step ms, MSE
     and line F1 per eval, the running statistics moved, read_region of the
     villain panel with the checkpoint, one profiled step
     (``train_craft``); three f32 steps of each card against CPU from the
     same parameters and batches (``train_ocr_f32_vs_cpu``,
     ``train_craft_f32_vs_cpu``, batches 16 and 2, tolerances at
     OCR_LOSS0_RTOL below);
     cli.eval_ocr and cli.eval_craft on a stand-in labelled set written here
     (the example as a JPEG under four split stems, labels of poker_detector_n,
     labels.json in data/ocr_real's schema): the card's rows and scores equal
     the CPU's, confidences within 1e-3, times printed (``eval_ocr``,
     ``eval_craft``); these phases reach no NMS kernel, and run after the
     timings, whose kernel trace they would cost events;
 19. the re-id embedder trainer: cli.train_embedder at its widths
     (yolov8n-cls, imgsz 64, batch 48 instances = 96 views, f32, warm-started
     from weights/rank_classifier_matched.npz) for 2 epochs on the training
     phase's YOLO dataset: step ms, views/s, the host view sampler's ms per
     batch and its share, losses, the pre-train and final auc_all and
     auc_same_class; the checkpoint's meta, and its unit vectors through
     AppearanceEmbedder on the card and the CPU within 1e-4; one f32
     embed_step from the warm start card against CPU, by the classifier's
     first-step rule (``train_embedder``);
 20. the parallel paths over a one-rank NCCL group: with the launch counter
     at 0, ShardedDetector (YOLOv8s bf16 at 640, conf 0.25) on the 16
     frames of a serving tick: one launch, the detections of
     DetectorEngine.detect_batch bit for bit, the kernel against
     its plain version on that batch (sharded16), both timed; the
     data-parallel step at train_det's widths (YOLOv8n, 640, batch 16, bf16,
     clip 10) against detect_step for 2 steps (first loss within 1e-5, the
     weights by TRAIN_LR's card rule); parallel/dryrun.py with 4 gloo
     processes on this host's CPU, its checks passing (``parallel``). One
     card shows no multi-rank NCCL run;
 21. the tooling: cli.smoke exits 0 and names the card, profiling.trace
     (run in a process of its own) writes a Chrome trace holding a CUDA
     kernel event, and
     device_memory_stats reads the card's memory (``tooling``);
 22. print the device line last.

Without a card (``torch.cuda.is_available()`` false) it exits 1 before any
result is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import manual_yolo_tpu_torch
from manual_yolo_tpu_torch.core.device import full_f32
from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import ctc as ctc_ops
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops import nms_kernel
from manual_yolo_tpu_torch.config import AppConfig
from manual_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_batch
from manual_yolo_tpu_torch.parallel.inference import tiled_frames
from manual_yolo_tpu_torch.runtime import draw, jpeg, llm_fallback, native, png
from manual_yolo_tpu_torch.runtime import shot as shot_mod
from manual_yolo_tpu_torch.runtime.embedder import default_embedder
from manual_yolo_tpu_torch.runtime.engine import DetectorEngine
from manual_yolo_tpu_torch.runtime.hands import HandSessionPipeline
from manual_yolo_tpu_torch.runtime.live import LiveLoop
from manual_yolo_tpu_torch.runtime.ocr import OCREngine, field_kind, default_ocr_engine
from manual_yolo_tpu_torch.runtime.fieldocr import FieldOCRMemo
from manual_yolo_tpu_torch.runtime.serving import (
    letterbox_u8_into, load_batch_stream, load_streaming_engine,
)
from manual_yolo_tpu_torch.cli import serve as serve_cli
from manual_yolo_tpu_torch.ops.image import cv_resize_u8
from manual_yolo_tpu_torch.runtime.shot import (
    _safe_crop, imread_bgr, load_fused_pipeline, process_screenshot,
)
from manual_yolo_tpu_torch.track.deepsort import DeepSortTracker

REPO = os.path.dirname(os.path.abspath(__file__))
DETECTOR = os.path.join(REPO, "weights", "poker_detector.npz")
CLASSIFIER = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
CONF, IOU, IMGSZ, K = 0.5, 0.7, 640, 512
BOX_TOL_PX = 5
OCR_CONF_TOL = 1e-3
# the detector finds no game_id on the annotated example; this is the box its
# annotation draws around "Game ID : 232025507"
GAME_ID_BOX = [850, 25, 1008, 52]
# a villain's panel, name over stack (two text lines) for read_region
PANEL_BOX = [1143, 545, 1258, 598]

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


def box_dist(d: dict, r: dict) -> int:
    return int(np.abs(np.subtract(d["bbox"], r["bbox"])).max())


def pair_dets(tag: str, got: list, ref: list, box_tol: int, margin: float = None) -> list:
    """One frame's detections paired with a reference's: each reference
    detection with the nearest one of its class (a pixel may reorder two
    boxes of a class in any sort by position), box corners within
    ``box_tol`` px, none left over. With ``margin``, a detection of either
    list whose confidence is under CONF + margin may go unpaired: it passes
    the gate in one run only. Returns [(got, ref)]."""
    left, pairs = list(got), []
    for r in ref:
        g = min((d for d in left if d["class_id"] == r["class_id"]), key=lambda d: box_dist(d, r),
                default=None)
        if g is None or box_dist(g, r) > box_tol:
            if margin is None or r["conf"] >= CONF + margin:
                fail(f"{tag}: {r['class_name']} at {r['bbox']} conf {r['conf']} has no partner "
                     f"(nearest {g})")
            continue
        left.remove(g)
        pairs.append((g, r))
    for g in left:
        if margin is None or g["conf"] >= CONF + margin:
            fail(f"{tag}: {g['class_name']} at {g['bbox']} conf {g['conf']} has no partner")
    return pairs


def compare_dets(tag: str, got, ref, box_tol: int = BOX_TOL_PX, conf_tol: float = None,
                 margin: float = None, texts: str = "rank") -> list:
    """``pair_dets``, then the paired confidences within ``conf_tol`` and the
    texts: every rank text equal ("rank"), equal where the box is the same
    ("unmoved"), or not compared ("none", held elsewhere). Returns the pairs."""
    pairs = pair_dets(tag, got, ref, box_tol, margin)
    for d, r in pairs:
        if conf_tol is not None and abs(d["conf"] - r["conf"]) > conf_tol:
            fail(f"{tag}: {d['class_name']} conf {d['conf']} vs {r['conf']}")
        if d["ocr_text"] != r["ocr_text"] and r["class_name"].endswith("_rank") and (
                texts == "rank" or (texts == "unmoved" and d["bbox"] == r["bbox"])):
            fail(f"{tag}: {d['class_name']} at {d['bbox']} reads {d['ocr_text']!r}, "
                 f"the reference {r['ocr_text']!r}")
    return pairs


def json_field(class_name: str):
    """Where the result JSON keeps an OCR-class detection's text, or None."""
    if class_name.startswith("villian") and class_name[7:8].isdigit():
        return ("villains", int(class_name[7]) - 1, class_name.split("_", 1)[1])
    if class_name in ("game_id", "my_stack", "my_bet"):
        return (class_name,)
    if class_name in ("card1_rank", "card2_rank"):
        return (class_name[:5],)
    return None


def moved_fields(got_dets, ref_dets) -> list:
    """JSON fields of OCR-class detections whose box differs between two runs:
    OCR reads a different crop there."""
    boxes = lambda dets, name: sorted(d["bbox"] for d in dets if d["class_name"] == name)  # noqa: E731
    names = {d["class_name"] for d in got_dets + ref_dets} & taxonomy.OCR_CLASSES
    return sorted({json_field(n) for n in names
                   if boxes(got_dets, n) != boxes(ref_dets, n) and json_field(n)})


def compare_results(got: dict, ref: dict, skip=()) -> list:
    """Fail unless the two results agree but for their time, button centers
    within 5 px, and the fields in ``skip``; returns [(field, got, ref)] of
    the skipped fields that differ."""
    got, ref = json.loads(json.dumps(got)), json.loads(json.dumps(ref))
    got.pop("time"), ref.pop("time")
    differ = []
    for path in skip:
        g, r = got, ref
        for key in path[:-1]:
            g, r = g[key], r[key]
        if g[path[-1]] != r[path[-1]]:
            differ.append((list(path), g[path[-1]], r[path[-1]]))
        g[path[-1]] = r[path[-1]] = None
    gb, rb = got.pop("buttons"), ref.pop("buttons")
    if got != ref:
        fail(f"result JSON differs:\n{got}\n{ref}")
    if [b["button"] for b in gb] != [b["button"] for b in rb]:
        fail(f"buttons differ: {gb} vs {rb}")
    for g, r in zip(gb, rb):
        if np.abs(np.asarray(g["center"]) - np.asarray(r["center"])).max() > BOX_TOL_PX:
            fail(f"button {g['button']} center {g['center']} vs {r['center']}")
    return differ


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


def kernel_ms(fns: dict, reps: int = 50, attempts: int = 3) -> dict:
    """{name: mean device time of the NMS kernel per launch of fns[name]}, from
    one torch.profiler trace. Each name's launches run inside a record_function
    range of their own, 20 ms apart, after ten warm-up launches of each
    outside any range; a kernel event belongs to the range that starts last before
    it, and every range must hold all ``reps`` launches. The card's host
    sometimes drops a few of the first range's kernel events: a trace that
    misses any is taken again, up to ``attempts`` times, and each miss is
    printed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the first launches after the trace starts can go unrecorded: begin
            # with other device work, ten rounds of launches of the kernel
            # outside any range (left out below) and a pause
            torch.ones(1, device="cuda").add_(1)
            for _ in range(10):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            # and a range of the first shape's launches that is not read
            with record_function("nms_keep_pad"):
                for _ in range(reps):
                    next(iter(fns.values()))()
                torch.cuda.synchronize()
            time.sleep(0.05)
            for name, fn in fns.items():
                with record_function(f"nms_keep_timed/{name}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                time.sleep(0.02)
        events = prof.events()
        ranges = sorted((e.time_range.start, e.name.split("/", 1)[1]) for e in events
                        if e.name.startswith("nms_keep_timed/")
                        and not str(e.device_type).endswith("CUDA"))
        if [name for _, name in ranges] != list(fns):
            fail(f"the profiler trace holds the ranges {ranges}, not one for each of {list(fns)}")
        spans = {name: [] for name in fns}
        for e in events:
            if str(e.device_type).endswith("CUDA") and "nms_keep_kernel" in e.name:
                # kernel and host clocks agree within microseconds; the ranges are 20 ms apart
                owner = [name for start, name in ranges if start <= e.time_range.start + 1000]
                if owner:  # else a warm-up or pad launch, before the first range
                    spans[owner[-1]].append(e.time_range.elapsed_us())
        counts = {name: len(us) for name, us in spans.items()}
        if set(counts.values()) == {reps}:
            return {name: sum(us) / reps / 1e3 for name, us in spans.items()}
        print(f"kernel_ms: trace {attempt + 1} holds {counts} nms_keep_kernel events, "
              f"not {reps} per range; tracing again")
    fail(f"{attempts} profiler traces each missed nms_keep_kernel events")


def bound(boxes: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor):
    """(bound ms, "bytes" or "operations", tested pairs) of one keep-mask call.

    Bytes: each frame's boxes up to its last valid candidate, all of valid and
    keep, each once, over HBM's rate. Operations: those boxes' areas, and the
    tests of every valid candidate against the kept ones before it, over the
    f32 rate."""
    v, kk = valid.cpu().numpy(), keep.cpu().numpy().astype(np.int64)
    k = v.shape[1]
    last = np.where(v.any(axis=1), k - np.argmax(v[:, ::-1], axis=1), 0)  # last valid + 1
    needed = int(last.sum())
    pairs = int(((np.cumsum(kk, axis=1) - kk) * v).sum())  # kept j < i, valid i
    bytes_ms = (needed * 16 + valid.numel() + keep.numel()) / HBM_BYTES_PER_S * 1e3
    ops_ms = (needed * AREA_OPS + pairs * PAIR_OPS) / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", pairs


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


def png_with_paeth_rows(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` with every row Paeth-filtered."""
    h, w, _ = rgb.shape
    cur = rgb.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int16), cur[:, :-3]], axis=1)
    upleft = np.concatenate([np.zeros((h, 3), np.int16), up[:, :-3]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((cur - pred) % 256).astype(np.uint8)], 1)

    def chunk(t: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def png_rows(path: str):
    """(filtered bytes, height, width, bytes per pixel) of an 8-bit RGB(A) PNG."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    width, height, depth, color = header[:4]
    if depth != 8 or color not in (2, 6):
        fail(f"{path}: expected an 8-bit RGB(A) PNG, got depth {depth} colour type {color}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw, height, width, 3 if color == 2 else 4


def host_library(tmp: str) -> dict:
    """Build csrc/host.cpp and hold it against its plain twins."""
    t0 = time.perf_counter()
    lib_path = native.build()
    build_s = time.perf_counter() - t0
    print(f"built {os.path.relpath(lib_path, REPO)} in {build_s:.1f} s")
    native.library()
    rng = np.random.default_rng(0)
    beams, scores, worst = 0, 0, 0.0
    for _ in range(8):
        logits = torch.from_numpy(rng.normal(0.0, 3.0, (64, 74)).astype(np.float32))
        logp = torch.log_softmax(logits, dim=-1).numpy()
        got, ref = ctc_ops.prefix_beam_decode(logp), ctc_ops.prefix_beam_decode_plain(logp)
        if [p for p, _ in got] != [p for p, _ in ref]:
            fail(f"ctc_beam prefixes {[p for p, _ in got]} != plain {[p for p, _ in ref]}")
        cands = [p for p, _ in ref] + [(), (1,), (5, 5, 5)]
        s_got = ctc_ops.score_candidates(logp, cands)
        s_ref = ctc_ops.score_candidates_plain(logp, cands)
        rel = float(np.max(np.abs(s_got - s_ref) / np.maximum(np.abs(s_ref), 1e-30)))
        b_rel = max(abs(g[1] - r[1]) / abs(r[1]) for g, r in zip(got, ref))
        worst = max(worst, rel, b_rel)
        beams += len(got)
        scores += len(cands)
    if worst > 1e-6:
        fail(f"ctc scores differ from the plain twins by {worst:.3g} relative")

    paeth = os.path.join(tmp, "paeth.png")
    example = imread_bgr(IMAGE)[..., ::-1]
    with open(paeth, "wb") as f:
        f.write(png_with_paeth_rows(np.ascontiguousarray(example)))
    read_ms = {}
    for name, path in (("example", IMAGE), ("paeth", paeth)):
        raw, h, w, bpp = png_rows(path)
        if not np.array_equal(native.png_unfilter(raw, h, w * bpp, bpp),
                              png._unfilter(raw, h, w, bpp).reshape(h, w * bpp)):
            fail(f"png_unfilter differs from the plain _unfilter on {name}")
        if not np.array_equal(png.read_png(path), example):
            fail(f"read_png({name}) differs from the example's pixels")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            png.read_png(path)
            times.append((time.perf_counter() - t0) * 1e3)
        read_ms[name] = statistics.median(times)
    raw, h, w, bpp = png_rows(paeth)
    t0 = time.perf_counter()
    png._unfilter(raw, h, w, bpp)
    read_ms["paeth_plain_unfilter"] = (time.perf_counter() - t0) * 1e3
    out = {"build_s": build_s, "ctc_cases": 8, "beams": beams, "scores": scores,
           "max_rel_err": worst, "read_png_ms": read_ms}
    print(json.dumps({"host_library": out}))
    return out


def ocr_crops(frame: np.ndarray, dets) -> tuple:
    """Every OCR-class crop of ``dets``, and the game id box."""
    todo = [d for d in dets if d["class_name"] in taxonomy.OCR_CLASSES]
    crops = [_safe_crop(frame, d["bbox"]) for d in todo] + [_safe_crop(frame, GAME_ID_BOX)]
    return crops, [d["class_name"] for d in todo] + ["game_id"]


def check_ocr(gpu_ocr, cpu_ocr, frame: np.ndarray, dets) -> dict:
    """read_fields_conf and read_region on the card against the CPU."""
    crops, names = ocr_crops(frame, dets)
    got = gpu_ocr.read_fields_conf(crops, names)
    ref = cpu_ocr.read_fields_conf(crops, names)
    worst = 0.0
    for name, (t, c), (rt, rc) in zip(names, got, ref):
        if t != rt:
            fail(f"OCR {name}: the card reads {t!r}, the CPU {rt!r}")
        worst = max(worst, abs(c - rc))
    if worst > OCR_CONF_TOL:
        fail(f"OCR confidences differ from the CPU's by {worst:.3g} > {OCR_CONF_TOL}")
    if gpu_ocr.errors or cpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors on the card, {cpu_ocr.errors} on the CPU")
    kinds_read = {field_kind(n) for n, (t, _) in zip(names, got) if t}
    if not ({"name", "game_id"} <= kinds_read and any(
            n.endswith("_stack") and t for n, (t, _) in zip(names, got))):
        fail(f"OCR read no name, stack or game_id: {list(zip(names, got))}")
    panel = _safe_crop(frame, PANEL_BOX)
    lines = gpu_ocr.read_region(panel)
    ref_lines = cpu_ocr.read_region(panel)
    if [(b, t) for b, t, _ in lines] != [(b, t) for b, t, _ in ref_lines] or len(lines) < 2:
        fail(f"read_region: the card gives {lines}, the CPU {ref_lines}")
    out = {"fields": [[n, t, c] for n, (t, c) in zip(names, got)], "max_conf_diff": worst,
           "panel": [[list(b), t, c] for b, t, c in lines]}
    print(json.dumps({"ocr_fields": out}))
    return out


class TimedOCR:
    """The engine, with its read_fields_conf inside a record_function range."""

    def __init__(self, engine):
        self.engine = engine

    def read_fields_conf(self, crops, names):
        from torch.profiler import record_function

        with record_function("ocr_pass"):
            return self.engine.read_fields_conf(crops, names)


def shot_profile(fn) -> dict:
    """One torch.profiler trace of ``fn`` (a screenshot with OCR): wall, device
    busy and idle share, the OCR pass's share, the top device items,
    recognizer calls per kind and the host time of the beam and rescore."""
    from torch.profiler import ProfilerActivity, profile

    from torch.profiler import record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the first launches after the trace starts can go unrecorded: begin
        # with other device work and a pause
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        with record_function("shot"):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = [e for e in events if not str(e.device_type).endswith("CUDA")]

    def one(name):
        spans = [e for e in host if e.name == name]
        if len(spans) != 1:
            fail(f"the trace holds {len(spans)} {name} ranges, not 1")
        return spans[0].time_range.start, spans[0].time_range.end

    shot_lo, shot_hi = one("shot")
    lo, hi = one("ocr_pass")
    # device events of work, not the device-side copies of record_function ranges
    ranges = {e.name for e in host}
    dev = [e for e in events if str(e.device_type).endswith("CUDA") and e.name not in ranges
           and shot_lo <= e.time_range.start <= shot_hi]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    ocr_busy = sum(e.time_range.elapsed_us() for e in dev if lo <= e.time_range.start <= hi) / 1e3
    by_name = {}
    for e in dev:
        if lo <= e.time_range.start <= hi:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    calls, recognize_ms, beam_ms, craft_ms = {}, {}, 0.0, 0.0
    for e in host:
        if e.name.startswith("ocr_recognize/"):
            kind = e.name.split("/", 1)[1]
            calls[kind] = calls.get(kind, 0) + 1
            recognize_ms[kind] = recognize_ms.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.name.startswith("ocr_beam_rescore/"):
            beam_ms += e.time_range.elapsed_us() / 1e3
        elif e.name == "ocr_craft":
            craft_ms += e.time_range.elapsed_us() / 1e3
    ocr_wall = (hi - lo) / 1e3
    if not dev:
        fail("the screenshot's trace holds no device events")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
           "ocr_pass_wall_ms": ocr_wall, "ocr_pass_device_busy_ms": ocr_busy,
           "ocr_pass_device_idle_share": 1 - ocr_busy / ocr_wall if ocr_wall else None,
           "recognizer_calls_by_kind": calls, "recognizer_host_ms_by_kind": recognize_ms,
           "beam_rescore_host_ms": beam_ms, "craft_ms": craft_ms, "device_events": len(dev),
           "ocr_pass_device_events": sum(lo <= e.time_range.start <= hi for e in dev),
           "top_ocr_device": sorted(([n[:80], t] for n, t in by_name.items()),
                                    key=lambda x: -x[1])[:8]}
    print(json.dumps({"ocr_profile": out}))
    return out


LIVE_FRAMES, LIVE_F32_FRAMES = 20, 5
HAND_STEPS, HAND_F32_STEPS = 8, 3
BOX_KEYS = frozenset({"bbox", "coordinates", "x1", "y1", "x2", "y2"})


def shifted_frames(frame: np.ndarray, n: int) -> list:
    """The frame, then copies shifted by up to 3 px, so tracks persist."""
    return [np.roll(frame, ((i % 5) - 2, (i * 3) % 7 - 3) if i else (0, 0), axis=(0, 1))
            for i in range(n)]


def compare_nested(tag: str, got, ref, path: str = "", box: bool = False, moved=None) -> list:
    """Fail unless two JSON-like results agree: box corners (under a key of
    BOX_KEYS) within 1 px, floats within 1e-3, all else equal. Returns the
    corners that differ, as [(path, got, ref)]."""
    moved = [] if moved is None else moved
    if isinstance(ref, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(ref):
            fail(f"{tag}{path}: {got} vs {ref}")
        for k in ref:
            compare_nested(tag, got[k], ref[k], f"{path}.{k}", box or k in BOX_KEYS, moved)
    elif isinstance(ref, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(ref):
            fail(f"{tag}{path}: {got} vs {ref}")
        for i, (g, r) in enumerate(zip(got, ref)):
            compare_nested(tag, g, r, f"{path}[{i}]", box, moved)
    elif isinstance(ref, (bool, str)) or ref is None:
        if got != ref:
            fail(f"{tag}{path}: {got!r} vs {ref!r}")
    elif isinstance(ref, (int, np.integer)):
        if not isinstance(got, (int, np.integer)) or abs(int(got) - int(ref)) > (1 if box else 0):
            fail(f"{tag}{path}: {got} vs {ref}")
        if got != ref:
            moved.append((path, int(got), int(ref)))
    elif abs(float(got) - float(ref)) > 1e-3:
        fail(f"{tag}{path}: {got} vs {ref}")
    return moved


def live_run(pipeline, ocr, frames, out_dir: str, interval: float = 0.5):
    """LiveLoop over ``frames`` as cli/detect.py runs it; returns (loop, ms
    per step, detections.jsonl rows less timestamps, {game file: JSON})."""
    loop = LiveLoop(pipeline=pipeline, output_dir=out_dir, ocr=ocr,
                    game_update_interval=interval)
    ms = []
    try:
        for frame in frames:
            t0 = time.perf_counter()
            loop.step(frame)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        loop.close()
    with open(os.path.join(out_dir, "detections.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        r.pop("timestamp")
    games = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("game_"):
            with open(os.path.join(out_dir, name)) as f:
                games[name] = json.load(f)
    return loop, ms, rows, games


class BatchCounter:
    """Wraps an engine's detect_batch: records (B, kernel launches) per call."""

    def __init__(self, engine):
        self.inner, self.calls = engine.detect_batch, []
        engine.detect_batch = self

    def __call__(self, frames):
        before = nms_kernel.nms_keep.launches
        out = self.inner(frames)
        self.calls.append((len(frames), nms_kernel.nms_keep.launches - before))
        return out


def hand_session(device, dtype: str, ocr, out_dir: str) -> HandSessionPipeline:
    """The hand session as cli/pipe.py builds it from the config's defaults."""
    cfg = AppConfig()
    engine = DetectorEngine.from_npz(DETECTOR, imgsz=cfg.pipe.yolo_imgsz, conf=cfg.pipe.yolo_conf,
                                     compute_dtype=dtype, device=device)
    embedder = default_embedder(cfg.track.embedder_weights, device=device)
    if embedder is None:
        fail("weights/reid_embedder.npz is missing")
    tracker = DeepSortTracker(
        max_age=cfg.pipe.deepsort_max_age, n_init=cfg.pipe.deepsort_n_init,
        max_cosine_distance=cfg.pipe.deepsort_max_cosine_distance,
        nn_budget=cfg.pipe.deepsort_nn_budget, embedder=embedder)
    return HandSessionPipeline(engine=engine, output_dir=out_dir, hand_timeout=cfg.pipe.hand_timeout,
                               tile=cfg.pipe.tile, tile_overlap=cfg.pipe.tile_overlap, ocr=ocr,
                               tracker=tracker)


def hand_steps(hp: HandSessionPipeline, frames) -> tuple:
    """Step the session over ``frames``; returns (infos, ms, tiles, launches)
    per step. A step's first detect_batch call is the full frame (B=1); a
    second is its tiles. On the card, fails unless each call was one launch."""
    counter = hp.engine.detect_batch
    infos, ms, tiles, launches = [], [], [], []
    for frame in frames:
        n_calls, before = len(counter.calls), nms_kernel.nms_keep.launches
        t0 = time.perf_counter()
        infos.append(hp.step(frame))
        ms.append((time.perf_counter() - t0) * 1e3)
        calls = counter.calls[n_calls:]
        tiles.append(sum(b for b, _ in calls[1:]))
        launches.append(nms_kernel.nms_keep.launches - before)
        if hp.engine.device.type == "cuda" and (
                any(n != 1 for _, n in calls) or launches[-1] != len(calls)):
            fail(f"a hand step made {launches[-1]} launches for its batches {calls}")
    return infos, ms, tiles, launches


def step_view(info: dict) -> dict:
    """What the hand session's step shows its user: active tracks, buttons
    and the input field."""
    return {"active": [dict(t, bbox=list(t["bbox"])) for t in info["active"]],
            "buttons": info["buttons"], "input": info["input"]}


def tile_candidates(engine, frame: np.ndarray, tile: int, overlap: float) -> nms_ops.Candidates:
    """The hand session's NMS input for a frame's tiles, computed on the card."""
    tiles, _ = tiled_frames(frame, tile, overlap)
    with torch.inference_mode():
        rgb = torch.from_numpy(tiles).to(engine.device).flip(-1)
        canvas, _, _ = letterbox_batch(rgb, (engine.imgsz, engine.imgsz))
        boxes, scores = yolov8.decode_boxes(engine.model(canvas), (engine.imgsz, engine.imgsz),
                                            engine.spec.strides)
        return nms_ops.nms_candidates(boxes, scores, conf_thres=engine.conf, pre_nms=K)


def trace_once(fn, tag: str) -> dict:
    """One torch.profiler trace of ``fn``: wall, device busy, idle share and
    the top device items (device copies of record_function ranges left out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        with record_function(tag):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = [e for e in events if not str(e.device_type).endswith("CUDA")]
    spans = [e for e in host if e.name == tag]
    if len(spans) != 1:
        fail(f"the trace holds {len(spans)} {tag} ranges, not 1")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    ranges = {e.name for e in host}
    dev = [e for e in events if str(e.device_type).endswith("CUDA") and e.name not in ranges
           and lo <= e.time_range.start <= hi]
    if not dev:
        fail(f"the {tag} trace holds no device events")
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "device_events": len(dev),
            "top_device": sorted(([n[:80], t] for n, t in by_name.items()), key=lambda x: -x[1])[:8]}


SERVE_TABLES, SERVE_TICKS, SERVE_WARMUP = 16, 48, 8
SERVE_F32_TABLES, SERVE_F32_TICKS = 4, 6
STREAM_FRAMES, STREAM_WARMUP, STREAM_F32_FRAMES = 20, 2, 6
SERVE_HW = (1200, 1920)
# the JAX package's results on the serving tick the bf16 check reads (tick 0
# of 4 tables, YOLOv8s at 640, conf 0.5), in bf16 and f32, with the
# largest bf16-against-f32 confidence gap measured there; written and kept
# current by the CPU tests (tests/torch_serve_cases.py)
GOLDEN = os.path.join(REPO, "tests", "torch_serve_golden.json")
# f32 rank probabilities, card against CPU; TF32, cuDNN's default, keeps
# about 3 decimal digits
F32_PROB_TOL = 1e-5


def table_sim_ticks(base: np.ndarray, tables: int, ticks: int) -> list:
    """``ticks`` ticks of cli/serve.py's table-sim fleet (repaint_every 0.08,
    photometric_every 0.02 per table and tick), made up front."""
    sources = [serve_cli.table_sim_source(base, seed=i) for i in range(tables)]
    return [[next(src) for src in sources] for _ in range(ticks)]


def serve_loop(stream, ticks) -> tuple:
    """cli/serve.py's loop: submit each tick, collect once more than 2 are in
    flight, drain at the end. Returns (results per tick, ms per loop step,
    wall ms of the whole run)."""
    results, ms = [], []
    t_all = time.perf_counter()
    for frames in ticks:
        t0 = time.perf_counter()
        stream.submit_batch(frames)
        if stream.in_flight > 2:
            results.append(stream.collect_batch())
        ms.append((time.perf_counter() - t0) * 1e3)
    while stream.in_flight:
        results.append(stream.collect_batch())
    if stream.device.type == "cuda":
        torch.cuda.synchronize()
    return results, ms, (time.perf_counter() - t_all) * 1e3


def record_tail(stream) -> tuple:
    """Wrap the stream's host tail: record (frames, metas, packed readback,
    full plane on the CPU, and on a fused tick the predicted crop rects, else
    None) of each fresh (not memo) tick, and the crops and f32 probabilities
    of each classifier call."""
    calls, probs = [], []
    finish, fused, classify = (stream._finish_batch, stream._finish_batch_fused,
                               stream._classify_probs)

    def rec_finish(frames, metas, flat, full):
        calls.append((frames, metas, flat.copy(), full.cpu(), None))
        return finish(frames, metas, flat, full)

    def rec_fused(frames, metas, flat, pred, full):
        calls.append((frames, metas, flat.copy(), full.cpu(), pred))
        return fused(frames, metas, flat, pred, full)

    def rec_classify(crops):
        out = classify(crops)
        probs.append((crops, out.cpu().numpy()))
        return out

    stream._finish_batch, stream._finish_batch_fused, stream._classify_probs = (
        rec_finish, rec_fused, rec_classify)
    return calls, probs


def replay_tail(stream, calls) -> tuple:
    """``stream``'s host tail (crop gather, classifier, rank gates; on a fused
    tick the rank rows the readback carries and the classifier on the missed
    crops) over another stream's recorded readbacks, from a fresh crop-rect
    cache: (results, f32 probabilities of each classifier call)."""
    stream._rect_cache, stream._prev_crops, stream._last_cls_probs = {}, None, None
    probs = []
    classify = stream._classify_probs

    def rec_classify(crops):
        out = classify(crops)
        probs.append(out.cpu().numpy())
        return out

    stream._classify_probs = rec_classify
    try:
        return [stream._finish_batch(frames, metas, flat, full) if pred is None
                else stream._finish_batch_fused(frames, metas, flat, pred, full)
                for frames, metas, flat, full, pred in calls], probs
    finally:
        del stream._classify_probs


def prob_gap(tag: str, card_probs: list, cpu_probs: list) -> float:
    """Largest difference of the f32 rank probabilities of the card's
    classifier calls and the CPU's on the same crops; fails above
    F32_PROB_TOL."""
    if len(card_probs) != len(cpu_probs) or not card_probs:
        fail(f"{tag}: {len(card_probs)} classifier calls on the card, {len(cpu_probs)} on the CPU")
    gap = max(float(np.abs(c - r).max()) for (_, c), r in zip(card_probs, cpu_probs))
    if gap > F32_PROB_TOL:
        fail(f"{tag}: f32 rank probabilities on the card differ from the CPU's by {gap}")
    return gap


def tf32_probs(stream, crops: np.ndarray) -> np.ndarray:
    """A control: the stream's f32 classifier on ``crops`` with TF32 forced
    on, as cuDNN's default (or a thread restoring the flags under another's
    forward) would leave it."""
    @contextlib.contextmanager
    def tf32():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    full_f32, yolov8.full_f32 = yolov8.full_f32, tf32
    try:
        return stream._classify_probs(crops).cpu().numpy()
    finally:
        yolov8.full_f32 = full_f32


def unpaired(dets: list, pairs: list, side: int) -> list:
    paired = [id(p[side]) for p in pairs]
    return [[d["class_name"], d["bbox"], d["conf"]] for d in dets if id(d) not in paired]


def serve_candidates(stream, frames) -> nms_ops.Candidates:
    """The NMS input of one serving tick, computed on the card."""
    S = stream.imgsz
    canvases = np.full((len(frames), S, S, 3), 114, np.uint8)
    for c, f in zip(canvases, frames):
        letterbox_u8_into(c, f, S)
    with torch.inference_mode():
        x = torch.from_numpy(canvases).to(stream.device).flip(-1).float() / 255.0
        boxes, scores = yolov8.decode_boxes(stream.det_model(x), (S, S),
                                            stream.det_model.spec.strides)
        return nms_ops.nms_candidates(boxes, scores, conf_thres=stream.conf, pre_nms=K)


def serving(dev, gpu_ocr, tmp: str, launches_by_path: dict) -> dict:
    """The serving path on the card, as cli/serve.py runs it, and its checks.
    Returns the serve16 kernel case (the keep-mask input of one 16-table tick)."""
    base = cv_resize_u8(imread_bgr(IMAGE), SERVE_HW)
    ticks = table_sim_ticks(base, SERVE_TABLES, SERVE_TICKS)
    stream = load_batch_stream(DETECTOR, CLASSIFIER, batch=SERVE_TABLES, imgsz=IMGSZ, conf=0.25,
                               compute_dtype=torch.bfloat16, device=dev)
    nms_kernel.nms_keep.launches = 0
    results, ms, wall_ms = serve_loop(stream, ticks)
    launches_by_path["serve"] = nms_kernel.nms_keep.launches
    if launches_by_path["serve"] != SERVE_TICKS:
        fail(f"the serving path made {launches_by_path['serve']} launches over {SERVE_TICKS} ticks")
    if len(results) != SERVE_TICKS or any(len(r) != SERVE_TABLES for r in results):
        fail("the serving path lost a tick or a table")
    n_dets = [len(dets) for dets in results[0]]
    n_ranks = sum(bool(d["ocr_text"]) for dets in results[0] for d in dets)
    if min(n_dets) < 10 or n_ranks < SERVE_TABLES:
        fail(f"tick 0 found {n_dets} detections per table and read {n_ranks} ranks")
    steady = ms[SERVE_WARMUP:]
    print(json.dumps({"serve_ms": {
        "tables": SERVE_TABLES, "ticks": SERVE_TICKS, "warmup": SERVE_WARMUP,
        "frame_hw": list(SERVE_HW), "imgsz": IMGSZ, "detector": "yolov8s bf16", "ocr": False,
        "median": statistics.median(steady), "min": min(steady),
        "frames_per_s": SERVE_TABLES * SERVE_TICKS / wall_ms * 1e3,
        "steady_frames_per_s": SERVE_TABLES * len(steady) / sum(steady) * 1e3,
        "modes": stream.mode_counts, "memo_hits": stream.memo_hits,
        "crop_modes": stream.crop_mode_counts, "readback_overflows": stream.readback_overflows,
        "detections_tick0": n_dets, "stages": stream.stage_summary(skip=SERVE_WARMUP)}}))

    def four_ticks():
        for frames in ticks[-4:]:
            stream.submit_batch(frames)
        for _ in range(4):
            stream.collect_batch()

    print(json.dumps({"serve_profile": dict(trace_once(four_ticks, "serve_ticks"), ticks=4,
                                            tables=SERVE_TABLES)}))
    cand = serve_candidates(stream, ticks[-1])
    stream.close()
    # the crop gather of the last tick's rank boxes, with the host library's
    # resize and with its plain twin (numpy), which are byte-identical
    rects = []
    for frame, dets in zip(ticks[-1], results[-1]):
        rects += [(frame, (max(0, d["bbox"][1] - 6), max(0, d["bbox"][0] - 6), d["bbox"][3] + 6,
                           d["bbox"][2] + 6)) for d in dets if d["class_name"] in taxonomy.RANK_CLASSES]
    gather_ms = {}
    for name, resize in (("resize_u8", native.resize_u8), ("plain_cv_resize_u8", cv_resize_u8),
                         ("resize_u8_again", native.resize_u8)):
        t0 = time.perf_counter()
        crops = []
        for frame, (ys, xs, ye, xe) in rects:
            crop = frame[ys:ye, xs:xe]
            scale = 64 / min(crop.shape[:2])
            crops.append(resize(crop, (max(64, round(crop.shape[0] * scale)),
                                       max(64, round(crop.shape[1] * scale)))))
        gather_ms[name] = (time.perf_counter() - t0) * 1e3
        if name == "resize_u8":
            first = crops
        elif any(not np.array_equal(a, b) for a, b in zip(first, crops)):
            fail(f"{name} differs from resize_u8 on the serving crops")
    print(json.dumps({"serve_crop_resize_ms": dict(gather_ms, crops=len(rects))}))

    # f32 on the card against f32 on the CPU, 4 tables: the same classes, box
    # corners within 1 px, confidences within 0.002; the texts of the card
    # equal the CPU's host tail run on the card's readbacks, and the f32 rank
    # probabilities agree within F32_PROB_TOL (a TF32 classifier, the control,
    # would not)
    f32_ticks = [t[:SERVE_F32_TABLES] for t in ticks[:SERVE_F32_TICKS]]
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        s = load_batch_stream(DETECTOR, CLASSIFIER, batch=SERVE_F32_TABLES, imgsz=IMGSZ, conf=0.25,
                              compute_dtype=torch.float32, device=device)
        rec = record_tail(s)
        flags = []
        submit_f = s.submit_batch

        def submit_flags(frames, s=s, submit_f=submit_f, flags=flags):
            submit_f(frames)
            flags.append(s._pending[-1]["memo"])

        s.submit_batch = submit_flags
        runs[name] = (s, serve_loop(s, f32_ticks)[0], rec, flags)
    (card, card_res, (card_calls, card_probs), card_flags) = runs["card"]
    (cpu_s, cpu_res, _, cpu_flags) = runs["cpu"]
    if card_flags != cpu_flags or card.mode_counts != cpu_s.mode_counts \
            or card.memo_hits != cpu_s.memo_hits:
        fail(f"f32 card modes {card.mode_counts} memo {card.memo_hits} vs CPU "
             f"{cpu_s.mode_counts} {cpu_s.memo_hits}")
    differ = []
    for t, (g, r) in enumerate(zip(card_res, cpu_res)):
        for ti, (gd, rd) in enumerate(zip(g, r)):
            differ += [[t, ti, d["class_name"], d["bbox"], c["bbox"], d["ocr_text"], c["ocr_text"]]
                       for d, c in compare_dets(f"serve f32 tick {t} table {ti}", gd, rd, 1,
                                                conf_tol=0.002, texts="none")
                       if d["ocr_text"] != c["ocr_text"]]
    replay, replay_probs = replay_tail(cpu_s, card_calls)
    if [r for r, memo in zip(card_res, card_flags) if not memo] != replay:
        fail("the f32 card's serving results differ from the CPU's host tail on the same readbacks")
    worst = prob_gap("serve f32", card_probs, replay_probs)
    tf32_gap = float(np.abs(tf32_probs(card, card_probs[0][0]) - replay_probs[0]).max())
    for s_ in (card, cpu_s):
        s_.close()
    # bf16 on the card on tick 0 (4 tables, the golden test's conf 0.5) under
    # the golden tolerance: boxes within 5 px, confidences within the margin,
    # the same class lists but for detections within the margin of the gate,
    # and the rank texts held (a) against the JAX package's bf16 on the same
    # tick (tests/torch_serve_golden.json): every text equal; (b) against the
    # CPU's f32: every text equal but where the JAX package's own bf16 and f32
    # read that card differently, and in the same way (a box a pixel over is
    # another crop); (c) against the CPU's host tail on the card's bf16
    # readback: the card's results exactly, f32 probabilities within
    # F32_PROB_TOL
    with open(GOLDEN) as f:
        golden = json.load(f)
    if (golden["frames_sha256"], golden["conf"], golden["tables"], golden["imgsz"]) != (
            hashlib.sha256(b"".join(f.tobytes() for f in f32_ticks[0])).hexdigest(), CONF,
            SERVE_F32_TABLES, IMGSZ):
        fail(f"{GOLDEN} holds another tick")
    margin = golden["margin"]
    gold = {}
    for name, device, dtype in (("card", dev, torch.bfloat16), ("cpu", "cpu", torch.float32)):
        with load_batch_stream(DETECTOR, CLASSIFIER, batch=SERVE_F32_TABLES, imgsz=IMGSZ, conf=CONF,
                               compute_dtype=dtype, device=device) as g:
            if name == "card":
                gold_calls, gold_probs = record_tail(g)
            g.submit_batch(f32_ticks[0])
            gold[name] = g.collect_batch()
            if name == "cpu":
                gold_replay, gold_replay_probs = replay_tail(g, gold_calls)
    if gold_replay != [gold["card"]]:
        fail("the bf16 card's rank texts differ from the CPU's host tail on the same readback")
    bf16_tail_gap = prob_gap("serve bf16 tick 0", gold_probs, gold_replay_probs)
    gaps, box_px = {"jax_bf16": 0.0, "cpu_f32": 0.0}, {"jax_bf16": 0, "cpu_f32": 0}
    witnessed, unpaired_at_gate, n_ranks = [], [], 0
    for ti in range(SERVE_F32_TABLES):
        tag, got = f"serve bf16 tick 0 table {ti}", gold["card"][ti]
        pairs = compare_dets(f"{tag} against the JAX package's bf16", got, golden["bfloat16"][ti],
                             conf_tol=margin, margin=margin)
        gaps["jax_bf16"] = max([gaps["jax_bf16"]] + [abs(d["conf"] - r["conf"]) for d, r in pairs])
        box_px["jax_bf16"] = max([box_px["jax_bf16"]] + [box_dist(d, r) for d, r in pairs])
        n_ranks += sum(bool(d["ocr_text"]) for d, _ in pairs)
        unpaired_at_gate += [[ti, "card, not jax_bf16"] + u for u in unpaired(got, pairs, 0)]
        unpaired_at_gate += [[ti, "jax_bf16, not card"] + u
                             for u in unpaired(golden["bfloat16"][ti], pairs, 1)]
        ref_flips = {(r["class_name"], b["ocr_text"], r["ocr_text"]) for b, r in pair_dets(
            f"the JAX package's bf16 against its f32, table {ti}", golden["bfloat16"][ti],
            golden["float32"][ti], BOX_TOL_PX, margin) if b["ocr_text"] != r["ocr_text"]}
        pairs = compare_dets(f"{tag} against the CPU's f32", got, gold["cpu"][ti],
                             conf_tol=margin, margin=margin, texts="none")
        gaps["cpu_f32"] = max([gaps["cpu_f32"]] + [abs(d["conf"] - r["conf"]) for d, r in pairs])
        box_px["cpu_f32"] = max([box_px["cpu_f32"]] + [box_dist(d, r) for d, r in pairs])
        unpaired_at_gate += [[ti, "card, not cpu_f32"] + u for u in unpaired(got, pairs, 0)]
        unpaired_at_gate += [[ti, "cpu_f32, not card"] + u for u in unpaired(gold["cpu"][ti], pairs, 1)]
        for d, r in pairs:
            if d["ocr_text"] == r["ocr_text"]:
                continue
            if (r["class_name"], d["ocr_text"], r["ocr_text"]) not in ref_flips:
                fail(f"{tag}: {d['class_name']} at {d['bbox']} reads {d['ocr_text']!r}, the CPU's "
                     f"f32 {r['ocr_text']!r} at {r['bbox']}, where the JAX package's bf16 and f32 "
                     "do not differ so")
            witnessed.append([ti, d["class_name"], d["bbox"], r["bbox"], d["ocr_text"], r["ocr_text"]])
    if n_ranks < 3 * SERVE_F32_TABLES:
        fail(f"the bf16 tick 0 read {n_ranks} ranks")
    print(json.dumps({"serve_f32_vs_cpu": {
        "tables": SERVE_F32_TABLES, "ticks": SERVE_F32_TICKS, "equal": True,
        "modes": card.mode_counts, "memo_hits": card.memo_hits,
        "texts_equal_on_same_readback": True, "f32_prob_max_diff": worst,
        "f32_prob_tol": F32_PROB_TOL, "tf32_control_prob_max_diff": tf32_gap,
        "stream_vs_stream_text_differences": differ}}))
    print(json.dumps({"serve_bf16_tick0": {
        "tables": SERVE_F32_TABLES, "conf": CONF, "margin": margin,
        "texts_equal_to_jax_bf16": True, "texts_equal_on_same_readback": True,
        "f32_prob_max_diff_on_same_readback": bf16_tail_gap, "max_conf_gap": gaps,
        "max_box_px": box_px,
        "reads_unlike_cpu_f32_as_jax_bf16_unlike_jax_f32": witnessed,
        "unpaired_within_margin_of_gate": unpaired_at_gate}}))

    # the streaming engine: bf16 over 20 frames, counted; f32 card vs CPU
    frames = shifted_frames(base, STREAM_FRAMES)
    eng = load_streaming_engine(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=0.25,
                                compute_dtype=torch.bfloat16, device=dev)
    nms_kernel.nms_keep.launches = 0
    out, st_ms = [], []
    t_all = time.perf_counter()
    for f in frames:
        t0 = time.perf_counter()
        r = eng.process(f)
        st_ms.append((time.perf_counter() - t0) * 1e3)
        if r is not None:
            out.append(r)
    out += eng.drain()
    torch.cuda.synchronize()
    st_wall = (time.perf_counter() - t_all) * 1e3
    launches_by_path["streaming"] = nms_kernel.nms_keep.launches
    if launches_by_path["streaming"] != STREAM_FRAMES or len(out) != STREAM_FRAMES:
        fail(f"the streaming engine made {launches_by_path['streaming']} launches and returned "
             f"{len(out)} results over {STREAM_FRAMES} frames")
    st32 = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        e = load_streaming_engine(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=0.25,
                                  compute_dtype=torch.float32, device=device)
        polled = [e.process(f) for f in frames[:STREAM_F32_FRAMES]]
        st32[name] = [r for r in polled if r is not None] + e.drain()
    moved_st = []
    for i, (g, r) in enumerate(zip(st32["card"], st32["cpu"])):
        moved_st += [[i, d["class_name"], d["bbox"], c["bbox"], d["ocr_text"], c["ocr_text"]]
                     for d, c in compare_dets(f"streaming f32 frame {i}", g, r, 1, conf_tol=0.002,
                                              texts="unmoved")
                     if d["ocr_text"] != c["ocr_text"]]
    print(json.dumps({"streaming_ms": {
        "frames": STREAM_FRAMES, "warmup": STREAM_WARMUP, "detector": "yolov8s bf16",
        "median": statistics.median(st_ms[STREAM_WARMUP:]), "min": min(st_ms[STREAM_WARMUP:]),
        "frames_per_s": STREAM_FRAMES / st_wall * 1e3,
        "f32_vs_cpu": {"frames": STREAM_F32_FRAMES, "equal": True, "moved_box_reads": moved_st}}}))

    # cli/serve.py with OCR on, 4 tables, 8 ticks, then a FieldOCRMemo pass
    out_dir = os.path.join(tmp, "serve_cli")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--tables", "4", "--ticks", "8", "--base", IMAGE, "--out", out_dir,
                             "--ocr", "--warmup-ticks", "2", "--detector", DETECTOR,
                             "--classifier", CLASSIFIER])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = []
    for ti in range(4):
        with open(os.path.join(out_dir, f"table_{ti:02d}.jsonl")) as f:
            rows.append([json.loads(line) for line in f])
    read = sum(bool(d["ocr_text"]) for d in rows[0][0]["fields"])
    if rc != 0 or summary.get("ocr_errors") != 0 or summary["frames"] != 32 \
            or any(len(r) != 8 for r in rows) or read < 5:
        fail(f"cli.serve --ocr: rc {rc}, summary {summary}, rows {[len(r) for r in rows]}, "
             f"{read} fields read on table 0's first tick")
    memo = FieldOCRMemo(gpu_ocr, async_reads=False)
    errors0 = gpu_ocr.errors
    for t, res in enumerate(card_res):
        memo.process(f32_ticks[t], [[dict(d) for d in dets] for dets in res])
    memo.close()
    stats = memo.stats()
    if memo.errors or gpu_ocr.errors != errors0 or not stats["fields_read"] or not stats["fields_memo"]:
        fail(f"FieldOCRMemo on the card: {stats}, {memo.errors} errors, OCR {gpu_ocr.errors - errors0}")
    print(json.dumps({"serve_cli_ocr": {"summary": summary, "fields_read_tick0_table0": read,
                                        "field_memo": stats}}))
    return {"serve16": (cand.nms_boxes.contiguous(), cand.valid.contiguous())}


CODEC_TABLES, CODEC_JITTER_TICKS, CODEC_WARMUP = 16, 24, 4
# table 0's other letterbox geometry: 1800x1920 letterboxes onto 640 exactly
# 3:1 too (600 content rows), so noise within +-7 stays within +-7 on the
# canvas and the whole-canvas nibble fits
CODEC_OTHER_HW = (1800, 1920)


def jitter_ticks(base: np.ndarray, tables: int, seed: int):
    """bench.py's jittered stream, per table: each tick a new frame of the
    table's content plus a global jitter within [-6, 6] per channel, after a
    local repaint of the content (a 40x120 counter redraw in a flat color
    with a few dark strokes) that persists. Every table starts from
    ``base``: one client skin at one window size, so the tables' fields lie
    at the same pixels, as cli/serve.py's table-sim fleet has them. Yields
    ticks (lists of frames) forever."""
    rng = np.random.default_rng(seed)
    content = [base.copy() for _ in range(tables)]
    h, w = base.shape[:2]
    while True:
        tick = []
        for c in content:
            y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 120))
            c[y:y + 40, x:x + 120] = rng.integers(0, 256, 3, dtype=np.uint8)
            c[y + 10:y + 30, x + 8:x + 112:16] = rng.integers(0, 80, 3, dtype=np.uint8)
            jit = rng.integers(-6, 7, (1, 1, 3), np.int16)
            tick.append(np.clip(c.astype(np.int16) + jit, 0, 255).astype(np.uint8))
        yield tick


def codec_ticks(base: np.ndarray, tables: int, n_jitter: int, seed: int = 0) -> tuple:
    """The codec phase's ticks and the mode each is planned to take: the
    tables' first frames (raw), ``n_jitter`` jittered ticks (segs, each with
    the fused classify), per-pixel noise within +-3 on the last of them
    (tribit), table 0 at another letterbox geometry (raw), and per-pixel
    noise within +-7 at that geometry (nibble over the whole canvas).
    Returns (ticks, planned modes, the jitter generator to go on with)."""
    rng = np.random.default_rng(seed + 1)
    gen = jitter_ticks(base, tables, seed)
    ticks = [next(gen) for _ in range(n_jitter + 1)]

    def noise(frames, a):
        return [np.clip(f.astype(np.int16) + rng.integers(-a, a + 1, f.shape, dtype=np.int16),
                        0, 255).astype(np.uint8) for f in frames]

    ticks.append(noise(ticks[-1], 3))
    ticks.append([cv_resize_u8(base, CODEC_OTHER_HW)] + ticks[-1][1:])
    ticks.append(noise(ticks[-1], 7))
    planned = ["raw"] + ["segs"] * n_jitter + ["tribit", "raw", "nibble"]
    return ticks, planned, gen


def segs_shares(counts) -> dict:
    """Mean share of a segs tick's canvas segments by class group, from the
    stream's ``canvas_seg_counts`` (nseg, k1, k2, k3, k_raw, k_mask4,
    k_mask8, ...): zero-payload (const and clamp-shift), dense residuals
    (1/2/3-bit and shift-residual), sparse exceptions, raw."""
    rows = [(nseg, k1 + k2 + k3, k4 + k8, kr) for nseg, k1, k2, k3, kr, k4, k8, *_ in counts]
    return {name: statistics.mean(r[i] / r[0] for r in rows) for i, name in
            ((1, "dense"), (2, "sparse"), (3, "raw"))} | {
        "zero_payload": statistics.mean((r[0] - r[1] - r[2] - r[3]) / r[0] for r in rows)}


def watch_fused(stream) -> dict:
    """Wrap the stream's fused tail to record, per fused tick (by the id of
    its frame list), the (table, detection) pairs whose rank row came from a
    prediction of another rect of the same class (the near-miss acceptance
    of ``_finish_batch_fused``): a crop a few pixels over, which may read
    another rank than the tick's own crop."""
    near, last = {}, {}
    assemble, fused = stream._assemble_dets, stream._finish_batch_fused

    def rec_assemble(frames, metas, packed):
        last["out"] = assemble(frames, metas, packed)
        return last["out"]

    def rec_fused(frames, metas, flat, pred, full):
        out = fused(frames, metas, flat, pred, full)
        pairs, pad = set(), stream.crop_pad
        for bi, cands in enumerate(last["out"][1]):
            slot_of = {cr: j for j, cr in enumerate(pred[bi])}
            for cid, rect, i in cands:
                if (cid, rect) in slot_of:
                    continue
                if any(pc == cid and stream._rect_iou(pr, rect) >= 0.6
                       and abs(pr[0] + pr[2] - rect[0] - rect[2]) <= 4 * pad
                       and abs(pr[1] + pr[3] - rect[1] - rect[3]) <= 4 * pad
                       for pc, pr in slot_of):
                    pairs.add((bi, i))
        near[id(frames)] = pairs
        return out

    stream._assemble_dets, stream._finish_batch_fused = rec_assemble, rec_fused
    return near


def same_results(tag: str, ticks, got: list, ref: list, near: dict) -> dict:
    """A delta stream's results against the delta=False stream's on the same
    ticks: every detection equal (class, box, confidence), and every rank text
    equal but for near-miss rows (``watch_fused``). Returns the counts of rank
    detections, near-miss rows and texts that differ there, and the first
    few of those."""
    if len(got) != len(ref):
        fail(f"{tag}: {len(got)} ticks against {len(ref)}")
    listed = []
    ranks = sum(d["class_name"] in taxonomy.RANK_CLASSES for g in got for dets in g for d in dets)
    for t, (g, r) in enumerate(zip(got, ref)):
        pairs = near.get(id(ticks[t]), set())
        for ti, (gd, rd) in enumerate(zip(g, r)):
            if len(gd) != len(rd):
                fail(f"{tag} tick {t} table {ti}: {len(gd)} detections against {len(rd)}")
            for i, (a, b) in enumerate(zip(gd, rd)):
                if {k: v for k, v in a.items() if k != "ocr_text"} != \
                        {k: v for k, v in b.items() if k != "ocr_text"}:
                    fail(f"{tag} tick {t} table {ti}: {a} against delta=False {b}")
                if a["ocr_text"] != b["ocr_text"]:
                    if (ti, i) not in pairs:
                        fail(f"{tag} tick {t} table {ti}: {a['class_name']} reads "
                             f"{a['ocr_text']!r}, delta=False {b['ocr_text']!r}")
                    listed.append([t, ti, a["class_name"], a["bbox"], a["ocr_text"], b["ocr_text"]])
    return {"rank_detections": ranks,
            "near_miss_rows": sum(len(near.get(id(t), ())) for t in ticks),
            "texts_differing_there": len(listed), "first": listed[:6]}


def checked_pass(stream, ticks, cases=None) -> list:
    """Each tick submitted and collected alone; after each, the resident
    canvas and predicted crop plane on the card equal the host's staging and
    predicted planes byte for byte. With ``cases``, the first payload of each
    decoded mode is kept there (with the planes it was decoded against)."""
    decode = stream._decode

    def keep(item):
        if cases is not None and item["mode"] in ("nibble", "tribit", "fused") \
                and item["mode"] not in cases:
            cases[item["mode"]] = ({k: item[k] for k in ("mode", "rows", "fused") if k in item}
                                   | {"wire": item["wire"].clone()},
                                   stream._dev_canvas.clone(), stream._dev_pred_crops.clone())
        decode(item)

    stream._decode = keep
    out = []
    try:
        for t, frames in enumerate(ticks):
            stream.submit_batch(frames)
            out.append(stream.collect_batch())
            torch.cuda.synchronize()
            if not torch.equal(stream._dev_canvas.cpu(),
                               torch.from_numpy(stream._staging[stream._staging_i])):
                fail(f"codec tick {t}: the resident canvas differs from the host's staging")
            if stream._pred_prev_crops is not None and not torch.equal(
                    stream._dev_pred_crops.cpu(), torch.from_numpy(stream._pred_prev_crops)):
                fail(f"codec tick {t}: the resident crop plane differs from the host's")
    finally:
        del stream._decode
    return out


def decode_profile(stream, cases: dict) -> dict:
    """One torch.profiler trace of each kept payload's decode, as the
    dispatcher runs it, from the planes it was decoded against: device
    kernel launches and device ms per tick, and the payload's bytes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def run(mode):
        item, canvas, crops = cases[mode]
        stream._dev_canvas, stream._dev_pred_crops = canvas.clone(), crops.clone()
        torch.cuda.synchronize()
        with record_function(f"decode_{mode}"):
            stream._decode(dict(item))
            torch.cuda.synchronize()

    for mode in cases:
        run(mode)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for mode in cases:
            run(mode)
    events = prof.events()
    host = [e for e in events if not str(e.device_type).endswith("CUDA")]
    names = {e.name for e in host}
    dev = [e for e in events if str(e.device_type).endswith("CUDA") and e.name not in names]
    out = {}
    for mode, (item, _, _) in cases.items():
        span = [e for e in host if e.name == f"decode_{mode}"]
        if len(span) != 1:
            fail(f"the decode trace holds {len(span)} decode_{mode} ranges")
        lo, hi = span[0].time_range.start, span[0].time_range.end
        mine = [e for e in dev if lo <= e.time_range.start <= hi]
        if not mine:
            fail(f"the decode_{mode} range holds no device events")
        out[mode] = {"launches": len(mine),
                     "device_ms": sum(e.time_range.elapsed_us() for e in mine) / 1e3,
                     "wall_ms": (hi - lo) / 1e3, "payload_mb": item["wire"].numel() / 1e6}
    return out


def codec(dev, launches_by_path: dict) -> None:
    """Serving with every table changing every tick, so that the delta codec
    carries it: the main path counted and timed, the same fleet with
    delta=False, the resident planes checked tick by tick, bf16 and f32 held
    against delta=False, and the decode traced per mode."""
    base = cv_resize_u8(imread_bgr(IMAGE), SERVE_HW)
    ticks, planned, gen = codec_ticks(base, CODEC_TABLES, CODEC_JITTER_TICKS)
    extra = [next(gen) for _ in range(9)]  # one to come back to one geometry, 2 x 4 traced
    kw = dict(batch=CODEC_TABLES, imgsz=IMGSZ, conf=0.25, device=dev)

    def four_ticks(stream, it):
        def run():
            for _ in range(4):
                stream.submit_batch(next(it))
            for _ in range(4):
                stream.collect_batch()
        return run

    runs = {}
    for delta in (True, False):
        s = load_batch_stream(DETECTOR, CLASSIFIER, compute_dtype=torch.bfloat16, delta=delta, **kw)
        s.prewarm_async()
        torch.cuda.synchronize()
        near = watch_fused(s)
        nms_kernel.nms_keep.launches = 0
        results, ms, wall_ms = serve_loop(s, ticks)
        launches = nms_kernel.nms_keep.launches
        modes = dict(s.mode_counts)
        want = ({m: planned.count(m) for m in modes} if delta
                else {m: len(ticks) * (m == "raw") for m in modes})
        if modes != want:
            fail(f"codec (delta={delta}) modes {modes}, planned {want}")
        if delta:
            launches_by_path["codec"] = launches
        if launches != len(ticks) or len(results) != len(ticks):
            fail(f"codec (delta={delta}): {launches} launches and {len(results)} results over "
                 f"{len(ticks)} ticks")
        payload = list(s.stage_stats["payload_mb"])
        stages = s.stage_summary(skip=CODEC_WARMUP)
        s.submit_batch(extra[0])
        s.collect_batch()
        it = iter(extra[1:])
        prof = trace_once(four_ticks(s, it), f"codec_ticks_delta_{delta}")
        runs[delta] = {"stream": s, "modes": modes, "results": results, "ms": ms, "wall_ms": wall_ms,
                       "near": near, "payload": payload, "stages": stages, "profile": prof}
        s.close()
    main = runs[True]["stream"]
    if not all(runs[True]["modes"][m] for m in ("segs", "tribit", "nibble")) \
            or main.crop_mode_counts["fused_segs"] < 1:
        fail(f"the codec phase ran modes {runs[True]['modes']}, crop modes {main.crop_mode_counts}")
    by_mode = {}
    for mode, mb in zip(planned, runs[True]["payload"]):
        by_mode.setdefault(mode, []).append(mb)
    raw_active_mb = CODEC_TABLES * 400 * IMGSZ * 3 / 1e6
    steady = {d: r["ms"][CODEC_WARMUP:] for d, r in runs.items()}
    p50 = lambda st, k: st.get(k, {}).get("p50_ms")  # noqa: E731
    print(json.dumps({"codec_ms": {
        "tables": CODEC_TABLES, "ticks": len(ticks), "warmup": CODEC_WARMUP,
        "frame_hw": list(SERVE_HW), "imgsz": IMGSZ, "detector": "yolov8s bf16", "ocr": False,
        "planned_modes": planned, "modes": runs[True]["modes"], "crop_modes": main.crop_mode_counts,
        "fused_hits": main.fused_hits, "fused_misses": main.fused_misses,
        "fallback_batches": main.fallback_batches, "memo_hits": main.memo_hits,
        "upload_mb_per_tick_by_planned_mode": {m: statistics.mean(v) for m, v in by_mode.items()},
        "raw_active_mb": raw_active_mb,
        "segs_share_by_class": segs_shares(main.stage_stats["canvas_seg_counts"]),
        "canvas_mb_mean": statistics.mean(main.stage_stats["canvas_mb"]),
        "crops_mb_mean": statistics.mean(main.stage_stats["crops_mb"]),
        "submit_encode_p50_ms": p50(runs[True]["stages"], "submit_encode"),
        "submit_crops_p50_ms": p50(runs[True]["stages"], "submit_crops"),
        "dispatch_p50_ms": p50(runs[True]["stages"], "dispatch"),
        "loop_median_ms": statistics.median(steady[True]),
        "frames_per_s": CODEC_TABLES * len(ticks) / runs[True]["wall_ms"] * 1e3,
        "stages": runs[True]["stages"],
        "delta_false": {
            "loop_median_ms": statistics.median(steady[False]),
            "frames_per_s": CODEC_TABLES * len(ticks) / runs[False]["wall_ms"] * 1e3,
            "upload_mb_per_tick": statistics.mean(runs[False]["payload"]),
            "modes": runs[False]["modes"],
            "dispatch_p50_ms": p50(runs[False]["stages"], "dispatch"),
            "submit_encode_p50_ms": p50(runs[False]["stages"], "submit_encode"),
            "stages": runs[False]["stages"]}}}))
    print(json.dumps({"codec_profile": {"delta": runs[True]["profile"],
                                        "delta_false": runs[False]["profile"],
                                        "ticks": 4, "tables": CODEC_TABLES}}))
    bf16_near = same_results("codec bf16", ticks, runs[True]["results"], runs[False]["results"],
                             runs[True]["near"])

    # the resident planes tick by tick, and f32 against delta=False, on the card
    checked = {}
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for delta in (True, False):
            s = load_batch_stream(DETECTOR, CLASSIFIER, compute_dtype=dtype, delta=delta, **kw)
            near = watch_fused(s)
            res = checked_pass(s, ticks, cases if delta and dtype == torch.bfloat16 else None) \
                if delta else serve_loop(s, ticks)[0]
            checked[(dtype, delta)] = (s, res, near)
            if dtype == torch.bfloat16 and delta:
                decode = decode_profile(s, cases)
            s.close()
    listed = {}
    for dtype in (torch.bfloat16, torch.float32):
        s, res, near = checked[(dtype, True)]
        if s.mode_counts != runs[True]["modes"]:
            fail(f"the checked codec pass ran {s.mode_counts}, the main path {runs[True]['modes']}")
        listed[str(dtype).split(".")[-1]] = same_results(
            f"codec checked {dtype}", ticks, res, checked[(dtype, False)][1], near)
    if set(cases) != {"fused", "tribit", "nibble"}:
        fail(f"the checked codec pass decoded {sorted(cases)}")
    print(json.dumps({"codec_decode": dict(decode, ticks_by_mode={
        m: n for m, n in checked[(torch.bfloat16, True)][0].mode_counts.items() if n})}))
    print(json.dumps({"codec_checks": {
        "resident_planes_equal_host_every_tick": True,
        "results_equal_delta_false": {"bfloat16_pipelined": True, "bfloat16": True, "float32": True},
        "near_miss_rows": {"bfloat16_pipelined": bf16_near, **listed},
        "nms_launches_equal_ticks": True}}))


TRAIN_DET_TRAIN, TRAIN_DET_VALID = 16, 4  # frames of the YOLO dataset written here
TRAIN_DET_STEPS, TRAIN_DET_EPOCHS, TRAIN_DET_BATCH = 4, 2, 16
DETECTOR_N = os.path.join(REPO, "weights", "poker_detector_n.npz")
MATCHED = os.path.join(REPO, "data", "rank_matched.npz")
# three f32 train steps (lr 1e-3), card against CPU. The first step's loss
# and gradients are the same computation on both: the loss within 1e-5
# relative, every gradient within 1e-4 of the largest (the tolerance of the
# port against JAX, tests/test_torch_train_det.py). The detector's needs the
# CPU's train-mode BN in JAX's arithmetic (TrainConvBlock.normalize):
# PyTorch's CPU kernel lost f32 precision in its batch statistics, moved
# SPPF cv1's output by up to 7.5e-4, flipped 10 of its first pool's argmaxes
# against the card's (none a tie; the card pools the CPU's input to the
# CPU's indices) and put the CPU's gradients 3% of a leaf's largest from
# f64 where the card's lay within 1.3e-5 (PERF.md §6). ``detector_grad_diagnosis``
# reports the four ways (card with and without cuDNN, CPU f32 and f64) and
# SPPF's ties on every run. After it the weights
# drift apart: AdamW's first update is lr * sign(g) for every weight whose
# gradient is far above eps, and a conv weight in front of a BN has a
# gradient that is a difference of large terms, whose sign the two devices'
# roundings can split; such a weight then steps 2 * lr apart. So the losses
# of steps 2 and 3 are held within 1e-3 relative, the median weight within
# 3e-5, all but 5% of the weights within 3e-4 (a tenth of the 3e-3 three
# steps move a weight), every weight within 1e-2 (three opposite steps at
# Adam's largest ratio), BN running statistics within 5e-3 relative
TRAIN_LR = 1e-3
TRAIN_LOSS0_RTOL, TRAIN_LOSS_RTOL = 1e-5, 1e-3
TRAIN_GRAD_TOL = {"detect": 1e-4, "classify": 1e-4}
TRAIN_WEIGHT_MEDIAN, TRAIN_WEIGHT_ATOL, TRAIN_WEIGHT_SHARE, TRAIN_WEIGHT_MAX = 3e-5, 3e-4, 0.05, 1e-2
TRAIN_STAT_RTOL = 5e-3
TRAIN_F32_DET_BATCH = 2  # the detector's batch in the f32 check: the CPU side runs it too
EVAL_MAP_TOL = 1e-3


@contextlib.contextmanager
def wrapped(module, name: str, make):
    """Replace ``module.name`` by ``make(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def rank_folder_dataset(root: str) -> dict:
    """data/rank_matched.npz as a folder dataset of PNGs: train/ and valid/,
    one folder per class in the npz's name order. -> {split: crops written}."""
    z = np.load(MATCHED)
    names = [str(n) for n in z["names"]]
    written = {}
    for split in ("train", "valid"):
        for name in names:
            os.makedirs(os.path.join(root, split, name), exist_ok=True)
        for i, (img, c) in enumerate(zip(z[f"{split}_x"], z[f"{split}_y"])):
            png.write_png(os.path.join(root, split, names[int(c)], f"{i:05d}.png"), img[..., ::-1])
        written[split] = len(z[f"{split}_y"])
    return written


def train_cls_phase(dev, tmp: str) -> None:
    """The warm start read by the trainer's own evaluate, then cli.train_cls
    for two epochs on the card; the best checkpoint through the readers."""
    from manual_yolo_tpu_torch.cli import train_cls as train_cls_cli
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.models.classifier import RankClassifier
    from manual_yolo_tpu_torch.train import classifier as cls_train
    from manual_yolo_tpu_torch.train.data import load_classify_folder

    root = os.path.join(tmp, "rank_classifier")
    written = rank_folder_dataset(root)
    if written != {"train": 1536, "valid": 67}:
        fail(f"the rank dataset holds {written} crops, not 1536 and 67")
    x_val, y_val, _ = load_classify_folder(os.path.join(root, "valid"), 64)
    params, meta = load_params(CLASSIFIER)
    spec = yolov8.build_spec("classify", "n", 13)
    warm = yolov8.load_jax_params(yolov8.build_model(spec, train=True), params).to(dev)
    top1, _ = cls_train.evaluate(warm, x_val, y_val, dev)
    right = round(top1 * len(y_val))
    if right != 64 or abs(top1 - meta["top1_matched"]) > 1e-4:
        fail(f"the warm start reads {right}/{len(y_val)} valid crops (top-1 {top1}), not 64/67 "
             f"(the checkpoint's top1_matched {meta['top1_matched']})")
    out = os.path.join(tmp, "cls_run", "best.npz")
    results = []
    with wrapped(cls_train, "train_classifier",
                 lambda f: lambda cfg, log=print: results.append(f(cfg, log)) or results[-1]):
        rc = train_cls_cli.main(["--data", root, "--out", out, "--epochs", "2", "--batch", "64",
                                 "--imgsz", "64", "--init-from-npz", CLASSIFIER])
    hist = results[0]["history"]
    if rc != 0 or len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"cli.train_cls returned {rc} with history {hist}")
    best, best_meta = load_params(out)
    clf = RankClassifier.from_npz(out, device=dev)
    npz_top1 = float(np.mean(clf.logits(torch.from_numpy(x_val).to(dev)).argmax(-1).cpu().numpy()
                             == y_val))
    if abs(npz_top1 - best_meta["top1"]) > 1.5 / len(y_val):
        fail(f"the best checkpoint reads top-1 {npz_top1} through RankClassifier, "
             f"its meta says {best_meta['top1']}")
    step_ms = [h["step_ms"] for h in hist]
    print(json.dumps({"train_cls": {
        "warm_start_top1": top1, "warm_start_right": f"{right}/{len(y_val)}",
        "epochs": 2, "steps_per_epoch": 1536 // 64, "batch": 64, "dtype": "float32",
        "step_ms_median_by_epoch": step_ms, "batch_build_ms_median_by_epoch": [h["batch_ms"] for h in hist],
        "crops_per_s": 64 / (statistics.median(step_ms) / 1e3),
        "epoch_loss": [h["loss"] for h in hist], "top1": [h["top1"] for h in hist],
        "best_top1": results[0]["best_top1"], "best_checkpoint_top1_via_RankClassifier": npz_top1,
        "wall_s": results[0]["wall_s"]}}))


def yolo_frames(frame_img: np.ndarray, frame_rand: np.ndarray) -> list:
    """The example and the seeded frame, alternating, each shifted a few
    pixels more than the last: 16 train frames, then 4 valid."""
    frames = []
    for i in range(TRAIN_DET_TRAIN + TRAIN_DET_VALID):
        base = frame_img if i % 2 == 0 else frame_rand
        frames.append(np.ascontiguousarray(np.roll(base, (3 * (i // 2), -5 * (i // 2)), (0, 1))))
    return frames


def write_yolo_dataset(root: str, frames: list, dev) -> int:
    """A YOLO dataset of PNGs; each frame's labels are the port's own f32
    detections of poker_detector_n at conf 0.25; data.yaml lists the 64
    names of the taxonomy as a block list. -> labelled boxes."""
    engine = DetectorEngine.from_npz(DETECTOR_N, imgsz=IMGSZ, conf=0.25, compute_dtype="float32",
                                     device=dev)
    boxes = 0
    for i, frame in enumerate(frames):
        split = "train" if i < TRAIN_DET_TRAIN else "valid"
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        png.write_png(os.path.join(root, split, "images", f"f{i:02d}.png"), frame)
        h, w = frame.shape[:2]
        with open(os.path.join(root, split, "labels", f"f{i:02d}.txt"), "w") as f:
            for d in engine.detect_to_list(frame):
                x1, y1, x2, y2 = d["x1"], d["y1"], d["x2"], d["y2"]
                f.write(f"{d['class_id']} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                        f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}\n")
                boxes += 1
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write("train: ../train/images\nval: ../valid/images\n\n")
        f.write(f"nc: {len(taxonomy.CLASS_NAMES)}\nnames:\n")
        f.writelines(f"  - {n}\n" for n in taxonomy.CLASS_NAMES)
    return boxes


def train_det_phase(dev, tmp: str, frames: list, launches_by_path: dict):
    """cli.train_det at the CLI's widths (YOLOv8n, 64 classes, imgsz 640,
    batch 16, bf16) for two epochs of four steps, evaluated every epoch, then
    resumed to a third; counted. -> (dataset root, the first eval batch's
    decoded boxes and scores)."""
    from manual_yolo_tpu_torch.cli import train_det as train_det_cli
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.train import data as data_lib
    from manual_yolo_tpu_torch.train import detector as det_train

    root = os.path.join(tmp, "yolo")
    n_boxes = write_yolo_dataset(root, frames, dev)
    names = data_lib.load_yolo_names(root)
    if names != dict(enumerate(taxonomy.CLASS_NAMES)) or n_boxes < 100:
        fail(f"the YOLO dataset reads {len(names)} names and holds {n_boxes} boxes")
    out = os.path.join(tmp, "det_run", "best.npz")
    argv = ["--data", root, "--out", out, "--scale", "n", "--imgsz", str(IMGSZ),
            "--batch", str(TRAIN_DET_BATCH), "--steps-per-epoch", str(TRAIN_DET_STEPS),
            "--eval-every", "1"]
    results, logs, eval_calls = [], [], []

    def with_log(f):
        def run(cfg, log=print):
            results.append(f(cfg, lambda line: (logs.append(line), print(line))))
            return results[-1]
        return run

    def record_nms(f):
        def run(boxes, scores, **kw):
            eval_calls.append((boxes.clone(), scores.clone(), kw))
            return f(boxes, scores, **kw)
        return run

    launches = 0
    for extra in ([], ["--resume"]):
        epochs = TRAIN_DET_EPOCHS + (1 if extra else 0)
        nms_kernel.nms_keep.launches = 0
        with wrapped(det_train, "train_detector", with_log), wrapped(det_train, "nms_batch", record_nms):
            rc = train_det_cli.main(argv + ["--epochs", str(epochs)] + extra)
        torch.cuda.synchronize()
        launches += nms_kernel.nms_keep.launches
        if rc != 0:
            fail(f"cli.train_det {' '.join(extra)} returned {rc}")
    launches_by_path["train_det"] = launches
    evals = TRAIN_DET_EPOCHS + 1
    per_eval = -(-TRAIN_DET_VALID // 8)
    if launches != evals * per_eval or len(eval_calls) != launches or \
            any(b.shape[0] != 8 for b, _, _ in eval_calls):
        fail(f"the trainer's evals made {launches} launches over {len(eval_calls)} nms_batch "
             f"calls, expected {evals} x {per_eval} at B=8")
    hist = results[0]["history"] + results[1]["history"]
    joined = "\n".join(logs)
    _, meta = load_params(os.path.join(tmp, "det_run", "last_n.npz"), dtype=None)
    if "epoch 3/3" not in joined or "resumed from" not in joined or meta["epoch"] != 3 or \
            meta["step"] != 3 * TRAIN_DET_STEPS:
        fail(f"the resumed run did not continue to epoch 3 (meta {meta['epoch']}, {meta['step']})")
    for h in hist:
        if not all(np.isfinite(h[k]) for k in ("loss", "box", "cls", "dfl")):
            fail(f"train_det epoch {h['epoch']} has a loss that is not finite: {h}")
    step_ms = [h["step_ms"] for h in hist]
    print(json.dumps({"train_det": {
        "scale": "n", "nc": len(names), "imgsz": IMGSZ, "batch": TRAIN_DET_BATCH, "dtype": "bfloat16",
        "train_frames": TRAIN_DET_TRAIN, "valid_frames": TRAIN_DET_VALID, "labelled_boxes": n_boxes,
        "steps_per_epoch": TRAIN_DET_STEPS, "epochs": [h["epoch"] for h in hist],
        "step_ms_median_by_epoch": step_ms,
        "batch_wait_ms_median_by_epoch": [h["wait_ms"] for h in hist],
        "batch_build_ms_median_by_epoch": [h["build_ms"] for h in hist],
        "images_per_s": TRAIN_DET_BATCH / (statistics.median(step_ms) / 1e3),
        "loss": [h["loss"] for h in hist], "box": [h["box"] for h in hist],
        "cls": [h["cls"] for h in hist], "dfl": [h["dfl"] for h in hist],
        "map50": [h["map50"] for h in hist], "map50_95": [h["map50_95"] for h in hist],
        "nms_keep_launches": launches, "resumed_to_epoch": meta["epoch"], "step": meta["step"]}}))
    return root, eval_calls[0]


def train_step_profile(dev, root: str) -> dict:
    """One torch.profiler trace of a bf16 detector train step at the CLI's
    widths (batch 16 at 640, 64 classes), on a batch built beforehand."""
    from manual_yolo_tpu_torch.train import data as data_lib
    from manual_yolo_tpu_torch.train import detector as det_train

    samples = data_lib.load_yolo_split(root, "train", max_side=IMGSZ * 3 // 2)
    x, t, m = (torch.from_numpy(a).to(dev) for a in data_lib.make_detect_batch(
        np.random.default_rng(0), samples, TRAIN_DET_BATCH, IMGSZ))
    model, opt, ema = train_models("detect", dev, torch.bfloat16)
    step = [0]

    def one():
        loss, _ = det_train.detect_step(model, ema, opt, x, t, m, step[0], TRAIN_LR)
        step[0] += 1
        return float(loss)

    one()
    return trace_once(one, "train_step")


def train_models(variant: str, device, dtype=torch.float32):
    """(train model, its AdamW, EMA twin or None) from the committed
    checkpoint, BN unfolded, as the trainers build them."""
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.train import classifier as cls_train
    from manual_yolo_tpu_torch.train.optim import adamw

    params, meta = load_params(DETECTOR_N if variant == "detect" else CLASSIFIER)
    spec = yolov8.build_spec(variant, "n", int(meta["spec"]["nc"]))

    def build():
        return yolov8.load_jax_params(yolov8.build_model(spec, dtype, train=True), params).to(device)

    model = build().train()
    if variant == "detect":
        return model, adamw(model.parameters(), 5e-4), build().eval()
    return model, adamw(cls_train.decay_groups(model, 5e-4), 5e-4), None


def three_f32_steps(variant: str, device, batch) -> tuple:
    """(losses, the first step's gradients by parameter name, trainable
    weights, BN running statistics) of three f32 steps from the committed
    checkpoint on ``batch``."""
    from manual_yolo_tpu_torch.train import classifier as cls_train
    from manual_yolo_tpu_torch.train import detector as det_train

    model, opt, ema = train_models(variant, device)
    inputs = [torch.from_numpy(a).to(device) for a in batch]
    flat = lambda ts: torch.cat([t.detach().flatten().cpu() for t in ts]).numpy()
    losses = []
    for k in range(3):
        if variant == "detect":
            loss = det_train.detect_step(model, ema, opt, *inputs, k, TRAIN_LR)[0]
        else:
            loss = cls_train.classify_step(model, opt, *inputs, TRAIN_LR)
        losses.append(float(loss))
        if k == 0:  # the first step's gradients (the detector's after its clip)
            grads = {n: p.grad.detach().flatten().cpu().numpy() for n, p in model.named_parameters()}
    stats = [b for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")]
    return losses, grads, flat(model.parameters()), flat(stats)


def train_f32_vs_cpu(dev, root: str) -> None:
    """Three f32 train steps (TF32 off) of each model from its committed
    checkpoint on one fixed batch, on the card and on the CPU."""
    from manual_yolo_tpu_torch.train import data as data_lib

    samples = data_lib.load_yolo_split(root, "train", max_side=IMGSZ * 3 // 2)
    det_batch = data_lib.make_detect_batch(np.random.default_rng(1), samples, TRAIN_F32_DET_BATCH, IMGSZ)
    z = np.load(MATCHED)
    cls_batch = (z["train_x"][:64].astype(np.float32) / 255.0, z["train_y"][:64].astype(np.int32))
    print(json.dumps({"detector_grad0_four_ways": detector_grad_diagnosis(dev, det_batch, "train_f32_vs_cpu's")}))
    report = {}
    for variant, batch in (("detect", det_batch), ("classify", cls_batch)):
        got, got_g, got_w, got_s = three_f32_steps(variant, dev, batch)
        again_g = three_f32_steps(variant, dev, batch)[1]
        ref, ref_g, ref_w, ref_s = three_f32_steps(variant, torch.device("cpu"), batch)
        loss_gap = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
        scale = max(float(np.abs(g).max()) for g in ref_g.values())
        by_tensor = {n: float(np.abs(got_g[n] - ref_g[n]).max()) / scale for n in ref_g}
        grad_gap = max(by_tensor.values())
        card_card = max(float(np.abs(got_g[n] - again_g[n]).max()) for n in ref_g) / scale
        dw = np.abs(got_w - ref_w)
        stat_gap = float((np.abs(got_s - ref_s) / np.maximum(np.abs(ref_s), 1.0)).max())
        share = float((dw > TRAIN_WEIGHT_ATOL).mean())
        report[variant] = {"batch": len(batch[0]), "card_losses": got, "cpu_losses": ref,
                           "loss_rel_gap": loss_gap, "grad0_gap_over_max": grad_gap,
                           "grad0_card_vs_card_over_max": card_card,
                           "grad0_gap_top": sorted(by_tensor.items(), key=lambda kv: -kv[1])[:4],
                           "weights": int(dw.size), "weight_gap_median": float(np.median(dw)),
                           "weight_gap_q999": float(np.quantile(dw, 0.999)),
                           "weight_gap_max": float(dw.max()), "weight_share_over_atol": share,
                           "bn_stat_rel_gap_max": stat_gap}
        if loss_gap[0] > TRAIN_LOSS0_RTOL or grad_gap > TRAIN_GRAD_TOL[variant] or \
                max(loss_gap) > TRAIN_LOSS_RTOL or np.median(dw) > TRAIN_WEIGHT_MEDIAN or \
                share > TRAIN_WEIGHT_SHARE or dw.max() > TRAIN_WEIGHT_MAX or stat_gap > TRAIN_STAT_RTOL:
            fail(f"{variant}: three f32 steps on the card against the CPU: {report[variant]}")
    print(json.dumps({"train_f32_vs_cpu": dict(
        report, loss0_rtol=TRAIN_LOSS0_RTOL, grad0_tol=TRAIN_GRAD_TOL, loss_rtol=TRAIN_LOSS_RTOL,
        weight_median=TRAIN_WEIGHT_MEDIAN, weight_atol=TRAIN_WEIGHT_ATOL,
        weight_share=TRAIN_WEIGHT_SHARE, weight_max=TRAIN_WEIGHT_MAX, bn_stat_rtol=TRAIN_STAT_RTOL)}))


def detector_first_grads(device, dtype, batch, cudnn: bool = True) -> tuple:
    """The detector's first-step gradients (before the clip) from the
    committed checkpoint on ``batch``, in ``dtype`` with TF32 off and cuDNN
    on or off: ({parameter name: f64 array}, SPPF cv1's output)."""
    from manual_yolo_tpu_torch.core.device import cudnn_enabled
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.train.loss import detection_loss

    params, meta = load_params(DETECTOR_N)
    spec = yolov8.build_spec("detect", "n", int(meta["spec"]["nc"]))
    model = yolov8.load_jax_params(yolov8.build_model(spec, dtype, train=True), params)
    model = model.to(device, dtype).train()
    seen = []
    model.layers[9].cv1.register_forward_hook(lambda m, i, o: seen.append(o.detach().float().cpu()))
    x, t, m = (torch.from_numpy(a).to(device) for a in batch)
    with full_f32(), cudnn_enabled(cudnn):
        loss, _ = detection_loss(model, x, t, m)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    named = {n: g.detach().double().cpu().numpy() for (n, _), g in zip(model.named_parameters(), grads)}
    return named, seen[0]


def pool_windows(y: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The k x k stride-1 windows of SPPF's pool (-inf padding) over y (N, C,
    H, W): (N, C, k*k, H*W) in window order."""
    import torch.nn.functional as F

    n, c = y.shape[:2]
    pad = F.pad(y, (k // 2,) * 4, value=float("-inf"))
    return F.unfold(pad.reshape(n * c, 1, *pad.shape[2:]), k).reshape(n, c, k * k, -1)


def sppf_ties(dev, y_card: torch.Tensor, y_cpu: torch.Tensor, k: int = 5) -> list:
    """SPPF's three chained pools from cv1's output, on the card from the
    card's and on the CPU from the CPU's: per pool, the windows, those whose
    maximum is tied exactly and those with another value within one f32 ulp
    of it (the CPU's input), the outputs whose argmax differs, how many of
    those have equal inputs on both devices, and how many differ when the
    card pools the CPU's own input."""
    import torch.nn.functional as F

    pool = lambda v: F.max_pool2d(v, k, 1, k // 2, return_indices=True)
    out, a, b = [], y_card, y_cpu
    for stage in range(3):
        (pa, ia), (pb, ib) = pool(a.to(dev)), pool(b)
        ctrl = pool(b.to(dev))[1].cpu()
        wa, wb = pool_windows(a.cpu(), k), pool_windows(b, k)
        top = wb.amax(dim=2, keepdim=True)
        ulp = torch.from_numpy(np.spacing(np.abs(top.numpy())))
        exact = (wb == top).sum(dim=2) > 1
        near = ((wb != top) & (top - wb <= ulp)).any(dim=2)
        flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1)
        differ = flat(ia.cpu()) != flat(ib)
        same_in = (wa == wb).all(dim=2)
        out.append({"pool": stage + 1, "windows": int(top.numel()), "exact_tie_windows": int(exact.sum()),
                    "near_tie_windows": int(near.sum()), "argmax_differ": int(differ.sum()),
                    "argmax_differ_equal_inputs": int((differ & same_in).sum()),
                    "argmax_differ_at_exact_ties": int((differ & exact).sum()),
                    "argmax_differ_at_near_ties": int((differ & near).sum()),
                    "card_pool_on_cpu_input_differ": int((flat(ctrl) != flat(ib)).sum()),
                    "input_max_abs_gap": float((a.cpu() - b).abs().max())})
        a, b = pa.cpu(), pb
    return out


def detector_grad_diagnosis(dev, batch, tag: str) -> dict:
    """The detector's first f32 gradients four ways (the card with and
    without cuDNN, the CPU in f32 and in f64): per leaf, each one's largest
    gap to f64 over the leaf's largest f64 gradient; the first leaf, going
    backward, where the card parts from the CPU by more than 1e-4 of the
    leaf's largest; the check's gap (over the largest gradient of all);
    and SPPF's ties (``sppf_ties``)."""
    g64, _ = detector_first_grads(torch.device("cpu"), torch.float64, batch)
    runs = {"card_cudnn": detector_first_grads(dev, torch.float32, batch, True),
            "card_no_cudnn": detector_first_grads(dev, torch.float32, batch, False),
            "cpu_f32": detector_first_grads(torch.device("cpu"), torch.float32, batch)}
    cpu = runs["cpu_f32"][0]
    top = max(float(np.abs(g).max()) for g in cpu.values())
    backward = list(reversed(list(g64)))
    report = {"batch": tag, "leaves": len(backward)}
    for name, (g, _) in runs.items():
        to64 = {n: float(np.abs(g[n] - g64[n]).max()) / max(float(np.abs(g64[n]).max()), 1e-30)
                for n in backward}
        worst = sorted(to64.items(), key=lambda kv: -kv[1])[:3]
        report[name] = {"max_leaf_gap_to_f64": worst[0][1], "worst_leaves": worst,
                        "median_leaf_gap_to_f64": float(np.median(list(to64.values())))}
        if name == "cpu_f32":
            continue
        to_cpu = {n: float(np.abs(g[n] - cpu[n]).max()) / max(float(np.abs(cpu[n]).max()), 1e-30)
                  for n in backward}
        parts = [n for n in backward if to_cpu[n] > 1e-4]
        report[name].update({
            "check_gap_over_max": max(float(np.abs(g[n] - cpu[n]).max()) for n in backward) / top,
            "first_leaf_parting_backward": parts[0] if parts else None,
            "its_gap_to_cpu": to_cpu[parts[0]] if parts else None,
            "leaves_parting": len(parts)})
    report["sppf_ties_card_cudnn"] = sppf_ties(dev, runs["card_cudnn"][1], runs["cpu_f32"][1])
    report["sppf_ties_card_no_cudnn"] = sppf_ties(dev, runs["card_no_cudnn"][1], runs["cpu_f32"][1])
    return report


def eval_det_phase(dev, root: str, launches_by_path: dict):
    """cli.eval_det of poker_detector_n on the dataset's valid split, f32, on
    the card (counted) and with --device cpu: the same mAP within 1e-3.
    -> the card's eval batch, decoded (boxes, scores)."""
    from manual_yolo_tpu_torch.cli import eval_det as eval_det_cli
    from manual_yolo_tpu_torch.train import detector as det_train

    argv = ["--weights", DETECTOR_N, "--data", root, "--split", "valid", "--imgsz", str(IMGSZ)]
    res, calls = {}, []

    def record_nms(f):
        def run(boxes, scores, **kw):
            calls.append((boxes.clone(), scores.clone()))
            return f(boxes, scores, **kw)
        return run

    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        buf = io.StringIO()
        nms_kernel.nms_keep.launches = 0
        with contextlib.redirect_stdout(buf), wrapped(det_train, "nms_batch", record_nms):
            rc = eval_det_cli.main(argv + extra)
        if name == "card":
            torch.cuda.synchronize()
            launches_by_path["eval_det"] = nms_kernel.nms_keep.launches
        text = buf.getvalue()
        if rc != 0:
            fail(f"cli.eval_det on the {name} returned {rc}: {text}")
        res[name] = json.loads(text[text.index("{"):])
    gaps = {k: abs(res["card"][k] - res["cpu"][k]) for k in ("map50", "map50_95")}
    if max(gaps.values()) > EVAL_MAP_TOL or launches_by_path["eval_det"] != -(-TRAIN_DET_VALID // 8):
        fail(f"cli.eval_det: card {res['card']} against CPU {res['cpu']}, "
             f"{launches_by_path['eval_det']} launches")
    print(json.dumps({"eval_det": {"card": res["card"], "cpu": res["cpu"], "gap": gaps,
                                   "nms_keep_launches": launches_by_path["eval_det"]}}))
    return calls[0]


# ---------------------------------------------------------------------------
# The reference's file formats: JPEG screenshots and an ultralytics .pt

JPEG_DIR = os.path.join(REPO, "tests", "torch_jpeg")
JPEG_SHOT = os.path.join(JPEG_DIR, "poker_labeled_420.jpg")
JPEG_REPS = 5
CLS_CONF_TOL = 1e-5


def test_helpers():
    """tests/torch_pt_cases.py and tests/torch_train_cases.py (no JAX, no cv2)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_pt_cases
    import torch_train_cases

    return torch_pt_cases, torch_train_cases


def host_ms(fn, reps: int = JPEG_REPS) -> float:
    """Median host-clock ms of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def jpeg_fixtures(tmp: str) -> dict:
    """Every committed JPEG fixture decodes to the bytes cv2.imread gives
    (tests/torch_jpeg/cv2_decode.json holds their SHA-256, written where cv2
    is); decode ms against png.imread_bgr's ms on the same frame as a PNG."""
    with open(os.path.join(JPEG_DIR, "cv2_decode.json")) as f:
        expected = json.load(f)["files"]
    out = {}
    for name, entry in sorted(expected.items()):
        path = os.path.join(JPEG_DIR, name)
        img = imread_bgr(path)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if digest != entry["sha256"] or list(img.shape) != entry["shape"]:
            fail(f"{name}: decoded {img.shape} sha256 {digest}, cv2.imread gives "
                 f"{entry['shape']} {entry['sha256']}")
        as_png = os.path.join(tmp, name + ".png")
        png.write_png(as_png, img)
        out[name] = {"shape": list(img.shape), "bytes": os.path.getsize(path),
                     "sampling": entry["sampling"], "progressive": entry["progressive"],
                     "restart_interval": entry["restart_interval"], "equal_cv2": True,
                     "jpeg_ms": host_ms(lambda: imread_bgr(path)),
                     "png_ms": host_ms(lambda: imread_bgr(as_png)),
                     "png_bytes": os.path.getsize(as_png)}
    print(json.dumps({"jpeg_decode": out}))
    return out


def pt_classifier(dev, tmp: str, frame: np.ndarray, cpu_dets) -> str:
    """A .pt written from the committed rank classifier (fp16 tensors, an
    ema entry) loads on the card; classify_crops on the example's rank crops
    (the boxes of ``cpu_dets``, the CPU f32 pipeline's at conf 0.25) equals
    the CPU's names with confidences within CLS_CONF_TOL, and the card's .pt
    logits equal its .npz logits. -> the .pt path."""
    from manual_yolo_tpu_torch.models.classifier import RankClassifier

    pt_cases, _ = test_helpers()
    pt = os.path.join(tmp, "rank_classifier_matched.pt")
    pt_cases.write_from_npz(pt, CLASSIFIER, ema="model_off")
    t0 = time.perf_counter()
    card = RankClassifier.from_torch_checkpoint(pt, device=dev)
    load_s = time.perf_counter() - t0
    cpu_clf = RankClassifier.from_torch_checkpoint(pt, device="cpu")
    npz = RankClassifier.from_npz(CLASSIFIER, device=dev)
    crops = []
    for d in cpu_dets:
        if d["class_name"] in taxonomy.RANK_CLASSES:
            x1, y1, x2, y2 = (int(round(v)) for v in d["bbox"])
            crops.append(frame[max(y1, 0):y2, max(x1, 0):x2])
    if len(crops) < 6:
        fail(f"the example gave {len(crops)} rank crops")
    got, ref = card.classify_crops(crops), cpu_clf.classify_crops(crops)
    gap = max(abs(g[1] - r[1]) for g, r in zip(got, ref))
    if [n for n, _ in got] != [n for n, _ in ref] or gap > CLS_CONF_TOL:
        fail(f"classify_crops on the card {got} against the CPU {ref}")
    batch = torch.rand(8, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    if not torch.equal(card.logits(batch), npz.logits(batch)) or card.names != npz.names:
        fail("the .pt classifier's logits or names differ from the .npz classifier's on the card")
    print(json.dumps({"pt_classifier": {
        "load_s": load_s, "crops": len(crops), "names": [n for n, _ in got],
        "conf_max_gap_vs_cpu": gap, "equal_npz_logits": True,
        "classify_crops_ms": host_ms(lambda: card.classify_crops(crops))}}))
    return pt


def jpeg_shot(dev, tmp: str, pt: str, launches_by_path: dict) -> None:
    """cli.shot on the JPEG example with the .pt classifier (counted: one
    launch) gives the result of cli.shot on the same decoded pixels as a PNG
    with the .npz classifier, the time field aside."""
    from manual_yolo_tpu_torch.cli import shot as shot_cli

    pixels = os.path.join(tmp, "jpeg_pixels.png")
    png.write_png(pixels, imread_bgr(JPEG_SHOT))
    results = {}
    for name, image, clf in (("png_npz", pixels, CLASSIFIER), ("jpeg_pt", JPEG_SHOT, pt)):
        out_json = os.path.join(tmp, f"{name}.json")
        buf = io.StringIO()
        nms_kernel.nms_keep.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = shot_cli.main(["--image", image, "--classifier", clf, "--output-json", out_json,
                                "--output-image", "", "--device", dev.type])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli.shot on {name} returned {rc}")
        with open(out_json) as f:
            results[name] = (json.load(f), nms_kernel.nms_keep.launches, wall_s)
    (a, _, _), (b, launches, wall_s) = results["png_npz"], results["jpeg_pt"]
    if {k: v for k, v in a.items() if k != "time"} != {k: v for k, v in b.items() if k != "time"}:
        fail(f"cli.shot on the JPEG with the .pt differs from the PNG with the .npz:\n{a}\n{b}")
    if launches != 1:
        fail(f"cli.shot on the JPEG made {launches} nms_keep launches, expected 1")
    launches_by_path["jpeg_shot"] = launches
    print(json.dumps({"jpeg_shot": {"image": os.path.relpath(JPEG_SHOT, REPO),
                                    "classifier": ".pt (fp16, ema)", "nms_keep_launches": launches,
                                    "cli_wall_s": wall_s, "equal_png_npz": True,
                                    "fields": len(b)}}))


def matched_phase(dev, tmp: str) -> None:
    """build_matched_rank_dataset on the card equals its CPU run, on a YOLO
    set whose screenshots are the committed JPEG fixtures (labels and rank
    crop names written here)."""
    from manual_yolo_tpu_torch.train.matched_crops import build_matched_rank_dataset

    _, train_cases = test_helpers()
    det_root, rank_root = os.path.join(tmp, "matched_det"), os.path.join(tmp, "matched_rank")
    shots = [os.path.join(JPEG_DIR, f) for f in
             ("poker_labeled_420.jpg", "poker_labeled_progressive.jpg", "frame_1200x1920.jpg")]
    train_cases.matched_sources(det_root, rank_root, shots)
    out = {}
    for split, jitter in (("train", 2), ("valid", 0)):
        runs = {}
        for name, device in (("card", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                runs[name] = build_matched_rank_dataset(rank_root, det_root, split,
                                                        jitter=jitter, device=device)
            runs[name + "_s"] = time.perf_counter() - t0
        (x, y, names), (rx, ry, rnames) = runs["card"], runs["cpu"]
        if names != rnames or not np.array_equal(y, ry) or not np.array_equal(x, rx):
            fail(f"build_matched_rank_dataset[{split}] on the card differs from the CPU: "
                 f"{int((x != rx).sum()) if x.shape == rx.shape else x.shape} bytes")
        out[split] = {"crops": len(y), "classes": len(set(y.tolist())), "equal_cpu": True,
                      "card_s": runs["card_s"], "cpu_s": runs["cpu_s"]}
    print(json.dumps({"matched_crops": out}))


SHOT_REPS = 5
LIVE_SHOT_FRAMES = 4
# the stubbed LLM's raw answer by field kind; the shot validates it per kind
LLM_ANSWER = {"card": "a", "numeric": "1.2k", "name": "bob_99", "game_id": "Game ID : 987654321"}


def drawn_mask(shape, dets) -> np.ndarray:
    """Where annotate() may draw: each box's 2-px frame and its label's
    text_size box above it."""
    mask = np.zeros(shape[:2], bool)
    for d in dets:
        x1, y1, x2, y2 = d["bbox"]
        mask[max(0, min(y1, y2) - 1):max(y1, y2) + 2, max(0, min(x1, x2) - 1):max(x1, x2) + 2] = True
        (w, h), base = draw.text_size(f"{d['class_name']}:{d.get('ocr_text') or ''}", 0.5)
        oy = max(0, y1 - 5)
        mask[max(0, oy - h):max(0, oy + base + 1), max(0, x1):max(0, x1 + w)] = True
    return mask


@contextlib.contextmanager
def recording_pipelines():
    """Every FusedPipeline.process_frame call in the block appends its
    detections (the same dicts) to the yielded list."""
    from manual_yolo_tpu_torch.runtime.pipeline import FusedPipeline

    seen, inner = [], FusedPipeline.process_frame

    def record(self, frame):
        dets = inner(self, frame)
        seen.append(dets)
        return dets

    FusedPipeline.process_frame = record
    try:
        yield seen
    finally:
        FusedPipeline.process_frame = inner


def annotated_shot(dev, tmp: str, gpu, gpu_ocr, launches_by_path: dict) -> None:
    """cli.shot on the example with its default --output-image, run in a
    scratch directory (counted: one launch): poker_labeled.png, read back
    with the port's reader, equals annotate() of the run's detections and
    the input frame outside the drawn boxes and labels; again with
    --output-image x.jpg: the file is encode_jpeg of the same annotation.
    The wall time the image adds to process_screenshot with OCR, and
    annotate() and the PNG write alone."""
    from manual_yolo_tpu_torch.cli import shot as shot_cli

    frame = imread_bgr(IMAGE)
    out, cwd = {}, os.getcwd()
    for tag, flags in (("default_png", []), ("jpg", ["--output-image", "x.jpg"])):
        run_dir = os.path.join(tmp, f"annotated_{tag}")
        os.makedirs(run_dir)
        os.chdir(run_dir)
        try:
            with recording_pipelines() as seen, contextlib.redirect_stdout(io.StringIO()):
                nms_kernel.nms_keep.launches = 0
                t0 = time.perf_counter()
                rc = shot_cli.main(["--image", IMAGE, "--device", dev.type, *flags])
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            launches = nms_kernel.nms_keep.launches
        finally:
            os.chdir(cwd)
        if rc != 0 or launches != 1 or len(seen) != 1:
            fail(f"cli.shot {tag}: rc {rc}, {launches} nms_keep launches, {len(seen)} frames")
        dets = seen[0]
        want = shot_mod.annotate(frame, dets)
        if tag == "default_png":
            got = imread_bgr(os.path.join(run_dir, "poker_labeled.png"))
            if not np.array_equal(got, want):
                fail(f"poker_labeled.png differs from annotate() in {int((got != want).any(-1).sum())} px")
            outside = ~drawn_mask(frame.shape, dets)
            if not np.array_equal(got[outside], frame[outside]):
                fail("poker_labeled.png differs from the input outside the drawn boxes and labels")
            changed = int((got != frame).any(-1).sum())
        else:
            with open(os.path.join(run_dir, "x.jpg"), "rb") as f:
                if f.read() != jpeg.encode_jpeg(want):
                    fail("cli.shot --output-image x.jpg is not encode_jpeg of the annotation")
        if not os.path.exists(os.path.join(run_dir, "poker_result.json")):
            fail(f"cli.shot {tag} wrote no poker_result.json")
        launches_by_path[f"annotated_shot_{tag}"] = launches
        out[tag] = {"nms_keep_launches": launches, "cli_wall_s": wall_s, "detections": len(dets)}
    # the added wall time: with and without the image, in turns
    with_ms, without_ms = [], []
    png_out = os.path.join(tmp, "timed_labeled.png")
    for i in range(2 * SHOT_REPS + 2):
        image = png_out if i % 2 == 0 else None
        t0 = time.perf_counter()
        process_screenshot(gpu, IMAGE, os.path.join(tmp, "timed.json"), output_image=image,
                           ocr=gpu_ocr, use_llm_fallback=False)
        if i >= 2:
            (with_ms if image else without_ms).append((time.perf_counter() - t0) * 1e3)
    dets = gpu.process_frame(frame)
    annotated = shot_mod.annotate(frame, dets)
    print(json.dumps({"annotated_shot": dict(
        out, pixels_changed=changed, equal_annotate=True, outside_equal_input=True,
        shot_with_image_ms=statistics.median(with_ms),
        shot_without_image_ms=statistics.median(without_ms),
        added_ms=statistics.median(with_ms) - statistics.median(without_ms),
        annotate_ms=host_ms(lambda: shot_mod.annotate(frame, dets)),
        png_write_ms=host_ms(lambda: png.write_png(png_out, annotated)),
        jpeg_write_ms=host_ms(lambda: jpeg.write_jpeg(os.path.join(tmp, "t.jpg"), annotated)))}))


def jpeg_encode_phase(tmp: str) -> dict:
    """encode_jpeg of the committed cases (the example and the seeded
    1200x1920 frame at 95 and 85, a gray crop at 50) gives the SHA-256 of
    cv2.imencode's bytes in tests/torch_jpeg/cv2_encode.json (this host has
    no cv2); encode ms, median of 5, against png.write_png of the same array."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_encode_cases as enc

    committed = enc.load_hashes()["cases"]
    src = enc.sources(imread_bgr)
    out = {}
    for name, (source, quality) in enc.CASES.items():
        img = src[source]
        data = jpeg.encode_jpeg(img, quality)
        digest = hashlib.sha256(data).hexdigest()
        if digest != committed[name]["sha256"] or len(data) != committed[name]["bytes"]:
            fail(f"encode_jpeg {name}: {len(data)} bytes sha256 {digest}, cv2.imencode writes "
                 f"{committed[name]['bytes']} {committed[name]['sha256']}")
        as_png = os.path.join(tmp, name + ".png")
        out[name] = {"shape": list(img.shape), "quality": quality, "bytes": len(data),
                     "equal_cv2": True,
                     "encode_ms": host_ms(lambda: jpeg.encode_jpeg(img, quality)),
                     "png_write_ms": host_ms(lambda: png.write_png(as_png, img)),
                     "png_bytes": os.path.getsize(as_png)}
    print(json.dumps({"jpeg_encode": out}))
    return out


class FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def llm_fallback_phase(dev, tmp: str, gpu, launches_by_path: dict) -> None:
    """A screenshot on the card with use_llm_fallback=True and no OCR (so
    the important fields are empty), with urllib.request.urlopen stubbed (no
    network) and a key set (counted: one launch): one request goes out; its
    image is encode_jpeg of the collage at 85; the stub's answer, validated
    per kind, fills each escalated field of the result JSON."""
    import base64
    import urllib.request

    sent, collages, asked = [], [], []
    inner_collage, inner_urlopen = llm_fallback.build_collage, urllib.request.urlopen
    old_key = os.environ.get("OPENAI_API_KEY")
    answer = {k: LLM_ANSWER[field_kind(k)] for k in llm_fallback.IMPORTANT_KEYS
              if field_kind(k) in LLM_ANSWER}

    def stub_urlopen(req, timeout=None):
        sent.append(req)
        body = {"choices": [{"message": {"content": json.dumps(answer)}}]}
        return FakeResponse(json.dumps(body).encode())

    def collage(crops):
        asked.extend(k for k, _ in crops)
        collages.append(inner_collage(crops))
        return collages[-1]

    llm_fallback.build_collage = collage
    urllib.request.urlopen = stub_urlopen
    os.environ["OPENAI_API_KEY"] = "sk-chip-smoke"
    try:
        with recording_pipelines() as seen:
            nms_kernel.nms_keep.launches = 0
            t0 = time.perf_counter()
            result = process_screenshot(gpu, IMAGE, os.path.join(tmp, "llm.json"),
                                        output_image=None, use_llm_fallback=True)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = nms_kernel.nms_keep.launches
    finally:
        llm_fallback.build_collage, urllib.request.urlopen = inner_collage, inner_urlopen
        if old_key is None:
            os.environ.pop("OPENAI_API_KEY", None)
        else:
            os.environ["OPENAI_API_KEY"] = old_key
    if len(sent) != 1 or len(collages) != 1 or launches != 1 or len(seen) != 1:
        fail(f"the LLM shot sent {len(sent)} requests of {len(collages)} collages in "
             f"{launches} launches over {len(seen)} frames, expected 1 of each")
    url = json.loads(sent[0].data)["messages"][1]["content"][1]["image_url"]["url"]
    if base64.b64decode(url.split(",", 1)[1]) != jpeg.encode_jpeg(collages[0], 85):
        fail("the request's image is not encode_jpeg of the collage at 85")
    filled = {}
    for d in (d for d in seen[0] if d["class_name"] in asked):
        name = d["class_name"]
        want = OCREngine._validate(field_kind(name), name.lower(), answer[name])
        if d["ocr_text"] != want:
            fail(f"{name}: the LLM filled {d['ocr_text']!r}, expected {want!r}")
        where = json_field(name)
        if where is not None:
            node = result
            for k in where:
                node = node[k]
            if node != want:
                fail(f"{name}: the result JSON holds {node!r} at {where}, expected {want!r}")
            filled[name] = want
    if len(filled) < 5:
        fail(f"the LLM shot filled only {filled}")
    launches_by_path["llm_fallback"] = launches
    print(json.dumps({"llm_fallback": {"requests": 1, "escalated": len(asked),
                                       "collage_shape": list(collages[0].shape),
                                       "request_bytes": len(sent[0].data),
                                       "image_equal_encode_jpeg": True, "filled": filled,
                                       "nms_keep_launches": launches, "wall_s": wall_s}}))


def live_screenshots(dev, tmp: str, gpu_live, gpu_ocr, frames, launches_by_path: dict) -> None:
    """LiveLoop(save_screenshots=True, screenshot_interval=0) over 4 frames
    as cli/detect.py builds it (counted: one launch a frame): 4 .jpg files,
    each encode_jpeg of its frame and each read back by the port's reader;
    the step with the screenshot against live_ms's."""
    out_dir = os.path.join(tmp, "live_shots")
    loop = LiveLoop(pipeline=gpu_live, output_dir=out_dir, ocr=gpu_ocr, game_update_interval=0.5,
                    screenshot_interval=0.0, save_screenshots=True)
    nms_kernel.nms_keep.launches = 0
    ms = []
    try:
        for frame in frames:
            t0 = time.perf_counter()
            loop.step(frame)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        loop.close()
    torch.cuda.synchronize()
    launches = nms_kernel.nms_keep.launches
    shots = sorted((f for f in os.listdir(out_dir) if f.endswith(".jpg")),
                   key=lambda f: int(f.split("_")[2]))
    if launches != len(frames) or len(shots) != len(frames) or loop.errors:
        fail(f"the live loop wrote {len(shots)} screenshots over {len(frames)} frames in "
             f"{launches} launches, {loop.errors} caught errors")
    for name, frame in zip(shots, frames):
        path = os.path.join(out_dir, name)
        with open(path, "rb") as f:
            if f.read() != jpeg.encode_jpeg(frame):
                fail(f"{name} is not encode_jpeg of its frame")
        back = imread_bgr(path)
        if back.shape != frame.shape:
            fail(f"{name} reads back as {back.shape}")
    launches_by_path["live_screenshots"] = launches
    print(json.dumps({"live_screenshots": {
        "frames": len(frames), "files": shots, "nms_keep_launches": launches,
        "step_ms": ms, "bytes": [os.path.getsize(os.path.join(out_dir, f)) for f in shots],
        "encode_ms": host_ms(lambda: jpeg.encode_jpeg(frames[0]))}}))


def unlabel_phase(root: str, tmp: str) -> None:
    """cli.unlabel on the YOLO dataset of the training phase: one crop per
    rank label whose box holds pixels, each the encode_jpeg of its frame
    slice (the reference's arithmetic)."""
    from manual_yolo_tpu_torch.cli import unlabel as unlabel_cli
    from manual_yolo_tpu_torch.train.data import load_yolo_names

    out_dir = os.path.join(tmp, "unlabel")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = unlabel_cli.main(["--data", root, "--split", "train", "--out", out_dir])
    wall_s = time.perf_counter() - t0
    names = load_yolo_names(root)
    want = {}
    img_dir, lbl_dir = os.path.join(root, "train", "images"), os.path.join(root, "train", "labels")
    for label_file in sorted(os.listdir(lbl_dir)):
        stem = label_file[:-4]
        frame = imread_bgr(os.path.join(img_dir, stem + ".png"))
        h, w = frame.shape[:2]
        with open(os.path.join(lbl_dir, label_file)) as f:
            for idx, line in enumerate(f.read().splitlines()):
                parts = line.split()
                cls = int(float(parts[0]))
                if not names[cls].endswith("_rank"):
                    continue
                xc, yc, bw, bh = (float(v) for v in parts[1:5])
                x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
                x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
                crop = frame[max(0, y1):y2, max(0, x1):x2]
                if crop.size:
                    want[f"{stem}_{names[cls]}_{idx}.jpg"] = crop
    got = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if rc != 0 or got != sorted(want) or len(got) < 10:
        fail(f"cli.unlabel returned {rc} and wrote {len(got)} crops, expected {len(want)}")
    for name, crop in want.items():
        with open(os.path.join(out_dir, name), "rb") as f:
            if f.read() != jpeg.encode_jpeg(crop):
                fail(f"cli.unlabel's {name} is not encode_jpeg of its frame slice")
    print(json.dumps({"unlabel": {"crops": len(got), "rank_labels": len(want),
                                  "equal_encode_jpeg": True, "wall_s": wall_s}}))


# OCR training and evaluation (train/ocr.py, train/craft.py, cli/eval_*.py).
# The trainers run as their CLIs call them, at the CLIs' widths, cut in
# pool size and steps (PERF.md section 4)
OCR_TRAIN = dict(hidden=256, width=256, img_h=32, batch=64, pool=2048, steps=120, eval_every=40)
CRAFT_TRAIN = dict(size=256, batch=8, pool=256, steps=40, eval_every=20)
OCR_EVAL_SPLITS = ("test", "valid", "test2", "train_fit", "train_holdout")
# three f32 steps, card against CPU, from the same parameters and batches.
# The first gradient on each device is held against the CPU's f64 one, each
# leaf's error taken relative to its largest: the card's worst leaf at most
# twice the CPU's worst, or 1e-4 (CRAFT's f32 gradients are ill-conditioned:
# the CPU's own f32 lies up to 12% of a leaf's largest from f64, at ext.0,
# and which leaves the two devices round worse differs). The first
# loss within 1e-5 relative, the later within 1e-3; then AdamW moves an
# element whose gradient the devices round apart near 0 by up to lr each
# step: every parameter within 2 x the summed learning rates (and 1e-6 for
# the weights' f32 rounding), the running statistics within 1e-2 relative
OCR_LOSS0_RTOL, OCR_LOSS_RTOL, OCR_GRAD_FLOOR, OCR_STAT_RTOL = 1e-5, 1e-3, 1e-4, 1e-2
# the batches of those steps: the CPU side runs them too, and an f64 gradient
OCR_F32_BATCH, CRAFT_F32_BATCH = 16, 2


def write_ocr_eval_set(root: str) -> str:
    """A stand-in for the reference's labelled OCR set: the example saved as a
    JPEG (encode_jpeg, quality 95) under test/, valid/ and two train/ stems,
    one on each side of eval_ocr's md5 holdout; YOLO labels of the CPU f32
    detections of poker_detector_n at conf 0.25 on the decoded JPEG; a
    data.yaml of the taxonomy's names; labels.json in data/ocr_real's
    schema (an item per text-field row, and a "test2" item at the game id
    box, eval_ocr.TEST2 being the example PNG). -> labels.json's path."""
    from manual_yolo_tpu_torch.cli import eval_craft, eval_ocr

    data = jpeg.encode_jpeg(imread_bgr(IMAGE), 95)
    frame, _ = native.jpeg_decode(data)
    engine = DetectorEngine.from_npz(DETECTOR_N, imgsz=IMGSZ, conf=0.25, compute_dtype="float32",
                                     device="cpu")
    dets = engine.detect_to_list(frame)
    h, w = frame.shape[:2]
    lines = [f"{d['class_id']} {(d['x1'] + d['x2']) / 2 / w:.6f} {(d['y1'] + d['y2']) / 2 / h:.6f} "
             f"{(d['x2'] - d['x1']) / w:.6f} {(d['y2'] - d['y1']) / h:.6f}\n" for d in dets]
    cands = [f"ex_train{i}" for i in range(16)]
    stems = {"test": ["ex_test"], "valid": ["ex_valid"],
             "train": [next(c for c in cands if eval_ocr._train_holdout(c)),
                       next(c for c in cands if not eval_ocr._train_holdout(c))]}
    items = []
    for split, names in stems.items():
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for stem in names:
            with open(os.path.join(root, split, "images", stem + ".jpg"), "wb") as f:
                f.write(data)
            with open(os.path.join(root, split, "labels", stem + ".txt"), "w") as f:
                f.writelines(lines)
            for row, d in enumerate(dets):
                if eval_craft._is_text(d["class_name"]):
                    kind = field_kind(d["class_name"])
                    text = {"numeric": "1,250", "name": "Player_1", "game_id": "232025507"}.get(kind, "A")
                    items.append({"src": f"{split}/{stem}", "row": row, "class": d["class_name"],
                                  "text": text})
    items.append({"src": "test2", "bbox": GAME_ID_BOX, "class": "game_id",
                  "text": "Game ID : 232025507"})
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(f"nc: {len(taxonomy.CLASS_NAMES)}\nnames:\n")
        f.writelines(f"  - {n}\n" for n in taxonomy.CLASS_NAMES)
    labels = os.path.join(root, "labels.json")
    with open(labels, "w") as f:
        json.dump({"items": items}, f)
    return labels


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_paths(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}.{i}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def compare_f32_steps(tag: str, card: list, cpu: list, ref64: dict, lrs: list) -> dict:
    """Hold three f32 steps on the card against the CPU's: ``card`` and
    ``cpu`` are lists of (loss, first-step gradient tree or None, parameter
    tree after the step), ``ref64`` the first gradient in f64 on the CPU.
    -> the measured differences."""
    out = {"loss_rel": [], "grad_err_card": 0.0, "grad_err_cpu": 0.0, "grad_worst_leaf": None,
           "param_max": [], "param_median": [], "stat_rel_max": []}
    for k, ((l_c, g_c, p_c), (l_r, g_r, p_r)) in enumerate(zip(card, cpu)):
        rel = abs(l_c - l_r) / max(abs(l_r), 1e-12)
        out["loss_rel"].append(rel)
        if rel > (OCR_LOSS0_RTOL if k == 0 else OCR_LOSS_RTOL):
            fail(f"{tag} step {k + 1}: loss {l_c} on the card, {l_r} on the CPU")
        if g_c is not None:
            for (path, a), (_, b), (_, r) in zip(_leaf_paths(g_c), _leaf_paths(g_r), _leaf_paths(ref64)):
                scale = max(float(np.abs(r).max()), 1e-30)
                e_card = float(np.abs(a - r).max()) / scale
                e_cpu = float(np.abs(b - r).max()) / scale
                if e_card > out["grad_err_card"]:
                    out["grad_err_card"], out["grad_worst_leaf"] = e_card, path
                out["grad_err_cpu"] = max(out["grad_err_cpu"], e_cpu)
            if out["grad_err_card"] > max(2 * out["grad_err_cpu"], OCR_GRAD_FLOOR):
                fail(f"{tag} first gradient: the card's {out['grad_err_card']} of a leaf's "
                     f"largest from f64 (at {out['grad_worst_leaf']}), the CPU's "
                     f"{out['grad_err_cpu']}")
        diffs, stat, worst = [], 0.0, (0.0, None)
        for (path, a), (_, b) in zip(_leaf_paths(p_c), _leaf_paths(p_r)):
            if path.endswith(".mean") or path.endswith(".var"):
                stat = max(stat, float((np.abs(a - b) / (1 + np.abs(b))).max()))
            else:
                diffs.append(np.abs(a - b).reshape(-1))
                if diffs[-1].max() >= worst[0]:
                    worst = (float(diffs[-1].max()), path)
        d = np.concatenate(diffs)
        out["param_max"].append(float(d.max()))
        out["param_max_leaf"] = worst[1]
        out["param_median"].append(float(np.median(d)))
        out["stat_rel_max"].append(stat)
        if d.max() > 2 * sum(lrs[:k + 1]) + 1e-6 or stat > OCR_STAT_RTOL:
            fail(f"{tag} step {k + 1}: parameters {d.max()} apart (at {worst[1]}; "
                 f"{int((d > 2 * sum(lrs[:k + 1])).sum())} of {d.size} elements over the "
                 f"bound), running statistics {stat} relative")
    return out


def ocr_first_grads(device, dtype, model_params, batch):
    """The CRNN's first gradient tree in ``dtype`` on ``device``, computed as
    a train step computes it (``train.ocr.step_numerics``)."""
    from manual_yolo_tpu_torch.models import crnn
    from manual_yolo_tpu_torch.train import ocr as ocr_train

    model = crnn.for_training(crnn.from_jax_params(model_params, "cpu")).to(device, dtype).train()
    params = [p for p in model.parameters() if p.requires_grad]
    x, lab, lp = (torch.from_numpy(a).to(device) for a in batch)
    with ocr_train.step_numerics(torch.device(device)):
        loss = ocr_train.ctc_loss(model(x.to(dtype)[..., None]), lab, lp).mean()
        g = torch.autograd.grad(loss, params)
    named = dict(zip([n for n, p in model.named_parameters() if p.requires_grad], g))
    clone = crnn.CRNN(model.lstm.hidden_size).double()
    state = {n: (named[n] if n in named else t).detach().cpu().double()
             for n, t in model.state_dict().items()}
    clone.load_state_dict(state)
    return crnn.to_jax_params(clone)


def ocr_f32_steps(device, params0, batches, lrs) -> list:
    """Three f32 CRNN steps from ``params0`` on ``device``: [(loss, first
    gradient tree or None, parameters)]."""
    from manual_yolo_tpu_torch.models import crnn
    from manual_yolo_tpu_torch.train import ocr as ocr_train
    from manual_yolo_tpu_torch.train.optim import adamw

    model = crnn.for_training(crnn.from_jax_params(params0, device).train())
    params = [p for p in model.parameters() if p.requires_grad]
    opt = adamw(params, ocr_train.WEIGHT_DECAY)
    out = []
    for k, batch in enumerate(batches):
        x, lab, lp = (torch.from_numpy(a).to(device) for a in batch)
        grads = ocr_first_grads(device, torch.float32, params0, batch) if k == 0 else None
        loss = ocr_train.ocr_step(model, opt, params, x, lab, lp, lrs[k])
        out.append((float(loss), grads, crnn.to_jax_params(model)))
    return out


def craft_first_grads(device, dtype, params0, batch):
    """CRAFT's first gradient tree (f32 compute) in ``dtype`` on ``device``."""
    from manual_yolo_tpu_torch.models import craft

    model = craft.from_jax_params(params0, "cpu").to(device, dtype).train()
    model.compute_dtype = dtype
    params = list(model.parameters())
    x, y = (torch.from_numpy(a).to(device, dtype) for a in batch)
    with full_f32():
        g = torch.autograd.grad(torch.mean((model(x) - y) ** 2), params)
    for _, m in craft._convs(model):
        m.pending = None
    return {n: t.detach().double().cpu().numpy() for (n, _), t in zip(model.named_parameters(), g)}


def craft_f32_steps(device, params0, batches, lrs) -> list:
    """Three f32 CRAFT steps from ``params0`` on ``device``."""
    from manual_yolo_tpu_torch.models import craft
    from manual_yolo_tpu_torch.train import craft as craft_train
    from manual_yolo_tpu_torch.train.optim import adamw

    model = craft.from_jax_params(params0, device)
    params = list(model.parameters())
    opt = adamw(params, craft_train.WEIGHT_DECAY)
    out = []
    for k, (x, y) in enumerate(batches):
        grads = craft_first_grads(device, torch.float32, params0, (x, y)) if k == 0 else None
        xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        loss = craft_train.craft_step(model, opt, params, xd, yd, lrs[k])
        out.append((float(loss), grads, craft.to_jax_params(model)))
    return out


def train_ocr_phase(dev, tmp: str, frame_img: np.ndarray, cpu_dets) -> None:
    """cli.train_ocr at its widths (OCR_TRAIN), cut in pool and steps; the
    checkpoint through load_params and OCREngine; a profiled step; three f32
    steps card against CPU."""
    from manual_yolo_tpu_torch.cli import train_ocr as train_ocr_cli
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.models import crnn
    from manual_yolo_tpu_torch.train import ocr as ocr_train
    from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine

    c = OCR_TRAIN
    out = os.path.join(tmp, "ocr_run", "crnn.npz")
    results, saved = [], []
    with wrapped(ocr_train, "train_ocr",
                 lambda f: lambda cfg, log=print: results.append(f(cfg, log)) or results[-1]), \
         wrapped(ocr_train, "save_params",
                 lambda f: lambda path, params, meta=None: (saved.append(params), f(path, params, meta))):
        rc = train_ocr_cli.main([
            "--out", out, "--steps", str(c["steps"]), "--batch", str(c["batch"]),
            "--width", str(c["width"]), "--img-h", str(c["img_h"]), "--hidden", str(c["hidden"]),
            "--pool-size", str(c["pool"]), "--eval-every", str(c["eval_every"])])
    res = results[0] if results else {}
    hist = res.get("history", [])
    if rc != 0 or len(hist) != c["steps"] // c["eval_every"] or not saved:
        fail(f"cli.train_ocr returned {rc} with history {hist}")
    if not all(np.isfinite(h["ctc"]) for h in hist):
        fail(f"the CTC loss is not finite: {[h['ctc'] for h in hist]}")
    steady = (hist[-1]["train_s"] - hist[0]["train_s"]) / (c["steps"] - c["eval_every"])
    params, meta = load_params(out)
    if meta.get("hidden") != c["hidden"] or meta.get("width") != c["width"] or meta.get("img_h") != c["img_h"]:
        fail(f"the checkpoint's meta is {meta}")
    # the written file is to_jax_params of the model when it was saved, in f16
    for (path, a), (_, b) in zip(_leaf_paths(params), _leaf_paths(saved[-1])):
        if np.abs(a - b.astype(np.float16).astype(np.float32)).max() > 0:
            fail(f"the checkpoint's {path} is not the saved model's in f16")
    engine = OCREngine.from_npz(out, device=dev)
    crops, names = ocr_crops(frame_img, cpu_dets)
    reads = engine.read_fields_conf(crops, names)
    if engine.errors or len(reads) != len(crops):
        fail(f"the trained checkpoint's OCREngine caught {engine.errors} errors")
    # one profiled step at the trainer's shapes
    cfg = ocr_train.OCRTrainConfig(width=c["width"], hidden=c["hidden"], batch=c["batch"])
    pool = ocr_train.build_pool(np.random.default_rng(1), cfg, 3 * max(c["batch"], OCR_F32_BATCH))
    imgs = (np.clip(pool[0][..., 0] * 255 + 0.5, 0, 255).astype(np.uint8)).astype(np.float32) / 255
    model = crnn.for_training(crnn.from_jax_params(crnn.init_params(torch.Generator().manual_seed(0),
                                                                    c["hidden"]), dev).train())
    tparams = [p for p in model.parameters() if p.requires_grad]
    opt = adamw(tparams, ocr_train.WEIGHT_DECAY)
    x, lab, lp = (torch.from_numpy(a[:c["batch"]]).to(dev) for a in (imgs, pool[1], pool[2]))
    prof = trace_once(lambda: ocr_train.ocr_step(model, opt, tparams, x, lab, lp, 1e-4), "ocr_step")
    print(json.dumps({"train_ocr": {
        **c, "dtype": "float32", "pool_build_s": res["pool_s"],
        "pool_build_host_ms_per_sample": res["pool_s"] / c["pool"] * 1e3,
        "step_ms_after_warmup": steady * 1e3, "samples_per_s": c["batch"] / steady,
        "ctc": [h["ctc"] for h in hist], "exact_match": [h["exact"] for h in hist],
        "best_exact": res["best_exact"], "wall_s": res["wall_s"],
        "checkpoint_reads": [r[0] for r in reads][:8], "step_profile": prof}}))
    # three f32 steps on the card and the CPU, same parameters and batches
    sched = warmup_cosine(cfg.lr * 0.05, cfg.lr, 24, 120, cfg.lr * 0.02)
    lrs = [sched(k) for k in range(3)]
    params0 = crnn.init_params(torch.Generator().manual_seed(0), c["hidden"])
    b = OCR_F32_BATCH
    batches = [(imgs[k * b:(k + 1) * b], pool[1][k * b:(k + 1) * b], pool[2][k * b:(k + 1) * b])
               for k in range(3)]
    card = ocr_f32_steps(dev, params0, batches, lrs)
    cpu = ocr_f32_steps(torch.device("cpu"), params0, batches, lrs)
    ref64 = ocr_first_grads("cpu", torch.float64, params0, batches[0])
    print(json.dumps({"train_ocr_f32_vs_cpu": {"batch": b, "lrs": lrs,
                                               **compare_f32_steps("train_ocr", card, cpu, ref64, lrs)}}))


def train_craft_phase(dev, tmp: str, frame_img: np.ndarray) -> None:
    """cli.train_craft at its defaults (256x256, batch 8, bf16), cut in pool
    and steps; the running statistics moved; the checkpoint drives
    read_region; a profiled step; three f32 steps card against CPU."""
    from manual_yolo_tpu_torch.cli import train_craft as train_craft_cli
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.models import craft
    from manual_yolo_tpu_torch.train import craft as craft_train
    from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine

    c = CRAFT_TRAIN
    out = os.path.join(tmp, "craft_run", "craft.npz")
    results = []
    with wrapped(craft_train, "train_craft",
                 lambda f: lambda cfg, log=print: results.append(f(cfg, log)) or results[-1]):
        rc = train_craft_cli.main([
            "--out", out, "--steps", str(c["steps"]), "--batch", str(c["batch"]),
            "--size", str(c["size"]), "--pool-size", str(c["pool"]),
            "--eval-every", str(c["eval_every"])])
    res = results[0] if results else {}
    hist = res.get("history", [])
    if rc != 0 or len(hist) != c["steps"] // c["eval_every"] or not all(np.isfinite(h["mse"]) for h in hist):
        fail(f"cli.train_craft returned {rc} with history {hist}")
    params, meta = load_params(out)
    moved = {p: float(np.abs(a - (0.0 if p.endswith(".mean") else 1.0)).max())
             for p, a in _leaf_paths(params) if p.endswith(".mean") or p.endswith(".var")}
    if meta.get("size") != c["size"] or min(moved.values()) <= 0:
        fail(f"the checkpoint's meta is {meta}, or a running statistic did not move: {moved}")
    engine = OCREngine.from_npz(os.path.join(REPO, "weights", "crnn_real_a.npz"),
                                text_detector=out, device=dev)
    x1, y1, x2, y2 = PANEL_BOX
    lines = engine.read_region(frame_img[y1:y2, x1:x2], "generic")
    steady = (hist[-1]["train_s"] - hist[0]["train_s"]) / (c["steps"] - c["eval_every"])
    cfg = craft_train.CraftTrainConfig(size=c["size"], pool_size=3 * c["batch"])
    imgs, heats, _ = craft_train.build_pool(np.random.default_rng(2), cfg)
    q = lambda a: np.clip(a * 255 + 0.5, 0, 255).astype(np.uint8).astype(np.float32) / 255  # noqa: E731
    imgs, heats = q(imgs), q(heats)
    model = craft.from_jax_params(craft.init_params(torch.Generator().manual_seed(0)), dev)
    model.compute_dtype = torch.bfloat16
    tparams = list(model.parameters())
    opt = adamw(tparams, craft_train.WEIGHT_DECAY)
    xb, yb = torch.from_numpy(imgs[:c["batch"]]).to(dev), torch.from_numpy(heats[:c["batch"]]).to(dev)
    prof = trace_once(lambda: craft_train.craft_step(model, opt, tparams, xb, yb, 1e-5), "craft_step")
    print(json.dumps({"train_craft": {
        **c, "dtype": "bfloat16", "pool_build_s": res["pool_s"],
        "step_ms_after_warmup": steady * 1e3, "scenes_per_s": c["batch"] / steady,
        "mse": [h["mse"] for h in hist], "line_f1": [h["line_f1"] for h in hist],
        "best_line_f1": res["best_line_f1"], "wall_s": res["wall_s"],
        "running_stats_moved_min": min(moved.values()), "read_region_lines": len(lines),
        "step_profile": prof}}))
    sched = warmup_cosine(5e-4 * 0.05, 5e-4, 8, 40, 5e-4 * 0.05)
    lrs = [sched(k) for k in range(3)]
    params0 = craft.init_params(torch.Generator().manual_seed(0))
    b = CRAFT_F32_BATCH
    batches = [(imgs[k * b:(k + 1) * b], heats[k * b:(k + 1) * b]) for k in range(3)]
    card = craft_f32_steps(dev, params0, batches, lrs)
    cpu = craft_f32_steps(torch.device("cpu"), params0, batches, lrs)
    ref64 = craft_first_grads("cpu", torch.float64, params0, batches[0])
    print(json.dumps({"train_craft_f32_vs_cpu": {"batch": b, "lrs": lrs,
                                                 **compare_f32_steps("train_craft", card, cpu, ref64,
                                                                     lrs)}}))


def ocr_eval_phase(dev, tmp: str, cpu_ocr) -> None:
    """cli.eval_ocr and cli.eval_craft on the stand-in set, on the card and the
    CPU: the same rows (confidences within OCR_CONF_TOL) and scores."""
    from manual_yolo_tpu_torch.cli import eval_craft, eval_ocr

    root = os.path.join(tmp, "ocr_eval")
    labels = write_ocr_eval_set(root)
    weights = os.path.join(REPO, "weights", "craft_real.npz")
    res, ms = {}, {}
    with wrapped(eval_ocr, "TEST2", lambda _: IMAGE):
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            engine = default_ocr_engine(device=device)
            t0 = time.perf_counter()
            res[name] = eval_ocr.evaluate_real(engine, labels, 0.35, splits=OCR_EVAL_SPLITS,
                                               dataset_root=root)
            ms[name] = (time.perf_counter() - t0) * 1e3
            if engine.errors:
                fail(f"eval_ocr's engine caught {engine.errors} errors on the {name}")
        rc = eval_ocr.main(["--labels", labels, "--dataset-root", root, "--splits",
                            ",".join(OCR_EVAL_SPLITS), "--sweep-gates"])
    rows_c, rows_r = res["card"].pop("rows"), res["cpu"].pop("rows")
    if rc != 0 or len(rows_c) != len(rows_r) or len(rows_r) < 20:
        fail(f"cli.eval_ocr returned {rc}; {len(rows_c)} rows on the card, {len(rows_r)} on the CPU")
    for a, b in zip(rows_c, rows_r):
        if {k: v for k, v in a.items() if k != "conf"} != {k: v for k, v in b.items() if k != "conf"} \
                or abs(a["conf"] - b["conf"]) > OCR_CONF_TOL:
            fail(f"eval_ocr row on the card {a}, on the CPU {b}")
    if res["card"]["per_kind"] != res["cpu"]["per_kind"] or \
            eval_ocr.gate_sweep(rows_c) != eval_ocr.gate_sweep(rows_r):
        fail("eval_ocr's scores or gate sweep differ card against CPU")
    craft_res, craft_ms = {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        craft_res[name] = eval_craft.evaluate(weights, splits=("test", "valid"), device=device,
                                              dataset_root=root)
        craft_ms[name] = (time.perf_counter() - t0) * 1e3
    if craft_res["card"] != craft_res["cpu"] or craft_res["cpu"]["regions"] < 10:
        fail(f"eval_craft on the card {craft_res['card']}, on the CPU {craft_res['cpu']}")
    if eval_craft.main(["--weights", weights, "--splits", "test", "--dataset-root", root]) != 0:
        fail("cli.eval_craft failed")
    print(json.dumps({"eval_ocr": {"rows": len(rows_r), "splits": OCR_EVAL_SPLITS,
                                   "exact_match": res["card"]["exact_match"],
                                   "per_kind": res["card"]["per_kind"],
                                   "ms_card": ms["card"], "ms_cpu": ms["cpu"],
                                   "rows_equal_cpu": True},
                      "eval_craft": {**craft_res["card"], "ms_card": craft_ms["card"],
                                     "ms_cpu": craft_ms["cpu"], "equal_cpu": True}}))


# --- the re-id embedder trainer, the parallel paths, the tooling --------------

EMB_EPOCHS, EMB_BATCH, EMB_LR = 2, 48, 5e-4  # cli.train_embedder's batch and lr
EMB_LOSS0_RTOL, EMB_GRAD_TOL = 1e-5, 1e-4  # the classifier's first-step rule (TRAIN_LR note)
EMB_EMBED_TOL = 1e-4  # the checkpoint's unit vectors, card against CPU (f32, TF32 off)
DP_STEPS = 2
# the DP step over one NCCL rank against detect_step, both bf16 on the card:
# the same computation but for cuDNN's and the loss's scatter-adds' float
# atomics (card against card measured under 1e-6), so the first loss
# within 1e-5 relative and the weights by the card rule of TRAIN_LR's note
DRYRUN_RANKS = 4


def train_embedder_phase(dev, tmp: str, det_root: str) -> None:
    """cli.train_embedder at the CLI's widths (yolov8n-cls, imgsz 64, batch
    48 instances = 96 views, f32, warm-started from the rank classifier) for
    two epochs on the training phase's YOLO dataset; the checkpoint through
    AppearanceEmbedder on the card and the CPU; one f32 embed_step from the
    warm start, card against CPU, by the classifier's first-step rule."""
    from manual_yolo_tpu_torch.cli import train_embedder as train_embedder_cli
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.runtime.embedder import AppearanceEmbedder
    from manual_yolo_tpu_torch.train import data as data_lib
    from manual_yolo_tpu_torch.train import embedder as emb_train
    from manual_yolo_tpu_torch.train.optim import adamw

    out = os.path.join(tmp, "reid", "reid_embedder.npz")
    results, timings = [], {}

    def with_timings(f):
        def run(cfg, log=print, **kw):
            results.append(f(cfg, log, timings=timings))
            return results[-1]
        return run

    t0 = time.perf_counter()
    with wrapped(emb_train, "train_embedder", with_timings):
        rc = train_embedder_cli.main(["--data", det_root, "--out", out, "--epochs",
                                      str(EMB_EPOCHS), "--batch", str(EMB_BATCH), "--init-npz",
                                      CLASSIFIER])
    wall_s = time.perf_counter() - t0
    losses = timings.get("loss", [])
    if rc != 0 or not results or len(losses) < 2 * EMB_EPOCHS or not np.all(np.isfinite(losses)):
        fail(f"cli.train_embedder returned {rc} with losses {losses}")
    res = results[0]
    _, meta = load_params(out)
    if (meta.get("type"), meta.get("objective"), meta.get("imgsz")) != ("reid_embedder", "nt_xent", 64):
        fail(f"the embedder checkpoint's meta is {meta}")
    train_w, _ = emb_train.extract_instances(data_lib.load_yolo_split(det_root, "train"))
    valid_w, _ = emb_train.extract_instances(data_lib.load_yolo_split(det_root, "valid"))
    crops = list(valid_w[:32])
    card = AppearanceEmbedder.from_npz(out, device=dev)(crops)
    cpu = AppearanceEmbedder.from_npz(out, device="cpu")(crops)
    embed_gap = float(np.abs(card - cpu).max())
    if embed_gap > EMB_EMBED_TOL or np.abs(np.linalg.norm(card, axis=1) - 1).max() > 1e-5:
        fail(f"the embedder checkpoint embeds {embed_gap} apart on the card and the CPU")

    rng = np.random.default_rng(0)
    win = train_w[:EMB_BATCH]
    views = np.empty((2 * len(win), 64, 64, 3), np.float32)
    views[0::2], views[1::2] = emb_train.sample_views(rng, win), emb_train.sample_views(rng, win)
    params, _ = load_params(CLASSIFIER)
    proj = emb_train.init_projection(torch.Generator().manual_seed(1), 256, 128)
    first = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        spec = yolov8.build_spec("classify", "n", 13)
        model = yolov8.load_jax_params(yolov8.build_model(spec, train=True), params).to(device).train()
        head = emb_train.ProjectionHead(proj).to(device)
        opt = adamw(list(model.parameters()) + list(head.parameters()), 1e-4)
        loss = emb_train.embed_step(model, head, opt, torch.from_numpy(views).to(device), EMB_LR,
                                    0.1, 1e-4)
        first[name] = (float(loss), torch.cat([p.grad.float().flatten().cpu() for p in
                                               list(model.parameters()) + list(head.parameters())]))
    loss_gap = abs(first["card"][0] - first["cpu"][0]) / abs(first["cpu"][0])
    grad_gap = float((first["card"][1] - first["cpu"][1]).abs().max() / first["cpu"][1].abs().max())
    if loss_gap > EMB_LOSS0_RTOL or grad_gap > EMB_GRAD_TOL:
        fail(f"the f32 embed_step on the card is {loss_gap} (loss) and {grad_gap} (gradients) "
             "from the CPU's")
    step_ms, sample_ms = timings["step_ms"][2:], timings["sample_ms"][2:]
    print(json.dumps({"train_embedder": {
        "scale": "n", "imgsz": 64, "batch_instances": EMB_BATCH, "views_per_step": 2 * EMB_BATCH,
        "dtype": "float32", "epochs": EMB_EPOCHS, "train_instances": int(len(train_w)),
        "valid_instances": int(len(valid_w)), "steps": len(losses),
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "views_per_s": 2 * EMB_BATCH / (statistics.median(step_ms) / 1e3),
        "sample_views_ms_median": statistics.median(sample_ms),
        "host_share": statistics.median(sample_ms) / (statistics.median(sample_ms)
                                                       + statistics.median(step_ms)),
        "loss_first": losses[0], "loss_last": losses[-1],
        "pre_auc_all": res["pre_auc_all"], "pre_auc_same_class": res["pre_auc_same_class"],
        "auc_all": res["auc_all"], "auc_same_class": res["auc_same_class"],
        "embed_card_vs_cpu": embed_gap, "f32_first_step_vs_cpu": {"loss": loss_gap, "grad": grad_gap},
        "wall_s": wall_s}}))


def sharded_candidates(det, frames) -> nms_ops.Candidates:
    """The NMS input of ShardedDetector's rank on ``frames``, on the card."""
    eng = det.engine
    with torch.inference_mode():
        x = torch.as_tensor(frames).to(eng.device)
        canvas, _, _ = letterbox_batch(x.flip(-1), (eng.imgsz, eng.imgsz), scaleup=True)
        boxes, scores = yolov8.decode_boxes(eng.model(canvas), (eng.imgsz, eng.imgsz),
                                            eng.spec.strides)
        return nms_ops.nms_candidates(boxes, scores, conf_thres=eng.conf, pre_nms=K)


def parallel_phase(dev, tmp: str, frame_img: np.ndarray, det_root: str,
                   launches_by_path: dict) -> None:
    """A one-rank NCCL group on the card: ShardedDetector (YOLOv8s bf16 at
    640, conf 0.25) on the 16 frames of a serving tick, counted, against
    DetectorEngine's batch; the data-parallel step at train_det's widths
    (YOLOv8n, 640, batch 16, bf16, the clip at 10) against detect_step for
    two steps; then parallel/dryrun.py with 4 gloo processes on the host's
    CPU. One card shows no multi-rank NCCL run."""
    import torch.distributed as dist

    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.parallel import dryrun
    from manual_yolo_tpu_torch.parallel import mesh as mesh_lib
    from manual_yolo_tpu_torch.parallel import trainer as par_train
    from manual_yolo_tpu_torch.parallel.inference import ShardedDetector
    from manual_yolo_tpu_torch.train import data as data_lib
    from manual_yolo_tpu_torch.train import detector as det_train
    from manual_yolo_tpu_torch.train.optim import set_lr

    frames = np.stack(table_sim_ticks(cv_resize_u8(frame_img, SERVE_HW), SERVE_TABLES, 1)[0])
    mesh_lib.init_process_group(0, 1, os.path.join(tmp, "nccl_store"), device="cuda")
    try:
        mesh = mesh_lib.make_mesh(1)
        params, meta = load_params(DETECTOR)
        spec = yolov8.build_spec("detect", meta["spec"]["scale"], int(meta["spec"]["nc"]))
        det = ShardedDetector(yolov8.fold_params(params, spec), spec, mesh, imgsz=IMGSZ, conf=0.25,
                              iou=IOU, compute_dtype=torch.bfloat16, device=dev)
        engine = DetectorEngine(det.engine.model, imgsz=IMGSZ, conf=0.25, iou=IOU, device=dev)
        det(frames)
        torch.cuda.synchronize()
        nms_kernel.nms_keep.launches = 0
        got = det(frames)
        torch.cuda.synchronize()
        launches_by_path["parallel"] = nms_kernel.nms_keep.launches
        if launches_by_path["parallel"] != 1:
            fail(f"ShardedDetector made {launches_by_path['parallel']} launches for one call")
        ref = engine.detect_batch(frames)
        # the same model on the same card: the same computation, so equal
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        if not exact:
            gaps = {n: float((a.float() - b.float()).abs().max()) for n, a, b in
                    zip(("boxes", "scores", "classes", "count"), got, ref)}
            fail(f"ShardedDetector differs from DetectorEngine's batch: largest gaps {gaps}")
        cand = sharded_candidates(det, frames)
        b, v = cand.nms_boxes.contiguous(), cand.valid.contiguous()
        bad = int((nms_kernel.nms_keep(b, v, IOU) != nms_kernel.nms_keep_plain(b, v, IOU)).sum())
        print(f"nms_keep sharded16: B={b.shape[0]} K={b.shape[1]} valid={int(v.sum())} mismatches={bad}")
        if bad:
            fail(f"kernel and plain keep masks differ in {bad} entries on the sharded batch")
        sharded_ms = [cuda_ms(lambda: det(frames), reps=5, warmup=1),
                      cuda_ms(lambda: engine.detect_batch(frames), reps=5, warmup=1)]

        samples = data_lib.load_yolo_split(det_root, "train", max_side=IMGSZ * 3 // 2)
        x, t, m = (torch.from_numpy(a).to(dev) for a in data_lib.make_detect_batch(
            np.random.default_rng(0), samples, TRAIN_DET_BATCH, IMGSZ))
        dp_step = par_train.make_dp_train_step(mesh, clip_norm=det_train.CLIP_NORM)
        runs = {}
        for name in ("detect_step", "dp_step"):
            model, opt, ema = train_models("detect", dev, torch.bfloat16)
            losses, ms = [], []
            for k in range(DP_STEPS):
                t0 = time.perf_counter()
                if name == "detect_step":
                    loss, _ = det_train.detect_step(model, ema, opt, x, t, m, k, TRAIN_LR)
                else:
                    set_lr(opt, TRAIN_LR)
                    loss, _ = dp_step(model, ema, opt, k, x, t, m)
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[name] = (losses, ms, torch.cat([p.detach().float().flatten().cpu()
                                                 for p in model.parameters()]).numpy())
    finally:
        dist.destroy_process_group()
    (l_ref, ms_ref, w_ref), (l_dp, ms_dp, w_dp) = runs["detect_step"], runs["dp_step"]
    dw = np.abs(w_dp - w_ref)
    if abs(l_dp[0] - l_ref[0]) > TRAIN_LOSS0_RTOL * abs(l_ref[0]) or \
            not np.allclose(l_dp, l_ref, rtol=TRAIN_LOSS_RTOL) or np.median(dw) > TRAIN_WEIGHT_MEDIAN \
            or (dw > TRAIN_WEIGHT_ATOL).mean() > TRAIN_WEIGHT_SHARE or dw.max() > TRAIN_WEIGHT_MAX:
        fail(f"the one-rank DP step is {l_dp} against detect_step's {l_ref}, weights "
             f"{dw.max()} apart (median {np.median(dw)})")

    t0 = time.perf_counter()
    res = dryrun.run(DRYRUN_RANKS)
    dryrun.check(res, DRYRUN_RANKS)
    dry_s = time.perf_counter() - t0
    print(json.dumps({"parallel": {
        "sharded_detector": {"frames": len(frames), "hw": list(SERVE_HW), "imgsz": IMGSZ,
                             "dtype": "bfloat16", "ranks": 1, "backend": "nccl",
                             "nms_keep_launches": launches_by_path["parallel"],
                             "equal_to_engine": exact, "ms": sharded_ms[0], "engine_ms": sharded_ms[1],
                             "detections": [int(c) for c in got.count.cpu()]},
        "dp_step_vs_detect_step": {"scale": "n", "imgsz": IMGSZ, "batch": TRAIN_DET_BATCH,
                                   "dtype": "bfloat16", "ranks": 1, "losses_dp": l_dp,
                                   "losses_detect_step": l_ref, "step_ms_dp": ms_dp,
                                   "step_ms_detect_step": ms_ref, "weights_max_gap": float(dw.max()),
                                   "weights_median_gap": float(np.median(dw)),
                                   "weights_equal_share": float((dw == 0).mean())},
        "dryrun_gloo_cpu": {"ranks": DRYRUN_RANKS, "wall_s": dry_s,
                            "dp_losses": [float(v) for v in res["dp_losses"]],
                            "tp_loss": float(res["tp_loss"]), "sp_loss": float(res["sp_loss"])},
        "multi_rank_nccl": "not measured: one card"}}))


def tooling_phase(dev, tmp: str) -> None:
    """cli.smoke on the card (exit 0, the card named), a profiling.trace
    (in a fresh process) holding a CUDA kernel event, device_memory_stats
    with the card's size."""
    from manual_yolo_tpu_torch.cli import smoke
    from manual_yolo_tpu_torch.utils import profiling

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = smoke.main(["--detector", DETECTOR, "--classifier", CLASSIFIER])
    smoke_s = time.perf_counter() - t0
    out = buf.getvalue()
    name = torch.cuda.get_device_name(0)
    if rc != 0 or f"✅ PyTorch backend (cuda, {name}" not in out:
        fail(f"cli.smoke returned {rc}:\n{out}")
    # the trace in a process of its own: after many traces in one process
    # the profiler on the card's host drops kernel events
    code = (f"import sys, json, torch; sys.path.insert(0, {REPO!r})\n"
            "from manual_yolo_tpu_torch.utils import profiling\n"
            "x = torch.randn(8, 64, 160, 160, device='cuda')\n"
            "w = torch.randn(64, 64, 3, 3, device='cuda')\n"
            f"with profiling.trace({os.path.join(tmp, 'traces')!r}) as prof:\n"
            "    torch.nn.functional.conv2d(x, w, padding=1).sum().item()\n"
            "print(prof.trace_path)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"profiling.trace failed: {proc.stderr[-2000:]}")
    with open(proc.stdout.strip().splitlines()[-1]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail(f"profiling.trace wrote {len(events)} events and no CUDA kernel")
    mem = profiling.device_memory_stats()
    if mem.get("cuda:0", {}).get("bytes_limit", 0) <= 0:
        fail(f"device_memory_stats reads {mem}")
    print(json.dumps({"tooling": {
        "smoke_rc": rc, "smoke_s": smoke_s,
        "smoke_lines": [line for line in out.splitlines() if line[:1] in "✅❌⚠"],
        "trace_events": len(events), "trace_kernel_events": len(kernels),
        "device_memory_stats": mem, "version": manual_yolo_tpu_torch.__version__}}))


ENTRY_REPS, ENTRY_WARMUP = 20, 3
# a rank row's own read is held where its box lies within this of the CPU's:
# on the scaled example card1_rank reads 9 or 4 a fifth of a pixel apart
# (tests/test_torch_entry.py); farther rows are held on the same crops
ENTRY_SAME_CROP_PX = 0.1


def entry_rank_rows(out) -> np.ndarray:
    """The eight classified detections of an entry() output, in top_k's order."""
    from manual_yolo_tpu_torch import entry as entry_mod

    rscore = np.where(np.isin(out[2], entry_mod.RANK_IDS), out[1], 0.0)
    return np.argsort(-rscore, kind="stable")[: entry_mod.MAX_RANK]


def compare_entry(tag: str, dev, cls_model, frame: np.ndarray, got: list, ref: list,
                  margin: float) -> dict:
    """entry()'s outputs (numpy) on the card in bf16 against the CPU's in f32,
    under the golden tolerance: the same count and class list, boxes within
    5 px, scores within ``margin``; the same eight rank rows in order; the
    card's classifier on the CPU's crops gives the CPU's argmax on every row,
    and the card's own rows do where their box is within ENTRY_SAME_CROP_PX."""
    n = int(ref[3])
    if int(got[3]) != n or sorted(got[2][:n].tolist()) != sorted(ref[2][:n].tolist()):
        fail(f"entry {tag}: the card finds {got[2][:int(got[3])].tolist()}, "
             f"the CPU {ref[2][:n].tolist()}")
    left, box_px, score_gap = list(range(n)), 0.0, 0.0
    for i in range(n):
        j = min((j for j in left if got[2][j] == ref[2][i]),
                key=lambda j: np.abs(got[0][j] - ref[0][i]).max())
        left.remove(j)
        box_px = max(box_px, float(np.abs(got[0][j] - ref[0][i]).max()))
        score_gap = max(score_gap, abs(float(got[1][j] - ref[1][i])))
    gi, ri = entry_rank_rows(got), entry_rank_rows(ref)
    moved = np.abs(got[0][gi] - ref[0][ri]).max(axis=1)
    if box_px > BOX_TOL_PX or score_gap > margin or (got[2][gi] != ref[2][ri]).any():
        fail(f"entry {tag}: boxes {box_px} px, scores {score_gap} apart, rank rows "
             f"{got[2][gi].tolist()} against {ref[2][ri].tolist()}")
    from manual_yolo_tpu_torch.runtime.pipeline import crop_resize_center

    rgb = torch.as_tensor(frame, device=dev).flip(-1)
    with torch.inference_mode():
        same = cls_model(crop_resize_center(rgb, torch.as_tensor(ref[0][ri], device=dev), 64, 6.0)
                         / 255.0).float().cpu().numpy()
    own_differ = [[int(k), round(float(moved[k]), 3), int(got[4][k].argmax()), int(ref[4][k].argmax())]
                  for k in range(len(ri)) if got[4][k].argmax() != ref[4][k].argmax()]
    if (same.argmax(1) != ref[4].argmax(1)).any() or \
            any(m <= ENTRY_SAME_CROP_PX for _, m, _, _ in own_differ):
        fail(f"entry {tag}: rank argmax on the same crops {same.argmax(1).tolist()} against "
             f"{ref[4].argmax(1).tolist()}; own rows differing [row, px, card, cpu] {own_differ}")
    return {"detections": n, "box_px_max": box_px, "score_gap_max": score_gap,
            "rank_rows_box_px": [round(float(m), 3) for m in moved],
            "same_crops_logit_gap_max": float(np.abs(same - ref[4]).max()),
            "own_rows_argmax_differ_moved_box": own_differ}


def entry_phase(dev, smi: str, frame_img: np.ndarray, launches_by_path: dict) -> None:
    """entry() on the card (YOLOv8n and yolov8n-cls in bf16 at 640, the CUDA
    keep kernel) on its seeded frame and on the example scaled to SERVE_HW:
    one launch a call, the keep mask bit for bit against its plain version,
    the card's bf16 against the CPU's f32 run of the same program
    (``compare_entry``); then the call's and the detector forward's ms after
    warm-ups, and the FLOPs of ``flops_per_image`` over those times."""
    from manual_yolo_tpu_torch import entry as entry_mod
    from manual_yolo_tpu_torch.core.serialization import load_params

    fn, (det, cls, seeded) = entry_mod.entry()
    frames = {"seeded_1200x1920": seeded, "poker_labeled_1200x1920": cv_resize_u8(frame_img, SERVE_HW)}
    cpu_models = entry_mod.build_models(load_params(entry_mod.DET_WEIGHTS)[0],
                                        load_params(entry_mod.CLS_WEIGHTS)[0],
                                        torch.device("cpu"), torch.float32)
    cpu_fn = entry_mod.make_fn(torch.device("cpu"))
    with open(GOLDEN) as f:
        margin = json.load(f)["margin"]
    keeps = []

    def recording(f):
        def run(boxes, valid, iou_thres):
            keeps.append((boxes, valid, iou_thres, f(boxes, valid, iou_thres)))
            return keeps[-1][3]
        return run

    report, launches = {}, 0
    numpy = lambda out: [o.float().cpu().numpy() if o.is_floating_point() else o.cpu().numpy() for o in out]
    for name, frame in frames.items():
        nms_kernel.nms_keep.launches = 0
        with wrapped(nms_ops, "nms_keep", recording):
            got = numpy(fn(det, cls, frame))
        torch.cuda.synchronize()
        if nms_kernel.nms_keep.launches != 1:
            fail(f"entry on {name} made {nms_kernel.nms_keep.launches} keep launches, not 1")
        launches += 1
        report[name] = compare_entry(name, dev, cls, frame, got, numpy(cpu_fn(*cpu_models, frame)), margin)
    launches_by_path["entry"] = launches
    bad = sum(int((kept != nms_kernel.nms_keep_plain(b, v, t)).sum()) for b, v, t, kept in keeps)
    if bad or len(keeps) != len(frames):
        fail(f"entry's keep masks differ from the plain version in {bad} entries")
    if report["poker_labeled_1200x1920"]["detections"] < 20:
        fail(f"entry finds {report['poker_labeled_1200x1920']['detections']} boxes on the example")

    example = frames["poker_labeled_1200x1920"]

    def host_ms(call) -> list:
        for _ in range(ENTRY_WARMUP):
            call()
        torch.cuda.synchronize()
        out = []
        for _ in range(ENTRY_REPS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    call_ms = host_ms(lambda: fn(det, cls, example))
    canvas = letterbox(torch.as_tensor(example, device=dev).flip(-1), (IMGSZ, IMGSZ))[0][None]
    with torch.inference_mode():
        forward_ms = host_ms(lambda: det(canvas))
    det_flops = yolov8.flops_per_image(entry_mod.DET_SPEC, IMGSZ)
    cls_flops = yolov8.flops_per_image(entry_mod.CLS_SPEC, 64) * entry_mod.MAX_RANK
    med = lambda v: statistics.median(v)
    print(json.dumps({"entry": {
        "card": smi, "detector": "poker_detector_n bf16", "classifier": "rank_classifier_matched bf16",
        "frame_hw": list(SERVE_HW), "imgsz": IMGSZ, "nms_keep_launches": launches,
        "vs_cpu_f32": report, "call_ms": {"median": med(call_ms), "min": min(call_ms)},
        "forward_ms": {"median": med(forward_ms), "min": min(forward_ms)},
        "reps": ENTRY_REPS, "warmup": ENTRY_WARMUP,
        "flops_per_image_detect_n_640": det_flops, "flops_classify_n_64_x8": cls_flops,
        "forward_tflops_per_s": det_flops / med(forward_ms) / 1e9,
        "call_tflops_per_s": (det_flops + cls_flops) / med(call_ms) / 1e9}}))


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

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name

    # 3. the host library against its plain twins; the JPEG fixtures
    host_library(tmp)
    jpeg_fixtures(tmp)

    # 4. kernel vs plain, bit for bit
    gpu = load_fused_pipeline(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=CONF, iou=IOU,
                              compute_dtype="bfloat16", device=dev)
    frame_img = imread_bgr(IMAGE)
    rng = np.random.default_rng(0)
    cases = {
        "random_b1": random_candidates(rng, 1, [300], clustered=False),
        "clustered_b4": random_candidates(rng, 4, [0, 77, 300, K], clustered=True),
        "empty": (np.zeros((1, K, 4), np.float32), np.zeros((1, K), bool)),
        "full_chain": random_candidates(rng, 1, [K], clustered=True),
        "mixed_b16": random_candidates(rng, 16, np.linspace(0, K, 16).astype(int), clustered=True),
    }
    cand = image_candidates(gpu, frame_img)
    real = (cand.nms_boxes[None].contiguous(), cand.valid[None].contiguous())
    cases["poker_labeled"] = real
    cases["batch4"] = (real[0].repeat(4, 1, 1), real[1].repeat(4, 1))
    cases["batch16"] = (real[0].repeat(16, 1, 1), real[1].repeat(16, 1))
    cases = {name: (torch.as_tensor(boxes, device=dev).contiguous(),
                    torch.as_tensor(valid, device=dev).contiguous())
             for name, (boxes, valid) in cases.items()}
    mismatches, max_abs_err = 0, 0.0
    for name, (boxes, valid) in cases.items():
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

    # 5. the OCR engine on the card against the CPU, on the same crops
    cpu = load_fused_pipeline(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=CONF, iou=IOU,
                              compute_dtype="float32", device="cpu")
    t0 = time.perf_counter()
    gpu_ocr = default_ocr_engine(device=dev)
    ocr_build_s = time.perf_counter() - t0
    cpu_ocr = default_ocr_engine(device="cpu")
    if gpu_ocr is None or cpu_ocr is None or gpu_ocr.craft is None:
        fail("the OCR checkpoints are missing from weights/")
    print(f"OCR engine on the card built in {ocr_build_s:.1f} s")
    check_ocr(gpu_ocr, cpu_ocr, frame_img,
              dataclasses.replace(cpu, conf=0.25).process_frame(frame_img))

    # 6. the main path on the card, counted: the CLI's process_screenshot with OCR
    frame_rand = np.random.default_rng(0).integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
    gpu_json = os.path.join(tmp, "gpu.json")
    nms_kernel.nms_keep.launches = 0
    res_gpu = process_screenshot(gpu, IMAGE, gpu_json, output_image=None, ocr=gpu_ocr,
                                 use_llm_fallback=False)
    dets_gpu_rand = gpu.process_frame(frame_rand)
    torch.cuda.synchronize()
    launches = nms_kernel.nms_keep.launches
    dets_gpu_img = gpu.process_frame(frame_img)

    # 7. the same on the CPU in f32. A bf16 box a pixel off gives OCR another
    # crop, so the fields of moved boxes are listed, not compared; the card
    # in f32 (the same boxes) must give the CPU's result exactly
    res_cpu = process_screenshot(cpu, IMAGE, os.path.join(tmp, "cpu.json"), output_image=None,
                                 ocr=cpu_ocr, use_llm_fallback=False)
    with open(gpu_json) as f:
        if json.load(f) != res_gpu:
            fail("poker_result.json on disk differs from the returned result")
    dets_cpu_img = cpu.process_frame(frame_img)
    dets_cpu_rand = cpu.process_frame(frame_rand)
    compare_dets("poker_labeled", dets_gpu_img, dets_cpu_img)
    compare_dets("seeded 1200x1920", dets_gpu_rand, dets_cpu_rand)
    moved = moved_fields(dets_gpu_img, dets_cpu_img)
    differ = compare_results(res_gpu, res_cpu, skip=moved)
    gpu_f32 = load_fused_pipeline(DETECTOR, CLASSIFIER, imgsz=IMGSZ, conf=CONF, iou=IOU,
                                  compute_dtype="float32", device=dev)
    compare_results(process_screenshot(gpu_f32, IMAGE, os.path.join(tmp, "f32.json"),
                                       output_image=None, ocr=gpu_ocr, use_llm_fallback=False),
                    res_cpu)
    if gpu_ocr.errors or cpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors on the card, {cpu_ocr.errors} on the CPU")
    print(json.dumps({"shot_vs_cpu": {"bf16_moved_box_fields": moved,
                                      "bf16_moved_box_reads_differ": differ,
                                      "f32_on_card_equals_cpu": True}}))
    print(f"main path: poker_labeled {len(dets_gpu_img)} detections "
          f"({sum(bool(d['ocr_text']) for d in dets_gpu_img)} ranks read), "
          f"seeded frame {len(dets_gpu_rand)}; matches CPU f32")
    print("result:", json.dumps({k: v for k, v in res_gpu.items() if k != "time"}))

    # 8. the main path went through the kernel
    if launches < 2:
        fail(f"nms_keep launched {launches} times on the main path, expected 2")
    launches_by_path = {"screenshot": launches}

    # 9. the live loop as cli/detect.py runs it: bf16 detector, conf 0.25, OCR on
    cfg = AppConfig()
    live_frames = shifted_frames(frame_img, LIVE_FRAMES)
    gpu_live = dataclasses.replace(gpu, conf=cfg.detector.conf)
    nms_kernel.nms_keep.launches = 0
    loop, live_ms, live_rows, _ = live_run(gpu_live, gpu_ocr, live_frames, os.path.join(tmp, "live"))
    torch.cuda.synchronize()
    launches_by_path["live"] = nms_kernel.nms_keep.launches
    if launches_by_path["live"] != LIVE_FRAMES:
        fail(f"the live loop made {launches_by_path['live']} launches over {LIVE_FRAMES} frames")
    if loop.errors or gpu_ocr.errors:
        fail(f"the live loop caught {loop.errors} errors, OCR {gpu_ocr.errors}")
    n_dets = [len(r["detections"]) for r in live_rows]
    if min(n_dets) < 10 or not any(d["ocr_text"] for d in live_rows[-1]["detections"]):
        fail(f"the live loop found {n_dets} detections per frame, or read no text")
    tracked = {d["tracker_id"] for d in live_rows[-1]["detections"]} - {-1}
    print(json.dumps({"live_ms": {"median": statistics.median(live_ms[2:]), "min": min(live_ms[2:]),
                                  "frames": LIVE_FRAMES, "warmup": 2, "detections": n_dets[-1],
                                  "tracks_last_frame": len(tracked), "ocr": True,
                                  "stages": loop.timer.stats()}}))
    f32_live = {}
    for name, pipe, ocr_engine in (("card", dataclasses.replace(gpu_f32, conf=cfg.detector.conf), gpu_ocr),
                                   ("cpu", dataclasses.replace(cpu, conf=cfg.detector.conf), cpu_ocr)):
        f32_live[name] = live_run(pipe, ocr_engine, live_frames[:LIVE_F32_FRAMES],
                                  os.path.join(tmp, f"live_{name}"), interval=0.0)
    moved = compare_nested("live f32 card vs CPU", f32_live["card"][2], f32_live["cpu"][2])
    compare_nested("live f32 game JSON", f32_live["card"][3], f32_live["cpu"][3], moved=moved)
    if gpu_ocr.errors or cpu_ocr.errors or f32_live["card"][0].errors or f32_live["cpu"][0].errors:
        fail("the f32 live runs caught errors")
    print(json.dumps({"live_f32_vs_cpu": {"frames": LIVE_F32_FRAMES, "games": list(f32_live["cpu"][3]),
                                          "corners_1px": moved, "equal": True}}))

    # 10. the hand session as cli/pipe.py runs it: imgsz 1280, conf 0.35, tiles, DeepSORT
    hand_frames = {"seeded_1200x1920": frame_rand, "poker_labeled": frame_img}
    hp = hand_session(dev, "bfloat16", gpu_ocr, os.path.join(tmp, "hands"))
    BatchCounter(hp.engine)
    nms_kernel.nms_keep.launches = 0
    hands = {name: hand_steps(hp, shifted_frames(f, HAND_STEPS)) for name, f in hand_frames.items()}
    torch.cuda.synchronize()
    launches_by_path["hands"] = nms_kernel.nms_keep.launches
    batched = hp.engine.detect_batch.calls
    if not any(b == 12 for b, _ in batched) or any(n != 1 for _, n in batched):
        fail(f"the hand session's (B, launches) per batch are {batched}: no 12-tile "
             "batch, or not one launch each")
    if hands["seeded_1200x1920"][2][0] != 12:
        fail(f"the seeded frame's tiled step ran {hands['seeded_1200x1920'][2][0]} tiles, not 12")
    if launches_by_path["hands"] != sum(sum(h[3]) for h in hands.values()):
        fail("the hand session's launches do not add up over its steps")
    if gpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors in the hand session")
    print(json.dumps({"hands_ms": {
        name: {"median": statistics.median(h[1][2:]), "min": min(h[1][2:]), "steps": HAND_STEPS,
               "warmup": 2, "tiles_per_step": h[2], "nms_keep_launches_per_step": h[3],
               "detections_last_step": len(h[0][-1]["detections"]),
               "active_last_step": len(h[0][-1]["active"]),
               "buttons_last_step": len(h[0][-1]["buttons"])}
        for name, h in hands.items()}}))
    print(json.dumps({"hands_stages": hp.timer.stats()}))
    hands_prof = trace_once(lambda: hp.step(frame_rand), "hand_step")
    print(json.dumps({"hands_profile": dict(hands_prof, frame="seeded_1200x1920")}))
    tcand = tile_candidates(hp.engine, frame_rand, hp.tile, hp.tile_overlap)
    tiles12 = (tcand.nms_boxes.contiguous(), tcand.valid.contiguous())
    ecand = tile_candidates(hp.engine, frame_img, hp.tile, hp.tile_overlap)
    for name, (b, v) in (("tiles12", tiles12),
                         ("tiles6_poker_labeled", (ecand.nms_boxes.contiguous(), ecand.valid.contiguous()))):
        got, ref = nms_kernel.nms_keep(b, v, IOU), nms_kernel.nms_keep_plain(b, v, IOU)
        bad = int((got != ref).sum())
        print(f"nms_keep {name}: B={b.shape[0]} K={b.shape[1]} valid={int(v.sum())} "
              f"kept={int(got.sum())} mismatches={bad}")
        mismatches += bad
    if mismatches:
        fail(f"kernel and plain keep masks differ in {mismatches} entries on the tiles")
    f32_hands = {}
    for name, device, ocr_engine in (("card", dev, gpu_ocr), ("cpu", "cpu", cpu_ocr)):
        steps = []
        for fname, f in hand_frames.items():
            session = hand_session(device, "float32", ocr_engine, os.path.join(tmp, f"hands_{name}_{fname}"))
            BatchCounter(session.engine)
            steps += [step_view(i) for i in hand_steps(session, shifted_frames(f, HAND_F32_STEPS))[0]]
        f32_hands[name] = steps
    moved = compare_nested("hands f32 card vs CPU", f32_hands["card"], f32_hands["cpu"])
    print(json.dumps({"hands_f32_vs_cpu": {"steps": len(f32_hands["cpu"]), "corners_1px": moved,
                                           "equal": True}}))

    # 11. serving: BatchStream at 16 tables, StreamingEngine, cli.serve --ocr
    serve_cases = serving(dev, gpu_ocr, tmp, launches_by_path)
    b16, v16 = serve_cases["serve16"]
    got, ref = nms_kernel.nms_keep(b16, v16, IOU), nms_kernel.nms_keep_plain(b16, v16, IOU)
    bad = int((got != ref).sum())
    print(f"nms_keep serve16: B={b16.shape[0]} K={b16.shape[1]} valid={int(v16.sum())} "
          f"kept={int(got.sum())} mismatches={bad}")
    if bad or b16.shape[0] != SERVE_TABLES:
        fail(f"kernel and plain keep masks differ in {bad} entries on the serving tick")

    # 12. serving's delta codec: every table changes every tick
    codec(dev, launches_by_path)

    # 13. training: cli.train_cls, cli.train_det (counted), f32 steps against
    # the CPU, cli.eval_det (counted), and the kernel on one eval batch
    train_cls_phase(dev, tmp)
    det_root, (eval_boxes, eval_scores, eval_kw) = train_det_phase(
        dev, tmp, yolo_frames(frame_img, frame_rand), launches_by_path)
    print(json.dumps({"train_step_profile": train_step_profile(dev, det_root)}))
    train_f32_vs_cpu(dev, det_root)
    eval_trained = eval_det_phase(dev, det_root, launches_by_path)
    # the kernel on the two eval batches: the trainer's (its first eval) and
    # cli.eval_det's of the trained YOLOv8n, both B=8 at conf 0.001
    eval_cases = {}
    for name, (eb, es) in (("eval8", (eval_boxes, eval_scores)), ("eval8_det_n", eval_trained)):
        c = nms_ops.nms_candidates(eb, es, conf_thres=eval_kw["conf_thres"], pre_nms=eval_kw["pre_nms"])
        b, v = c.nms_boxes.contiguous(), c.valid.contiguous()
        got = nms_kernel.nms_keep(b, v, eval_kw["iou_thres"])
        bad = int((got != nms_kernel.nms_keep_plain(b, v, eval_kw["iou_thres"])).sum())
        print(f"nms_keep {name}: B={b.shape[0]} K={b.shape[1]} valid={int(v.sum())} "
              f"kept={int(got.sum())} mismatches={bad}")
        if bad or b.shape[:2] != (8, 512) or eval_kw["iou_thres"] != IOU:
            fail(f"kernel and plain keep masks differ in {bad} entries on {name}")
        eval_cases[name] = (b, v)

    # 14. the reference's formats: a .pt classifier, a JPEG screenshot
    # through cli.shot (counted), matched crops re-cut from JPEGs
    pt = pt_classifier(dev, tmp, frame_img, dataclasses.replace(cpu, conf=0.25).process_frame(frame_img))
    jpeg_shot(dev, tmp, pt, launches_by_path)
    matched_phase(dev, tmp)

    # 15. what the screenshot and live CLIs write: the annotated image
    # (counted), the JPEG encoder, the vision-LLM fallback (counted, stubbed
    # request), the live loop's screenshots (counted) and cli.unlabel
    annotated_shot(dev, tmp, gpu, gpu_ocr, launches_by_path)
    jpeg_encode_phase(tmp)
    llm_fallback_phase(dev, tmp, gpu, launches_by_path)
    live_screenshots(dev, tmp, gpu_live, gpu_ocr, shifted_frames(frame_img, LIVE_SHOT_FRAMES),
                     launches_by_path)
    unlabel_phase(det_root, tmp)
    if gpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors in the writers' phases")

    # 16. the one-call frame program (entry.py), counted, card against CPU
    entry_phase(dev, smi, frame_img, launches_by_path)

    # 17. timings: the kernel at nine shapes, the rest at the main path's
    cases["tiles12"] = tiles12
    cases["tiles6_poker_labeled"] = (ecand.nms_boxes.contiguous(), ecand.valid.contiguous())
    cases["serve16"] = (b16, v16)
    cases.update(eval_cases)
    timed = {name: cases[name] for name in ("poker_labeled", "full_chain", "batch4", "batch16",
                                            "tiles12", "tiles6_poker_labeled", "serve16", "eval8",
                                            "eval8_det_n")}
    ms_by_shape = kernel_ms({name: (lambda b=b, v=v: nms_kernel.nms_keep(b, v, IOU))
                             for name, (b, v) in timed.items()})
    bound_by_shape = {name: bound(b, v, nms_kernel.nms_keep_plain(b, v, IOU))
                      for name, (b, v) in timed.items()}
    print(json.dumps({"nms_keep_by_shape": {
        name: {"B": timed[name][0].shape[0], "valid": int(timed[name][1].sum()),
               "ms": ms_by_shape[name], "bound_ms": bound_by_shape[name][0],
               "bound_by": bound_by_shape[name][1], "tested_pairs": bound_by_shape[name][2]}
        for name in timed}}))
    kboxes, kvalid = real
    ms = ms_by_shape["poker_labeled"]
    bound_ms, bound_kind, pairs = bound_by_shape["poker_labeled"]
    call_ms = cuda_ms(lambda: nms_kernel.nms_keep(kboxes, kvalid, IOU), reps=200, warmup=20)
    plain_ms = cuda_ms(lambda: nms_kernel.nms_keep_plain(kboxes, kvalid, IOU), reps=5, warmup=1)
    frame_ms = []
    for _ in range(3):
        gpu.process_frame(frame_img)
    for _ in range(10):
        t0 = time.perf_counter()
        gpu.process_frame(frame_img)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"frame_ms": {"median": statistics.median(frame_ms), "min": min(frame_ms),
                                   "shape": list(frame_img.shape), "n_valid": int(kvalid.sum()),
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
    shot_ms = []
    for i in range(13):
        t0 = time.perf_counter()
        process_screenshot(gpu, IMAGE, gpu_json, output_image=None, ocr=gpu_ocr,
                           use_llm_fallback=False)
        if i >= 3:
            shot_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"shot_ms": {"median": statistics.median(shot_ms), "min": min(shot_ms),
                                  "ocr": True, "reps": len(shot_ms)}}))
    shot_profile(lambda: process_screenshot(gpu, IMAGE, gpu_json, output_image=None,
                                            ocr=TimedOCR(gpu_ocr), use_llm_fallback=False))
    if gpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors on the card while timed")

    # 18. OCR training and evaluation: cli.train_ocr, cli.train_craft, each
    # with three f32 steps against the CPU, and cli.eval_ocr / cli.eval_craft
    # on a stand-in labelled set, card against CPU. After the timings: their
    # two profiled steps would cost the kernel's trace events (many traces
    # in one process lose some on that host)
    ocr_dets = dataclasses.replace(cpu, conf=0.25).process_frame(frame_img)
    train_ocr_phase(dev, tmp, frame_img, ocr_dets)
    train_craft_phase(dev, tmp, frame_img)
    ocr_eval_phase(dev, tmp, cpu_ocr)

    # 19. the re-id embedder trainer through its CLI; 20. the parallel paths
    # (ShardedDetector counted, the DP step against detect_step, the gloo dry
    # run); 21. the tooling (cli.smoke, a trace, memory stats)
    train_embedder_phase(dev, tmp, det_root)
    parallel_phase(dev, tmp, frame_img, det_root, launches_by_path)
    tooling_phase(dev, tmp)
    tmp_dir.cleanup()
    print(json.dumps({"nms_keep_timing": {
        "kernel_ms": ms, "source": "torch.profiler",
        "wrapper_call_ms": call_ms, "plain_ms": plain_ms}}))

    print(json.dumps({"kernels": [{
        "name": "nms_keep",
        "route": "cuda",
        "source": "manual_yolo_tpu_torch/csrc/nms_keep.cu",
        "replaces": "manual_yolo_tpu/ops/pallas_nms.py:36",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "mismatches": mismatches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "ms_by_shape": ms_by_shape,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_kind,
        "bound_ms_by_shape": {name: b[0] for name, b in bound_by_shape.items()},
        "library_ms": None,
    }]}))

    # 22. the device line
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
