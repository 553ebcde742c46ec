"""Run the PyTorch port's paths on one CUDA card, and check them: the
single-screenshot path, the live loop and the hand session.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

  1. print the card's name and power limit (nvidia-smi);
  2. build the greedy-NMS kernel (csrc/nms_keep.cu) with nvcc and print the
     compiler's register / shared-memory report;
  3. build the host C++ library (csrc/host.cpp) with g++ and hold it against
     its plain twins: ctc_beam and ctc_score_multi on seeded log-probs, and the
     PNG row unfilter on the committed example and on a Paeth re-encode of it
     written here with zlib; time both PNG reads;
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
 11. time the kernel's device time from a torch.profiler trace at
     poker_labeled, full_chain, batch4, batch16, tiles12 and the example's 6
     tiles (tiles6_poker_labeled) (each shape's launches
     inside a record_function range; a range without all of its kernel
     events fails), each beside its bound; the wrapper's time per call with
     CUDA events and the plain version at the main path's shape; the frame
     latency and the screenshot latency with OCR with the host clock, the
     frame's device time by kernel, and one trace of the screenshot with OCR
     (device busy and idle share, the OCR pass's share, recognizer calls per
     kind, the host time of the beam and rescore); print them and a JSON
     line listing every kernel with its bound and its launches on each path;
 12. print the device line last.

Without a card (``torch.cuda.is_available()`` false) it exits 1 before any
result is printed.
"""

from __future__ import annotations

import dataclasses
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
from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import ctc as ctc_ops
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops import nms_kernel
from manual_yolo_tpu_torch.config import AppConfig
from manual_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_batch
from manual_yolo_tpu_torch.parallel.inference import tiled_frames
from manual_yolo_tpu_torch.runtime import native, png
from manual_yolo_tpu_torch.runtime.embedder import default_embedder
from manual_yolo_tpu_torch.runtime.engine import DetectorEngine
from manual_yolo_tpu_torch.runtime.hands import HandSessionPipeline
from manual_yolo_tpu_torch.runtime.live import LiveLoop
from manual_yolo_tpu_torch.runtime.ocr import field_kind, default_ocr_engine
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


def kernel_ms(fns: dict, reps: int = 50) -> dict:
    """{name: mean device time of the NMS kernel per launch of fns[name]}, from
    one torch.profiler trace. Each name's launches run inside a record_function
    range of their own, 20 ms apart; a kernel event belongs to the range that
    starts last before it, and every range must hold all ``reps`` launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the first launches after the trace starts can go unrecorded: begin
        # with other device work and a pause
        torch.ones(1, device="cuda").add_(1)
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
            if not owner:
                fail(f"an nms_keep_kernel event at {e.time_range.start} us precedes every range")
            spans[owner[-1]].append(e.time_range.elapsed_us())
    counts = {name: len(us) for name, us in spans.items()}
    if set(counts.values()) != {reps}:
        fail(f"the profiler trace holds {counts} nms_keep_kernel events, not {reps} per range")
    return {name: sum(us) / reps / 1e3 for name, us in spans.items()}


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

    # 3. the host library against its plain twins
    host_library(tmp)

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
    res_gpu = process_screenshot(gpu, IMAGE, gpu_json, ocr=gpu_ocr)
    dets_gpu_rand = gpu.process_frame(frame_rand)
    torch.cuda.synchronize()
    launches = nms_kernel.nms_keep.launches
    dets_gpu_img = gpu.process_frame(frame_img)

    # 7. the same on the CPU in f32. A bf16 box a pixel off gives OCR another
    # crop, so the fields of moved boxes are listed, not compared; the card
    # in f32 (the same boxes) must give the CPU's result exactly
    res_cpu = process_screenshot(cpu, IMAGE, os.path.join(tmp, "cpu.json"), ocr=cpu_ocr)
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
                                       ocr=gpu_ocr), res_cpu)
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

    # 11. timings: the kernel at six shapes, the rest at the main path's
    cases["tiles12"] = tiles12
    cases["tiles6_poker_labeled"] = (ecand.nms_boxes.contiguous(), ecand.valid.contiguous())
    timed = {name: cases[name] for name in ("poker_labeled", "full_chain", "batch4", "batch16",
                                            "tiles12", "tiles6_poker_labeled")}
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
        process_screenshot(gpu, IMAGE, gpu_json, ocr=gpu_ocr)
        if i >= 3:
            shot_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"shot_ms": {"median": statistics.median(shot_ms), "min": min(shot_ms),
                                  "ocr": True, "reps": len(shot_ms)}}))
    shot_profile(lambda: process_screenshot(gpu, IMAGE, gpu_json, ocr=TimedOCR(gpu_ocr)))
    if gpu_ocr.errors:
        fail(f"OCR caught {gpu_ocr.errors} errors on the card while timed")
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

    # 12. the device line
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
