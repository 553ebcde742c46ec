"""Multi-table serving: N table streams through one BatchStream.
Counterpart of ``manual_yolo_tpu/cli/serve.py``.

Each batch slot carries one table's latest frame, so the whole fleet shares
one upload, one detector forward, one NMS-kernel launch and one readback
per tick. An idle table's slot passes the unchanged-frame compare (no
letterbox) and the tick-level skip and slots modes, so the cost of a tick
follows how much changed, not how many tables are attached.

The default source simulates a fleet: each table is a base frame that is
static but for an occasional localized repaint (a card dealt, a bet
updated) and a rarer global photometric shift. The base is ``--base`` (a
PNG), or a seeded noise frame.

  python -m manual_yolo_tpu_torch.cli.serve --tables 16 --ticks 120
  python -m manual_yolo_tpu_torch.cli.serve --tables 2 --ticks 8 --imgsz 192 \\
      --width 480 --height 300 --device cpu --dtype float32

The device defaults to ``cuda``; without a card the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from typing import Iterator, List, Optional

import numpy as np


def table_sim_source(
    base_bgr: np.ndarray,
    seed: int = 0,
    repaint_every: float = 0.08,
    photometric_every: float = 0.02,
) -> Iterator[np.ndarray]:
    """One table's stream: mostly static, an occasional localized repaint (a
    card-sized region), a rare global brightness shift. An unchanged frame
    is the same array object as the one before."""
    rng = np.random.default_rng(seed)
    frame = base_bgr.copy()
    h, w = frame.shape[:2]
    while True:
        r = rng.random()
        if r < repaint_every:
            rh, rw = int(h * 0.08), int(w * 0.05)
            y = int(rng.integers(0, h - rh))
            x = int(rng.integers(0, w - rw))
            frame = frame.copy()
            frame[y:y + rh, x:x + rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
        elif r < repaint_every + photometric_every:
            shift = rng.integers(-5, 6, (1, 1, 3), np.int16)
            frame = np.clip(frame.astype(np.int16) + shift, 0, 255).astype(np.uint8)
        yield frame


def build_sources(spec: str, n: int, hw, base: Optional[str] = None) -> List[Iterator[np.ndarray]]:
    """``n`` frame sources of (height, width) ``hw``: 'table-sim' (from the PNG
    ``base``, or seeded noise), 'synthetic', or a PNG file or directory that
    every table replays."""
    from manual_yolo_tpu_torch.runtime import capture

    if spec == "table-sim":
        from manual_yolo_tpu_torch.ops.image import cv_resize_u8
        from manual_yolo_tpu_torch.runtime.png import imread_bgr

        if base is not None:
            img = imread_bgr(base)
        else:
            img = np.random.default_rng(0).integers(0, 255, tuple(hw) + (3,), np.uint8)
        frame = cv_resize_u8(img, tuple(hw))
        return [table_sim_source(frame, seed=i) for i in range(n)]
    if spec == "synthetic":
        return [capture.synthetic_source(hw=hw, seed=i) for i in range(n)]
    return [capture.make_source(spec, loop=True) for _ in range(n)]


def main(argv=None) -> int:
    from manual_yolo_tpu_torch.config import AppConfig
    from manual_yolo_tpu_torch.game import taxonomy
    from manual_yolo_tpu_torch.game.state import GameTracker
    from manual_yolo_tpu_torch.runtime.engine import DTYPES
    from manual_yolo_tpu_torch.runtime.native import JsonLog, crop_u8
    from manual_yolo_tpu_torch.runtime.serving import load_batch_stream
    from manual_yolo_tpu_torch.utils.profiling import StageTimer

    cfg = AppConfig.load()
    ap = argparse.ArgumentParser(
        description="Serve N table streams through one batched pipeline (PyTorch port)")
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=60,
                    help="number of batch ticks to run (0 = forever)")
    ap.add_argument("--source", default="table-sim",
                    help="'table-sim' | 'synthetic' | PNG file or directory")
    ap.add_argument("--base", default=None,
                    help="PNG the table-sim source starts from (default: seeded noise)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--detector", default=cfg.detector.weights)
    ap.add_argument("--classifier", default=cfg.rank.weights)
    ap.add_argument("--imgsz", type=int, default=cfg.detector.imgsz)
    ap.add_argument("--conf", type=float, default=cfg.detector.conf)
    ap.add_argument("--out", default="serve_outputs",
                    help="directory for per-table detection JSONL streams "
                         "and game-state JSON files")
    ap.add_argument("--save-every", type=int, default=8,
                    help="persist each table's game_<id>.json every N ticks")
    ap.add_argument("--ocr", action="store_true",
                    help="read text fields (stacks/names/pot/game_id) with the "
                         "default OCR engine for tables whose frame changed this "
                         "tick (ranks are always classified by the batch pipeline)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timings at exit")
    ap.add_argument("--warmup-ticks", type=int, default=10,
                    help="ticks excluded from the steady-state rate")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=cfg.detector.compute_dtype,
                    choices=sorted(DTYPES), help="the detector's compute dtype")
    args = ap.parse_args(argv)

    stream = load_batch_stream(
        args.detector, args.classifier, batch=args.tables, imgsz=args.imgsz,
        conf=args.conf, compute_dtype=DTYPES[args.dtype], device=args.device,
    )
    sources = build_sources(args.source, args.tables, (args.height, args.width), args.base)

    os.makedirs(args.out, exist_ok=True)
    logs = [JsonLog(os.path.join(args.out, f"table_{i:02d}.jsonl")) for i in range(args.tables)]
    # one game-state machine per table: hero-card change -> new game id ->
    # game_<id>.json, per fleet member
    trackers = [GameTracker(output_dir=os.path.join(args.out, f"table_{i:02d}"))
                for i in range(args.tables)]
    ocr_engine = None
    if args.ocr:
        from manual_yolo_tpu_torch.runtime.ocr import default_ocr_engine

        ocr_engine = default_ocr_engine(device=args.device)
        if ocr_engine is None:
            raise FileNotFoundError("--ocr: no recognizer weights found under weights/")

    def gather_text_fields(frame, dets, ti, refs, crops, names):
        """One table's OCR-eligible crops into the tick-wide batch."""
        for i, d in enumerate(dets):
            name = d["class_name"]
            if name in taxonomy.RANK_CLASSES or not (
                name.endswith(("_name", "_stack", "_bet"))
                or name in ("total_pot", "game_id", "iinput_field", "my_stack", "my_bet")
            ):
                continue
            x1, y1, x2, y2 = d["bbox"]
            crop = crop_u8(frame, y1 - 2, x1 - 2, y2 + 2, x2 + 2)
            if crop.size == 0:
                continue
            refs.append((ti, i))
            crops.append(crop)
            names.append(name)

    def read_text_fields_fleet(results, c_frames, c_due):
        """One engine call per tick for all changed tables' fields."""
        refs, crops, names = [], [], []
        for ti, dets in enumerate(results):
            if (c_due is None or c_due[ti]) and c_frames is not None and c_frames[ti] is not None:
                gather_text_fields(c_frames[ti], dets, ti, refs, crops, names)
        if refs:
            for (ti, di), text in zip(refs, ocr_engine.read_fields(crops, names)):
                if text:
                    results[ti][di]["ocr_text"] = text

    def log_tick(tick, results, c_due):
        for ti, dets in enumerate(results):
            # an unchanged frame gives the same detections and the same state
            # transition: skip the update (which also keeps the text fields
            # of OCR-skipped ticks from being overwritten)
            if c_due is None or c_due[ti]:
                trackers[ti].update(dets)
            logs[ti].append(json.dumps(
                {"tick": tick, "detections": len(dets),
                 "fields": [d for d in dets if d["ocr_text"]]},
                separators=(",", ":"),
            ))

    batch_meta = collections.deque()  # frames travel with their batch
    prev_frame_refs: List = [None] * args.tables
    timer = StageTimer()
    done_frames = 0
    t_start = time.perf_counter()
    last_report = t_start
    steady_t0 = None
    steady_frames0 = 0
    tick = 0
    try:
        while args.ticks == 0 or tick < args.ticks:
            with timer.stage("capture"):
                frames = [next(s) for s in sources]
            due = [f is not prev_frame_refs[i] for i, f in enumerate(frames)]
            prev_frame_refs = list(frames)
            batch_meta.append((frames, due))
            with timer.stage("submit"):
                stream.submit_batch(frames)
            if stream.in_flight > 2:
                with timer.stage("collect"):
                    results = stream.collect_batch()
                c_frames, c_due = batch_meta.popleft()
                if ocr_engine is not None:
                    with timer.stage("ocr"):
                        read_text_fields_fleet(results, c_frames, c_due)
                log_tick(tick, results, c_due)
                done_frames += len(results)
                if args.save_every and tick % args.save_every == 0:
                    for tr in trackers:
                        tr.save()
            tick += 1
            if tick == args.warmup_ticks:
                steady_t0 = time.perf_counter()
                steady_frames0 = done_frames
            now = time.perf_counter()
            if now - last_report >= 1.0 and done_frames:
                fps = done_frames / (now - t_start)
                print(f"[serve] tables={args.tables} ticks={tick} frames/s={fps:.1f} "
                      f"({fps / args.tables:.1f} ticks/s/table) "
                      f"modes={stream.mode_counts} memo={stream.memo_hits}", file=sys.stderr)
                last_report = now
        while stream.in_flight:
            results = stream.collect_batch()
            c_frames, c_due = batch_meta.popleft() if batch_meta else (None, None)
            if ocr_engine is not None:
                read_text_fields_fleet(results, c_frames, c_due)
            log_tick(tick, results, c_due)
            done_frames += len(results)
    except KeyboardInterrupt:
        pass
    finally:
        # persist every table's game in progress
        for tr in trackers:
            tr.save()
        for lg in logs:
            lg.close()
        stream.close()
    wall = time.perf_counter() - t_start
    summary = {
        "tables": args.tables, "ticks": tick,
        "frames": done_frames, "wall_s": round(wall, 2),
        "frames_per_s": round(done_frames / max(wall, 1e-9), 2),
        "modes": stream.mode_counts, "memo_hits": stream.memo_hits,
    }
    if steady_t0 is not None and done_frames > steady_frames0:
        sw = time.perf_counter() - steady_t0
        summary["steady_frames_per_s"] = round((done_frames - steady_frames0) / max(sw, 1e-9), 2)
    if ocr_engine is not None:
        summary["ocr_errors"] = ocr_engine.errors
    print(json.dumps(summary))
    if args.stats:
        print(timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
