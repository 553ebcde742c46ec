"""Hand-session CLI. Counterpart of ``manual_yolo_tpu/cli/pipe.py``.

Usage:
  python -m manual_yolo_tpu_torch.cli.pipe --source screen
  python -m manual_yolo_tpu_torch.cli.pipe --source shot.png --device cpu --max-frames 2

Defaults come from :class:`manual_yolo_tpu_torch.config.AppConfig` (the
``pipe`` section: imgsz 1280, conf 0.35, 640-px tiles at 0.2 overlap,
DeepSORT max_age 6, n_init 1); ``--config`` loads a JSON override file,
flags override that. The device defaults to ``cuda``; without a card the
command fails unless ``--device cpu`` is given.

The appearance embedder is built unless ``--no-embedder`` is given; with no
weights file (``default_embedder`` finds none) the tracker runs on motion
and IoU only. A weights file that fails to load raises, unlike the JAX
CLI, which falls back to motion only on any error. ``--show`` needs OpenCV
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--config", default=None,
                     help="JSON AppConfig file providing defaults")
    pre_args, _ = pre.parse_known_args(argv)

    from manual_yolo_tpu_torch.config import AppConfig
    from manual_yolo_tpu_torch.runtime.ocr import DEFAULT_RECOGNIZER_WEIGHTS

    cfg = AppConfig.load(pre_args.config)

    ap = argparse.ArgumentParser(
        description="Hand-session poker pipeline (PyTorch port)", parents=[pre]
    )
    ap.add_argument("--source", default="screen")
    ap.add_argument("--output-dir", default=cfg.pipe.output_folder)
    ap.add_argument("--detector", default=cfg.detector.weights)
    ap.add_argument("--ocr-weights",
                    default=cfg.ocr.recognizer_weights or DEFAULT_RECOGNIZER_WEIGHTS)
    ap.add_argument("--text-detector",
                    default=cfg.ocr.detector_weights or "weights/craft_real.npz",
                    help="CRAFT weights for multi-line read_region fallback")
    ap.add_argument("--imgsz", type=int, default=cfg.pipe.yolo_imgsz)  # pipe.py:41
    ap.add_argument("--conf", type=float, default=cfg.pipe.yolo_conf)  # pipe.py:42
    ap.add_argument("--fps", type=int, default=cfg.pipe.input_fps)  # pipe.py:36
    ap.add_argument("--hand-timeout", type=float, default=cfg.pipe.hand_timeout)
    ap.add_argument("--tile", type=int, default=cfg.pipe.tile)
    ap.add_argument("--tile-overlap", type=float, default=cfg.pipe.tile_overlap)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--show", action="store_true", help="debug overlay window")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing stats on exit")
    ap.add_argument("--no-embedder", action="store_true",
                    help="disable the appearance embedder (motion+IoU only)")
    ap.add_argument("--embedder-weights", default=cfg.track.embedder_weights,
                    help="appearance-embedder npz (default: auto — "
                         "weights/reid_embedder.npz when present, else the "
                         "rank-classifier backbone)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=cfg.detector.compute_dtype,
                    choices=["bfloat16", "float32"], help="the detector's compute dtype")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.runtime.capture import make_source
    from manual_yolo_tpu_torch.runtime.embedder import default_embedder
    from manual_yolo_tpu_torch.runtime.engine import DetectorEngine
    from manual_yolo_tpu_torch.runtime.hands import HandSessionPipeline
    from manual_yolo_tpu_torch.runtime.ocr import default_ocr_engine
    from manual_yolo_tpu_torch.track.deepsort import DeepSortTracker

    engine = DetectorEngine.from_npz(
        args.detector, imgsz=args.imgsz, conf=args.conf,
        compute_dtype=args.dtype, device=args.device,
    )
    pipeline = HandSessionPipeline(
        engine=engine,
        output_dir=args.output_dir,
        hand_timeout=args.hand_timeout,
        tile=args.tile,
        tile_overlap=args.tile_overlap,
        ocr=default_ocr_engine(args.ocr_weights, args.text_detector, device=args.device)
        if cfg.ocr.enabled else None,
        tracker=DeepSortTracker(
            max_age=cfg.pipe.deepsort_max_age,
            n_init=cfg.pipe.deepsort_n_init,
            max_cosine_distance=cfg.pipe.deepsort_max_cosine_distance,
            nn_budget=cfg.pipe.deepsort_nn_budget,
            # deep-sort-realtime embeds by default (pipe.py:161-162)
            embedder=None if args.no_embedder
            else default_embedder(args.embedder_weights, device=args.device),
        ),
    )
    source = make_source(args.source)
    pipeline.run(source, fps=args.fps, max_frames=args.max_frames, show=args.show)
    if args.stats:
        print(pipeline.timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
