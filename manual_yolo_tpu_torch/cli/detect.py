"""Live detection CLI. Counterpart of ``manual_yolo_tpu/cli/detect.py``.

Usage:
  python -m manual_yolo_tpu_torch.cli.detect --source screen      # live capture
  python -m manual_yolo_tpu_torch.cli.detect --source shots_dir/ --max-frames 50
  python -m manual_yolo_tpu_torch.cli.detect --source shot.png --device cpu --stats

Defaults come from :class:`manual_yolo_tpu_torch.config.AppConfig`;
``--config`` loads a JSON override file and flags override that. The device
defaults to ``cuda``; without a card the command fails unless ``--device
cpu`` is given. Sources are the screen (needs ``mss``), ``synthetic``, or
a PNG, JPEG or BMP file or directory of them. ``--save-screenshots`` writes
the frames as ``.jpg`` into the output directory every
``live.screenshot_interval`` seconds, as the JAX CLI does; ``--show`` needs
a display window and raises ``NotImplementedError``.
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
        description="Live poker table detection (PyTorch port)", parents=[pre]
    )
    ap.add_argument("--source", default="screen",
                    help="'screen', 'synthetic', or a PNG, JPEG or BMP file or directory")
    ap.add_argument("--output-dir", default=cfg.live.output_folder)
    ap.add_argument("--detector", default=cfg.detector.weights)
    ap.add_argument("--classifier", default=cfg.rank.weights)
    ap.add_argument("--ocr-weights",
                    default=cfg.ocr.recognizer_weights or DEFAULT_RECOGNIZER_WEIGHTS)
    ap.add_argument("--text-detector",
                    default=cfg.ocr.detector_weights or "weights/craft_real.npz",
                    help="CRAFT weights for multi-line read_region fallback")
    ap.add_argument("--imgsz", type=int, default=cfg.detector.imgsz)
    ap.add_argument("--conf", type=float, default=cfg.detector.conf)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--show", action="store_true", default=cfg.live.show_window)
    ap.add_argument("--save-screenshots", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing stats on exit")
    ap.add_argument("--region", default=None,
                    help="capture region 'top,left,width,height' (detect.py:18)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=cfg.detector.compute_dtype,
                    choices=["bfloat16", "float32"], help="the detector's compute dtype")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.runtime.capture import make_source
    from manual_yolo_tpu_torch.runtime.live import LiveLoop
    from manual_yolo_tpu_torch.runtime.ocr import default_ocr_engine
    from manual_yolo_tpu_torch.runtime.shot import load_fused_pipeline

    pipeline = load_fused_pipeline(
        args.detector, args.classifier, imgsz=args.imgsz, conf=args.conf,
        iou=cfg.detector.iou, compute_dtype=args.dtype, device=args.device,
    )
    kwargs = {}
    if args.source == "screen":
        if args.region:
            t, l, w, h = (int(v) for v in args.region.split(","))
            kwargs["region"] = {"top": t, "left": l, "width": w, "height": h}
        else:
            r = cfg.region
            kwargs["region"] = {
                "top": r.top, "left": r.left, "width": r.width, "height": r.height,
            }
    source = make_source(args.source, **kwargs)

    loop = LiveLoop(
        pipeline=pipeline,
        output_dir=args.output_dir,
        game_update_interval=cfg.live.game_update_interval,
        screenshot_interval=cfg.live.screenshot_interval,
        show_window=args.show,
        save_screenshots=args.save_screenshots,
        ocr=default_ocr_engine(args.ocr_weights, args.text_detector, device=args.device)
        if cfg.ocr.enabled else None,
    )
    print("Starting live detection.")
    loop.run(source, max_frames=args.max_frames)
    if args.stats:
        print(loop.timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
