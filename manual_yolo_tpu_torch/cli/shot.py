"""Single-screenshot CLI. Counterpart of ``manual_yolo_tpu/cli/shot.py``.

Usage:
  python -m manual_yolo_tpu_torch.cli.shot --image docs/examples/poker_labeled.png \
      --detector weights/poker_detector.npz \
      --classifier weights/rank_classifier_matched.npz [--device cpu]

The screenshot is a PNG, a JPEG or a BMP; the classifier a native ``.npz``
or an ultralytics ``.pt``. The result JSON goes to ``--output-json`` and the
annotated screenshot (boxes and ``class:text`` labels, as the JAX CLI draws
them) to ``--output-image`` (``.png``, ``.jpg`` or ``.bmp``; default
``poker_labeled.png``).

Defaults come from :class:`manual_yolo_tpu_torch.config.AppConfig`;
``--config`` loads a JSON override file, flags override that. The device
defaults to ``cuda``; without a card the command fails unless
``--device cpu`` is given. OCR runs when the config enables it (the
default), with the recognizer ensemble of ``--ocr-weights`` and the CRAFT
text detector of ``--text-detector``; ``--no-ocr`` turns it off. The
vision-LLM fallback (reference yolo.py:629-747) engages when
``OPENAI_API_KEY`` is set; ``--no-llm`` turns it off.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--config", default=None,
                     help="JSON AppConfig file providing defaults")
    pre_args, _ = pre.parse_known_args(argv)

    from manual_yolo_tpu_torch.config import AppConfig
    from manual_yolo_tpu_torch.runtime.ocr import DEFAULT_RECOGNIZER_WEIGHTS

    cfg = AppConfig.load(pre_args.config)

    ap = argparse.ArgumentParser(
        description="Poker single-screenshot detector (PyTorch port)", parents=[pre]
    )
    ap.add_argument("--image", required=True, help="input screenshot path (PNG, JPEG or BMP)")
    ap.add_argument("--output-json", default="poker_result.json")
    ap.add_argument("--output-image", default="poker_labeled.png")
    ap.add_argument("--detector", default=cfg.detector.weights)
    ap.add_argument("--classifier", default=cfg.rank.weights,
                    help="rank classifier, native .npz or ultralytics .pt")
    ap.add_argument("--imgsz", type=int, default=cfg.detector.imgsz)
    ap.add_argument("--conf", type=float, default=0.5)  # yolo.py:773 main uses 0.5
    ap.add_argument("--iou", type=float, default=cfg.detector.iou)
    ap.add_argument("--dtype", default=cfg.detector.compute_dtype,
                    choices=["bfloat16", "float32"])
    ap.add_argument("--ocr-weights",
                    default=cfg.ocr.recognizer_weights or DEFAULT_RECOGNIZER_WEIGHTS)
    ap.add_argument("--text-detector",
                    default=cfg.ocr.detector_weights or "weights/craft_real.npz",
                    help="CRAFT weights for the multi-line read_region fallback")
    ap.add_argument("--no-ocr", action="store_true", help="disable the OCR pass")
    ap.add_argument("--no-llm", action="store_true",
                    help="disable the vision-LLM fallback even if a key is set")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--accumulate", action="store_true",
                    help="merge into existing output JSON fill-don't-overwrite")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.runtime.ocr import default_ocr_engine
    from manual_yolo_tpu_torch.runtime.shot import load_fused_pipeline, process_screenshot

    pipeline = load_fused_pipeline(
        args.detector, args.classifier, imgsz=args.imgsz, conf=args.conf,
        iou=args.iou, compute_dtype=args.dtype, device=args.device,
    )
    # a missing weight file gives no engine; any other failure reaches the user
    ocr = None
    if not args.no_ocr and cfg.ocr.enabled:
        ocr = default_ocr_engine(args.ocr_weights, args.text_detector, device=args.device)
    result = process_screenshot(
        pipeline, args.image, args.output_json, args.output_image, ocr=ocr,
        accumulate=args.accumulate, use_llm_fallback=False if args.no_llm else None,
    )
    print(json.dumps(result, indent=2))
    print(f"saved {args.output_json} and {args.output_image}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
