"""Single-screenshot CLI. Counterpart of ``manual_yolo_tpu/cli/shot.py``.

Usage:
  python -m manual_yolo_tpu_torch.cli.shot --image docs/examples/poker_labeled.png \
      --detector weights/poker_detector.npz \
      --classifier weights/rank_classifier_matched.npz [--device cpu]

Defaults come from :class:`manual_yolo_tpu_torch.config.AppConfig`;
``--config`` loads a JSON override file, flags override that. The device
defaults to ``cuda``; without a card the command fails unless
``--device cpu`` is given. OCR, the vision-LLM fallback and the annotated
image are not ported yet.
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

    cfg = AppConfig.load(pre_args.config)

    ap = argparse.ArgumentParser(
        description="Poker single-screenshot detector (PyTorch port)", parents=[pre]
    )
    ap.add_argument("--image", required=True, help="input screenshot path (PNG)")
    ap.add_argument("--output-json", default="poker_result.json")
    ap.add_argument("--detector", default=cfg.detector.weights)
    ap.add_argument("--classifier", default=cfg.rank.weights)
    ap.add_argument("--imgsz", type=int, default=cfg.detector.imgsz)
    ap.add_argument("--conf", type=float, default=0.5)  # yolo.py:773 main uses 0.5
    ap.add_argument("--iou", type=float, default=cfg.detector.iou)
    ap.add_argument("--dtype", default=cfg.detector.compute_dtype,
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--accumulate", action="store_true",
                    help="merge into existing output JSON fill-don't-overwrite")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.runtime.shot import load_fused_pipeline, process_screenshot

    pipeline = load_fused_pipeline(
        args.detector, args.classifier, imgsz=args.imgsz, conf=args.conf,
        iou=args.iou, compute_dtype=args.dtype, device=args.device,
    )
    result = process_screenshot(
        pipeline, args.image, args.output_json, accumulate=args.accumulate,
    )
    print(json.dumps(result, indent=2))
    print(f"saved {args.output_json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
