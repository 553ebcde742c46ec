"""Detector evaluation CLI: mAP on a dataset split.
Counterpart of ``manual_yolo_tpu/cli/eval_det.py``.

    python -m manual_yolo_tpu_torch.cli.eval_det --weights <npz> --data <root> --split valid

Runs on the card unless ``--device cpu`` is given; prints the JAX CLI's JSON
(``split``, ``n_images``, ``checkpoint_meta``, ``map50``, ``map50_95``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate a detector checkpoint")
    ap.add_argument("--weights", default="weights/poker_detector.npz")
    ap.add_argument("--data", default="roadmap1.v3i.yolov8")
    ap.add_argument("--split", default="test", choices=["train", "valid", "test"])
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--iou", type=float, default=0.7)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from manual_yolo_tpu_torch.core.device import resolve_device
    from manual_yolo_tpu_torch.core.serialization import load_params
    from manual_yolo_tpu_torch.models import yolov8
    from manual_yolo_tpu_torch.train import data as data_lib
    from manual_yolo_tpu_torch.train.detector import evaluate_detector

    dev = resolve_device(args.device)
    params, meta = load_params(args.weights)
    sp = meta.get("spec", {})
    spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
    params = yolov8.fold_params(params, spec)
    samples = data_lib.load_yolo_split(args.data, args.split)
    cdt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    res = evaluate_detector(params, spec, samples, args.imgsz, conf=args.conf, iou=args.iou,
                            compute_dtype=cdt, device=dev)
    out = {
        "split": args.split,
        "n_images": len(samples),
        "checkpoint_meta": {k: meta.get(k) for k in ("map50", "map50_95", "epoch")},
        **{k: round(v, 4) for k, v in res.items()},
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
