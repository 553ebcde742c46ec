"""Detector training CLI. Counterpart of ``manual_yolo_tpu/cli/train_det.py``.

    python -m manual_yolo_tpu_torch.cli.train_det --data <YOLO dataset root>

Runs on the card unless ``--device cpu`` is given; the dataset's images are
PNG files. ``--steps-per-epoch`` fixes the steps of an epoch (by default the
train split's size over the batch). Prints the JAX CLI's JSON
(``best_map50``, ``best_epoch``, ``wall_s``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the 64-class table detector")
    ap.add_argument("--data", default="roadmap1.v3i.yolov8",
                    help="YOLO dataset root (data.yaml + splits)")
    ap.add_argument("--out", default="weights/poker_detector.npz")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--patience", type=int, default=80)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="resume from last_<scale>.npz next to --out")
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.train.detector import DetTrainConfig, train_detector

    cfg = DetTrainConfig(
        data_root=args.data, out_path=args.out, epochs=args.epochs,
        batch=args.batch, imgsz=args.imgsz, patience=args.patience,
        lr=args.lr, scale=args.scale, eval_every=args.eval_every,
        resume=args.resume, steps_per_epoch=args.steps_per_epoch, device=args.device,
    )
    res = train_detector(cfg)
    print(json.dumps({k: v for k, v in res.items() if k != "history"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
