"""Rank-classifier training CLI. Counterpart of ``manual_yolo_tpu/cli/train_cls.py``.

    python -m manual_yolo_tpu_torch.cli.train_cls --data <root with train/ and valid/>

Runs on the card unless ``--device cpu`` is given; the dataset's images are
PNG files. Prints the JAX CLI's JSON (``best_top1``, ``best_epoch``,
``wall_s``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the rank classifier")
    ap.add_argument("--data", default="rank_classifier",
                    help="folder dataset root with train/ and valid/ (PNG files)")
    ap.add_argument("--out", default="weights/rank_classifier_scratch.npz")
    ap.add_argument("--epochs", type=int, default=50)  # class.py:24
    ap.add_argument("--batch", type=int, default=64)  # class.py:26
    ap.add_argument("--imgsz", type=int, default=64)  # class.py:25
    ap.add_argument("--patience", type=int, default=10)  # class.py:28
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--scale", default="n")
    ap.add_argument("--init-from", default=None, help="optional .pt warm start (not ported)")
    ap.add_argument("--init-from-npz", default=None,
                    help="optional native checkpoint warm start")
    ap.add_argument("--matched-npz", default=None,
                    help="distribution-matched crops npz (train/matched_crops.py)")
    ap.add_argument("--build-matched", default=None, metavar="DET_ROOT",
                    help="first build the matched npz from this YOLO dataset root (not ported)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.build_matched:
        raise NotImplementedError(
            "--build-matched re-crops the YOLO dataset's JPEG screenshots, which the "
            "port cannot read yet (ROADMAP Queue 1 item 7); data/rank_matched.npz holds "
            "the dataset it built")

    from manual_yolo_tpu_torch.train.classifier import ClsTrainConfig, train_classifier

    cfg = ClsTrainConfig(
        data_root=args.data, out_path=args.out, epochs=args.epochs,
        batch=args.batch, imgsz=args.imgsz, patience=args.patience,
        lr=args.lr, scale=args.scale, init_from=args.init_from,
        init_from_npz=args.init_from_npz, matched_npz=args.matched_npz,
        device=args.device,
    )
    res = train_classifier(cfg)
    print(json.dumps({k: v for k, v in res.items() if k != "history"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
