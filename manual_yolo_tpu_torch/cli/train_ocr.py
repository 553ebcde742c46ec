"""OCR recognizer training CLI (synthetic CRNN + CTC). Counterpart of
``manual_yolo_tpu/cli/train_ocr.py``.

    python -m manual_yolo_tpu_torch.cli.train_ocr --out weights/crnn_synth.npz

Runs on the card unless ``--device cpu`` is given. Prints the JAX CLI's
JSON (``best_exact``, ``wall_s``); the checkpoint is the JAX package's
format, with its meta (``hidden``, ``width``, ``img_h``, ``kinds``, ...).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the CRNN text recognizer")
    ap.add_argument("--out", default="weights/crnn_synth.npz")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--img-h", type=int, default=32,
                    help="input canvas height (64 = high-resolution member)")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pool-size", type=int, default=20000)
    ap.add_argument("--real-labels", default="",
                    help="data/ocr_real/labels.json to mix real crops in")
    ap.add_argument("--real-splits", default="valid",
                    help="comma-separated real sources for TRAINING "
                         "(test/test2 stay eval-only)")
    ap.add_argument("--real-frac", type=float, default=0.35)
    ap.add_argument("--seed", type=int, default=0,
                    help="init/augmentation seed (the real-crop holdout "
                         "split is seed-independent)")
    ap.add_argument("--init-from", default="",
                    help="warm-start checkpoint (fine-tune); geometry must match")
    ap.add_argument("--kinds", default="",
                    help="comma-separated field kinds to specialise on "
                         "(e.g. 'numeric,card'); written into the weight "
                         "meta so the engine gates the member")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.train.ocr import OCRTrainConfig, train_ocr

    cfg = OCRTrainConfig(
        out_path=args.out, steps=args.steps, batch=args.batch,
        width=args.width, img_h=args.img_h, hidden=args.hidden, lr=args.lr,
        pool_size=args.pool_size, real_labels=args.real_labels,
        real_splits=tuple(args.real_splits.split(",")), real_frac=args.real_frac,
        seed=args.seed, init_from=args.init_from, kinds=args.kinds,
        eval_every=args.eval_every, device=args.device,
    )
    res = train_ocr(cfg)
    print(json.dumps({k: res[k] for k in ("best_exact", "wall_s")}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
