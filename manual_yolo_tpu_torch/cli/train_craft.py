"""CRAFT text-detector training CLI (synthetic multi-line scenes). Counterpart
of ``manual_yolo_tpu/cli/train_craft.py``.

    python -m manual_yolo_tpu_torch.cli.train_craft --out weights/craft_synth.npz

Runs on the card unless ``--device cpu`` is given; ``--dtype`` picks the
convs' compute type (bf16 by default, as the JAX trainer). Prints the JAX
CLI's JSON (``best_line_f1``, ``wall_s``).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the CRAFT text detector")
    ap.add_argument("--out", default="weights/craft_synth.npz")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--pool-size", type=int, default=2000)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--real-labels", default="",
                    help="data/ocr_real/labels.json to composite real crops")
    ap.add_argument("--real-splits", default="train,valid")
    ap.add_argument("--real-scene-frac", type=float, default=0.5)
    ap.add_argument("--panel-scene-frac", type=float, default=0.0,
                    help="fraction of scenes tiled with whole labeled "
                         "panels from the dataset train/valid splits")
    ap.add_argument("--init-from", default="",
                    help="warm-start weights (npz) instead of random init")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.train.craft import CraftTrainConfig, train_craft

    cfg = CraftTrainConfig(
        out_path=args.out, steps=args.steps, batch=args.batch, size=args.size,
        lr=args.lr, pool_size=args.pool_size, compute_dtype=args.dtype,
        real_labels=args.real_labels,
        real_splits=tuple(args.real_splits.split(",")),
        real_scene_frac=args.real_scene_frac,
        panel_scene_frac=args.panel_scene_frac,
        init_from=args.init_from, eval_every=args.eval_every, device=args.device,
    )
    res = train_craft(cfg)
    print(json.dumps({k: res[k] for k in ("best_line_f1", "wall_s")}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
