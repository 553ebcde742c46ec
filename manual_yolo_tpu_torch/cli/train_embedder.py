"""Train the DeepSORT appearance (re-id) embedder. Counterpart of
``manual_yolo_tpu/cli/train_embedder.py``; see ``train/embedder.py`` for the
objective and data.

    python -m manual_yolo_tpu_torch.cli.train_embedder \
        --data roadmap1.v3i.yolov8 --out weights/reid_embedder.npz

The flags and defaults are the JAX CLI's, with ``--data`` defaulting to the
reference dataset's directory name (the JAX CLI names its mount), plus
``--device`` (``cuda`` unless ``cpu`` is given) and ``--dtype`` (the compute
dtype, f32 by default as in the JAX trainer). ``--data`` takes any YOLO
dataset root. Prints the JAX CLI's dict of rounded metrics.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the re-id embedder")
    ap.add_argument("--data", default="roadmap1.v3i.yolov8")
    ap.add_argument("--out", default="weights/reid_embedder.npz")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-npz", default="weights/rank_classifier_matched.npz")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.train.embedder import ReidTrainConfig, train_embedder

    cfg = ReidTrainConfig(
        data_root=args.data, out_path=args.out, epochs=args.epochs,
        batch=args.batch, lr=args.lr, temperature=args.temperature,
        seed=args.seed, init_from_npz=args.init_npz, compute_dtype=args.dtype,
        device=args.device,
    )
    metrics = train_embedder(cfg)
    print({k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
