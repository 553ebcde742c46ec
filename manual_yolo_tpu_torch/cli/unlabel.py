"""Rank-crop dataset bootstrap. Counterpart of ``manual_yolo_tpu/cli/unlabel.py``
(the reference's ``unlabel.py``).

Usage:
  python -m manual_yolo_tpu_torch.cli.unlabel --data roadmap1.v3i.yolov8 \
      --split train --out rank_crops_unlabeled

Reads the class names of the YOLO dataset's ``data.yaml``
(``train/data.py::load_yolo_names``, no PyYAML), finds the ``*_rank``
classes, converts each label's normalised box to pixels, and writes the rank
regions of the split's images as ``<stem>_<class>_<line>.jpg`` crops into
``--out``, for sorting by hand into class folders. Images are read by
``runtime/png.py::imread_bgr`` and crops written by
``runtime/jpeg.py::write_jpeg`` at quality 95, so the files are the JAX
package's, byte for byte. A file the readers do not take raises, naming it
(the JAX package skips an image cv2 cannot decode). Host only: no model and
no device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Extract unlabeled rank crops (PyTorch port)")
    ap.add_argument("--data", default="roadmap1.v3i.yolov8")
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", default="rank_crops_unlabeled")
    args = ap.parse_args(argv)

    from manual_yolo_tpu_torch.runtime.jpeg import write_jpeg
    from manual_yolo_tpu_torch.runtime.png import imread_bgr
    from manual_yolo_tpu_torch.train.data import load_yolo_names

    names = load_yolo_names(args.data)
    rank_ids = {i for i, n in names.items() if n.endswith("_rank")}
    print("Rank class IDs:", sorted(rank_ids))
    print("Rank class names:", [names[i] for i in sorted(rank_ids)])

    img_dir = os.path.join(args.data, args.split, "images")
    lbl_dir = os.path.join(args.data, args.split, "labels")
    os.makedirs(args.out, exist_ok=True)

    saved = 0
    for label_file in sorted(os.listdir(lbl_dir)):
        if not label_file.endswith(".txt"):
            continue
        stem = label_file[:-4]
        img_path = None
        for ext in (".jpg", ".png", ".jpeg"):
            p = os.path.join(img_dir, stem + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            continue
        image = imread_bgr(img_path)
        h, w = image.shape[:2]
        with open(os.path.join(lbl_dir, label_file)) as f:
            lines = f.readlines()
        for idx, line in enumerate(lines):
            parts = line.split()
            if len(parts) < 5:
                continue
            cls = int(float(parts[0]))
            if cls not in rank_ids:
                continue
            xc, yc, bw, bh = (float(v) for v in parts[1:5])
            x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
            x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
            crop = image[max(0, y1) : y2, max(0, x1) : x2]
            if crop.size == 0:
                continue
            write_jpeg(os.path.join(args.out, f"{stem}_{names[cls]}_{idx}.jpg"), crop)
            saved += 1
    print(f"✅ {saved} crops saved in: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
