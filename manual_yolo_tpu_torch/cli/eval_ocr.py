"""Real-crop OCR evaluation against human transcriptions. Counterpart of
``manual_yolo_tpu/cli/eval_ocr.py``.

``data/ocr_real/labels.json`` holds transcriptions of real UI crops from the
reference assets (the detection dataset's splits and test2.png). Truth and
prediction both go through the engine's per-kind validator, so the score is
end-to-end field accuracy.

    python -m manual_yolo_tpu_torch.cli.eval_ocr --weights weights/crnn_real_a.npz

Runs on the card unless ``--device cpu`` is given. Images are read with
``runtime/png.py::imread_bgr`` (PNG, JPEG or BMP) in place of
``cv2.imread``; a missing image is skipped, as cv2's ``None`` is.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from collections import defaultdict

from manual_yolo_tpu_torch.runtime.png import imread_bgr

DATASET_ROOT = "roadmap1.v3i.yolov8"  # the reference dataset's directory, as cli.train_det
TEST2 = "test2.png"  # the reference's test screenshot


def imread_or_none(path: str):
    """``cv2.imread``: the BGR image, or None for a missing file."""
    return imread_bgr(path) if os.path.exists(path) else None


def _train_holdout(stem: str) -> bool:
    """Deterministic ~1/3 image-level carve-out of the 'train' source for
    held-out evaluation, keyed by the md5 of the image stem."""
    return int(hashlib.md5(stem.encode()).hexdigest(), 16) % 3 == 0


def load_real_crops(labels_path: str, dataset_root: str = DATASET_ROOT,
                    pad: int = 2, splits=None):
    """Yield (crop_bgr, class_name, truth_text) for every labelled item.

    ``splits`` restricts to sources ('test', 'valid', 'test2'); None = all.
    'train_fit' (~2/3) and 'train_holdout' (~1/3) partition the 'train'
    source by image stem (``_train_holdout``)."""
    with open(labels_path) as f:
        d = json.load(f)
    img_cache = {}
    lbl_cache = {}
    for it in d["items"]:
        if not it.get("text"):
            continue
        split = it["src"].split("/", 1)[0] if "/" in it["src"] else it["src"]
        if splits is not None and split not in splits:
            if split != "train" or not ("train_fit" in splits or "train_holdout" in splits):
                continue
            stem = it["src"].split("/", 1)[-1]
            want = "train_holdout" if _train_holdout(stem) else "train_fit"
            if want not in splits:
                continue
        if it["src"] == "test2":
            if "test2" not in img_cache:
                img_cache["test2"] = imread_or_none(TEST2)
            img = img_cache["test2"]
            if img is None:
                continue
            x1, y1, x2, y2 = it["bbox"]
        else:
            split, stem = it["src"].split("/", 1)
            key = it["src"]
            if key not in img_cache:
                img_cache[key] = imread_or_none(
                    os.path.join(dataset_root, split, "images", stem + ".jpg"))
            img = img_cache[key]
            if img is None:
                continue
            h, w = img.shape[:2]
            lbl = os.path.join(dataset_root, split, "labels", stem + ".txt")
            if lbl not in lbl_cache:
                with open(lbl) as f:
                    lbl_cache[lbl] = [ln for ln in f.read().splitlines() if ln.strip()]
            parts = lbl_cache[lbl][it["row"]].split()
            xc, yc, bw, bh = (float(v) for v in parts[1:5])
            x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
            x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
        crop = img[max(0, y1 - pad): y2 + pad, max(0, x1 - pad): x2 + pad]
        if crop.size == 0:
            continue
        yield crop, it["class"], it["text"]


def evaluate_real(engine, labels_path: str, min_confidence: float = 0.0,
                  splits=("test", "test2"), dataset_root: str = DATASET_ROOT):
    """Exact-match accuracy per field kind on the real-crop set, the
    vision-LLM escalation rate at ``min_confidence``, and the rows."""
    from manual_yolo_tpu_torch.runtime.llm_fallback import IMPORTANT_KEYS
    from manual_yolo_tpu_torch.runtime.ocr import OCREngine, field_kind

    items = list(load_real_crops(labels_path, dataset_root, splits=splits))
    crops = [c for c, _, _ in items]
    names = [n for _, n, _ in items]
    pairs = engine.read_fields_conf(crops, names, min_confidence=min_confidence)

    per_kind = defaultdict(lambda: [0, 0])
    rows = []
    for (crop, cname, truth), (pred, conf) in zip(items, pairs):
        kind = field_kind(cname)
        truth_norm = OCREngine._validate(kind, cname.lower(), truth)
        ok = (pred or "") == (truth_norm or "")
        per_kind[kind][0] += int(ok)
        per_kind[kind][1] += 1
        rows.append({"class": cname, "truth": truth_norm, "pred": pred,
                     "ok": ok, "conf": round(float(conf), 4)})
    total_ok = sum(v[0] for v in per_kind.values())
    total_n = sum(v[1] for v in per_kind.values())
    # the important fields a live run would send to the vision-LLM fallback
    imp = set(IMPORTANT_KEYS)
    imp_rows = [r for r in rows if r["class"] in imp]
    unread = sum(1 for r in imp_rows if not r["pred"])
    return {
        "exact_match": total_ok / max(total_n, 1),
        "n": total_n,
        "per_kind": {k: {"acc": v[0] / v[1], "n": v[1]} for k, v in sorted(per_kind.items())},
        "llm_escalation": {
            "min_confidence": min_confidence,
            "important_n": len(imp_rows),
            "unread": unread,
            "rate": unread / max(len(imp_rows), 1),
        },
        "rows": rows,
    }


def gate_sweep(rows, gates=(0.0, 0.3, 0.5, 0.7, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99)):
    """Failure-gate calibration: per gate, the share of important fields that
    would escalate (unread or below the gate), the wrong reads it catches
    and the wrong reads it keeps."""
    from manual_yolo_tpu_torch.runtime.llm_fallback import IMPORTANT_KEYS
    from manual_yolo_tpu_torch.runtime.ocr import field_kind

    imp = set(IMPORTANT_KEYS)
    out = []
    for g in gates:
        esc = wrong_kept = wrong_caught = 0
        esc_by_kind = defaultdict(int)
        n_by_kind = defaultdict(int)
        imp_rows = [r for r in rows if r["class"] in imp]
        for r in imp_rows:
            kind = field_kind(r["class"])
            n_by_kind[kind] += 1
            if (not r["pred"]) or r["conf"] < g:
                esc += 1
                esc_by_kind[kind] += 1
                if not r["ok"]:
                    wrong_caught += 1
            elif not r["ok"]:
                wrong_kept += 1
        out.append({
            "gate": g,
            "important_n": len(imp_rows),
            "escalation_rate": round(esc / max(len(imp_rows), 1), 4),
            "errors_caught": wrong_caught,
            "errors_kept": wrong_kept,
            "escalation_by_kind": {k: round(esc_by_kind[k] / n_by_kind[k], 4)
                                   for k in sorted(n_by_kind)},
        })
    return out


def main(argv=None) -> int:
    from manual_yolo_tpu_torch.runtime.ocr import DEFAULT_RECOGNIZER_WEIGHTS, OCREngine

    ap = argparse.ArgumentParser(description="Evaluate OCR on real UI crops")
    ap.add_argument("--weights", default=DEFAULT_RECOGNIZER_WEIGHTS)
    ap.add_argument("--text-detector", default="",
                    help="optional CRAFT weights: enables the multi-line "
                         "detect-then-read fallback during eval")
    ap.add_argument("--labels", default="data/ocr_real/labels.json")
    ap.add_argument("--min-confidence", type=float, default=0.0)
    ap.add_argument("--splits", default="test,test2",
                    help="comma-separated sources (test, valid, test2, "
                         "train, train_fit, train_holdout)")
    ap.add_argument("--dump-errors", default=None,
                    help="write mismatching rows to this JSON file")
    ap.add_argument("--sweep-gates", action="store_true",
                    help="print the vision-LLM failure-gate calibration table")
    ap.add_argument("--no-beam", action="store_true",
                    help="greedy-only decode (no prefix-beam refinement)")
    ap.add_argument("--escalate", type=float, default=None,
                    help="beam escalation confidence threshold for ALL kinds")
    ap.add_argument("--dataset-root", default=DATASET_ROOT,
                    help="the YOLO dataset the labels' crops come from")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    engine = OCREngine.from_npz(args.weights, text_detector=args.text_detector or None,
                                device=args.device)
    if args.no_beam:
        engine.beam = False
    if args.escalate is not None:
        engine.beam_escalate_conf = {
            k: args.escalate for k in ("numeric", "name", "card", "game_id", "generic")
        }
    res = evaluate_real(engine, args.labels, args.min_confidence,
                        splits=tuple(args.splits.split(",")), dataset_root=args.dataset_root)
    rows = res.pop("rows")
    if args.sweep_gates:
        res["gate_sweep"] = gate_sweep(rows)
    errs = [r for r in rows if not r["ok"]]
    print(json.dumps(res, indent=2))
    if args.dump_errors:
        with open(args.dump_errors, "w") as f:
            json.dump(errs, f, indent=1)
        print(f"{len(errs)} errors -> {args.dump_errors}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
