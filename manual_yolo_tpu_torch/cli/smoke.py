"""Installation smoke check. Counterpart of ``manual_yolo_tpu/cli/smoke.py``.

    python -m manual_yolo_tpu_torch.cli.smoke [--device cpu]

Builds every engine on the device, checks the weights and prints one line
per component; the exit code is 0 only when every required check passes
(the OCR recognizer and the host library are optional, as in the JAX
package). The backend check names the card and the device count; it fails
without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    from manual_yolo_tpu_torch.runtime.ocr import DEFAULT_RECOGNIZER_WEIGHTS

    ap = argparse.ArgumentParser(description="Framework smoke check")
    ap.add_argument("--detector", default="weights/poker_detector.npz")
    ap.add_argument("--classifier", default="weights/rank_classifier_matched.npz")
    ap.add_argument("--ocr-weights", default=DEFAULT_RECOGNIZER_WEIGHTS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    failures = 0

    def check(name, fn, required=True):
        nonlocal failures
        try:
            extra = fn() or ""
            print(f"✅ {name} {extra}")
        except Exception as e:
            mark = "❌" if required else "⚠"
            print(f"{mark} {name}: {type(e).__name__}: {e}")
            if required:
                failures += 1

    def backend():
        import torch

        from manual_yolo_tpu_torch.core.device import resolve_device

        dev = resolve_device(args.device)
        if dev.type == "cuda":
            return f"(cuda, {torch.cuda.get_device_name(dev)}, {torch.cuda.device_count()} device(s))"
        return f"({dev.type}, torch {torch.__version__})"

    check("PyTorch backend", backend)

    def classifier():
        import numpy as np

        from manual_yolo_tpu_torch.models.classifier import RankClassifier

        clf = RankClassifier.load(args.classifier, device=args.device)
        out = clf.classify_crops([np.zeros((32, 24, 3), np.uint8)])
        return f"({len(clf.names)} classes, probe -> {out[0][0]!r})"

    check("rank classifier", classifier)

    def detector():
        from manual_yolo_tpu_torch.core.serialization import load_params
        from manual_yolo_tpu_torch.models import yolov8

        params, meta = load_params(args.detector)
        sp = meta.get("spec", {})
        spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
        yolov8.fold_params(params, spec)
        return f"(nc={spec.nc}, map50={meta.get('map50', '?')})"

    check("detector weights", detector)

    def ocr():
        import numpy as np

        from manual_yolo_tpu_torch.runtime.ocr import OCREngine

        eng = OCREngine.from_npz(args.ocr_weights, device=args.device)
        eng.read_batch([np.zeros((20, 60), np.float32)], "numeric")
        return f"(width={eng._groups[0].width})"

    check("OCR recognizer", ocr, required=False)

    def trackers():
        from manual_yolo_tpu_torch.track.bytetrack import ByteTrack
        from manual_yolo_tpu_torch.track.deepsort import DeepSortTracker

        ByteTrack().update([])
        DeepSortTracker().update_tracks([])
        return ""

    check("trackers", trackers)

    def native():
        from manual_yolo_tpu_torch.runtime.native import library

        library()
        return "(C++ host library)"

    check("native runtime", native, required=False)

    def capture():
        from manual_yolo_tpu_torch.runtime.capture import synthetic_source

        next(synthetic_source(hw=(64, 64)))
        return ""

    check("capture sources", capture)

    if os.environ.get("OPENAI_API_KEY"):
        print("✅ OPENAI_API_KEY present (LLM fallback enabled)")
    else:
        print("⚠ OPENAI_API_KEY not set (LLM fallback disabled)")

    print("PASS" if failures == 0 else f"FAIL ({failures} required checks failed)")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
