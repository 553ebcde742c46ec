"""The serving tick that the bf16 checks hold against the JAX package (a
helper with no tests).

The tick: tick 0 of cli/serve.py's table-sim fleet of 4 tables, from the
example scaled to 1200x1920; the deployment's detector, YOLOv8s
(``weights/poker_detector.npz``), at imgsz 640 and the golden test's conf
0.5. ``torch_serve_golden.json`` holds the JAX package's results on it, in
bf16 and in f32: ``chip_smoke.py`` holds the card's bf16 tick against them,
and ``tests/test_torch_serving.py`` keeps them current.

Write the JSON again, and print the bf16-against-f32 confidence gaps of both
packages at conf 0.25 (where ``chip_smoke.py``'s ``GOLDEN_MARGIN`` comes
from), with ``env JAX_PLATFORMS=cpu python tests/torch_serve_cases.py``
(JAX and the port on the CPU, about a minute).
"""

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_S = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
GOLDEN = os.path.join(REPO, "tests", "torch_serve_golden.json")
TABLES, IMGSZ, CONF, HW = 4, 640, 0.5, (1200, 1920)
# bf16 against f32, a detection's confidence moves by at most this much (the
# largest gap this script measured, 0.026, rounded up): a detection this close
# to the gate may pass it in one dtype only
MARGIN = 0.03


def tick0(tables: int = TABLES) -> list:
    from manual_yolo_tpu_torch.cli.serve import table_sim_source
    from manual_yolo_tpu_torch.ops.image import cv_resize_u8
    from manual_yolo_tpu_torch.runtime.png import imread_bgr

    base = cv_resize_u8(imread_bgr(IMAGE), HW)
    return [next(table_sim_source(base, seed=i)) for i in range(tables)]


def frames_sha256(frames: list) -> str:
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    return h.hexdigest()


def jax_tick(dtype: str, conf: float = CONF) -> list:
    """The JAX package's BatchStream on tick 0 (``dtype`` "bfloat16" or
    "float32"), with its plain-XLA NMS."""
    import jax.numpy as jnp
    from manual_yolo_tpu.runtime import serving

    with serving.load_batch_stream(DET_S, CLS, batch=TABLES, imgsz=IMGSZ, conf=conf, delta=False,
                                   compute_dtype=getattr(jnp, dtype),
                                   use_pallas_nms=False) as s:
        s.submit_batch(tick0())
        return s.collect_batch()


def port_tick(dtype: str, conf: float = CONF) -> list:
    import torch
    from manual_yolo_tpu_torch.runtime import serving

    with serving.load_batch_stream(DET_S, CLS, batch=TABLES, imgsz=IMGSZ, conf=conf, delta=False,
                                   compute_dtype=getattr(torch, dtype), device="cpu") as s:
        s.submit_batch(tick0())
        return s.collect_batch()


def conf_gaps(got: list, ref: list) -> tuple:
    """Two runs of one tick, each detection paired with the nearest of its
    class within 5 px: (largest confidence gap of a pair, the confidences of
    the detections left unpaired)."""
    gap, unpaired = 0.0, []
    for g_dets, r_dets in zip(got, ref):
        left = list(g_dets)
        for r in r_dets:
            same = [d for d in left if d["class_id"] == r["class_id"]]
            g = min(same, key=lambda d: np.abs(np.subtract(d["bbox"], r["bbox"])).max(),
                    default=None)
            if g is None or np.abs(np.subtract(g["bbox"], r["bbox"])).max() > 5:
                unpaired.append(r["conf"])
                continue
            left.remove(g)
            gap = max(gap, abs(g["conf"] - r["conf"]))
        unpaired += [d["conf"] for d in left]
    return round(gap, 3), sorted(unpaired)


def main() -> int:
    golden = {"tables": TABLES, "imgsz": IMGSZ, "conf": CONF, "frame_hw": list(HW), "margin": MARGIN,
              "frames_sha256": frames_sha256(tick0()),
              "bfloat16": jax_tick("bfloat16"), "float32": jax_tick("float32")}
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=0)
        f.write("\n")
    for name, run in (("jax", jax_tick), ("port_cpu", port_tick)):
        gap, unpaired = conf_gaps(run("bfloat16", 0.25), run("float32", 0.25))
        print(json.dumps({"bf16_vs_f32_at_conf_0.25": name, "max_conf_gap": gap,
                          "unpaired_confs": unpaired}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
