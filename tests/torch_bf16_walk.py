"""Where the port's bf16 detector parts from the JAX package's (a helper
with no tests).

On the deployment's tick that ``tests/torch_serve_golden.json`` holds
(``tests/torch_serve_cases.py``) and on the 4-table tick of
``tests/test_torch_serving.py::test_bf16_stream_matches_jax_bf16``
(YOLOv8s, the example scaled to 1200x1920 and shifted per table, conf
0.5) it prints the detections whose boxes lie farthest apart, both
packages' BatchStream in bf16 on the CPU; then, on the canvas of the table with the farthest box, each layer's
output of the port's bf16 forward against the JAX package's jitted one on
the same folded weights: the share of elements that differ, and of those
more than one bf16 ulp apart.

    env JAX_PLATFORMS=cpu python tests/torch_bf16_walk.py [--xla-silu]

``--xla-silu`` runs the port's hidden convs with SiLU as XLA computes it
in bf16, ``y * (1 / (1 + exp(-y)))`` with every op rounded to bf16, in
place of ``F.silu``'s one rounding; about 30 s.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFTS = [(0, 0), (2, 3), (-3, 1), (4, -2)]


def farthest(got: list, ref: list) -> list:
    """[(box px, table, class, JAX box, port box, JAX conf, port conf)], each
    JAX detection paired with the nearest port detection of its class,
    farthest first."""
    rows = []
    for t, (g_dets, r_dets) in enumerate(zip(got, ref)):
        left = list(g_dets)
        for r in r_dets:
            same = [d for d in left if d["class_id"] == r["class_id"]]
            if not same:
                continue
            g = min(same, key=lambda d: np.abs(np.subtract(d["bbox"], r["bbox"])).max())
            left.remove(g)
            rows.append((int(np.abs(np.subtract(g["bbox"], r["bbox"])).max()), t, r["class_name"],
                         r["bbox"], g["bbox"], r["conf"], g["conf"]))
    return sorted(rows, key=lambda r: -r[0])


def xla_silu_forward(self, x):
    """``ConvBlock.forward`` with XLA's bf16 SiLU."""
    import torch

    y = self.conv(x.to(self.conv.weight.dtype))
    if not self.act:
        return y.float() + self.bias[:, None, None]
    y = y + self.bias[:, None, None]
    return y * torch.reciprocal(torch.exp(-y) + 1)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from manual_yolo_tpu.core.serialization import load_params
    from manual_yolo_tpu.models import yolov8 as jy
    from manual_yolo_tpu.runtime import serving as jax_serving
    from manual_yolo_tpu_torch.models import yolov8 as py
    from manual_yolo_tpu_torch.ops.image import cv_resize_u8
    from manual_yolo_tpu_torch.runtime import serving as pt_serving
    from manual_yolo_tpu_torch.runtime.png import imread_bgr

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    if "--xla-silu" in sys.argv:
        py.ConvBlock.forward = xla_silu_forward
    det = os.path.join(REPO, "weights", "poker_detector.npz")
    cls = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
    base = cv_resize_u8(imread_bgr(os.path.join(REPO, "docs", "examples", "poker_labeled.png")),
                        (1200, 1920))
    frames = [np.ascontiguousarray(np.roll(base, s, axis=(0, 1))) for s in SHIFTS]
    kw = dict(batch=len(frames), imgsz=640, conf=0.5, delta=False)
    results = {}
    for name, stream in (
            ("jax", jax_serving.load_batch_stream(det, cls, compute_dtype=jnp.bfloat16,
                                                  use_pallas_nms=False, **kw)),
            ("port", pt_serving.load_batch_stream(det, cls, compute_dtype=torch.bfloat16,
                                                  device="cpu", **kw))):
        with stream:
            stream.submit_batch(frames)
            results[name] = stream.collect_batch()
    import torch_serve_cases as serve_cases

    with open(serve_cases.GOLDEN) as f:
        golden = json.load(f)["bfloat16"]
    for tick, got, ref in (("golden tick 0", serve_cases.port_tick("bfloat16"), golden),
                           ("shifted tables", results["port"], results["jax"])):
        rows = farthest(got, ref)
        for r in rows[:2]:
            print(json.dumps({"tick": tick, "box_px": r[0], "table": r[1], "class": r[2],
                              "jax_bbox": r[3], "port_bbox": r[4], "jax_conf": r[5],
                              "port_conf": r[6]}))
        print(json.dumps({"tick": tick, "max_conf_gap": max(abs(r[5] - r[6]) for r in rows)}))

    canvas = np.full((640, 640, 3), 114, np.uint8)
    pt_serving.letterbox_u8_into(canvas, frames[rows[0][1]], 640)
    x = (canvas[..., ::-1].astype(np.float32) / 255.0)[None].copy()
    params, meta = load_params(det)
    spec = jy.build_spec("detect", "s", int(meta["spec"]["nc"]))
    ref = jax.jit(lambda p, x: jy.forward_features(p, spec, x, jnp.bfloat16))(
        jy.fold_params(params, spec), jnp.asarray(x))
    model = py.load_jax_params(py.build_model(py.build_spec("detect", "s", spec.nc), torch.bfloat16),
                               py.fold_params(jax.device_get(params), spec)).eval()
    with torch.inference_mode():
        got = model.forward_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (g, r) in enumerate(zip(got, ref)):
        a = g.float().permute(0, 2, 3, 1).numpy()
        b = np.asarray(r.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30))) - 7)
        print(json.dumps({"layer": i, "kind": spec.layers[i].kind, "differ": float((a != b).mean()),
                          "over_1_ulp": float((np.abs(a - b) > ulp).mean())}))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    sys.exit(main())
