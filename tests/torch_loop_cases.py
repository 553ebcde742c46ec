"""Inputs and helpers shared by the live-loop and hand-session parity tests
(tests/test_torch_live.py, tests/test_torch_hands.py): both packages'
detector engines at a small size, the frames they see, a fake clock, a stub
OCR and a tolerant comparison of nested results.

Small size: the committed YOLOv8n detector (``weights/poker_detector_n.npz``)
at imgsz 320 in f32. The tiled frame is the example scaled to 960 px wide
(540x960) on a 640x960 gray canvas: at ``tile=320`` it gives 12 tiles, the
batch the card's 1920x1200 frame gives at ``tile=640``.
"""

import os

import numpy as np

from manual_yolo_tpu_torch.ops.image import cv_resize_u8
from manual_yolo_tpu_torch.runtime.png import imread_bgr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_N = os.path.join(REPO, "weights", "poker_detector_n.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
REID = os.path.join(REPO, "weights", "reid_embedder.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
IMGSZ, TILE = 320, 320
SHIFTS = [(0, 0), (2, 3), (-3, 1), (4, -2)]  # (dy, dx) of the four steps
F32_TOL = 1e-4


def assert_f32_close(got, ref, scale: float = 1.0):
    """Within F32_TOL * scale, or one f32 ulp where that is larger (a box
    corner above 1024 px has an ulp of 1.2e-4). Boxes mapped back to a frame
    pass ``scale = 1 / letterbox ratio``: the tolerance holds in the units
    of the network's output, the letterbox canvas's pixels."""
    got, ref = np.asarray(got), np.asarray(ref)
    tol = np.maximum(F32_TOL * scale, np.spacing(np.abs(ref).astype(np.float32)))
    bad = np.abs(got.astype(np.float64) - ref) > tol
    assert not bad.any(), (got[bad], ref[bad])


def example() -> np.ndarray:
    return imread_bgr(IMAGE)


def tiled_example() -> np.ndarray:
    """The example scaled to 540x960 (bit for bit cv2's INTER_LINEAR) on a
    640x960 canvas of gray 114."""
    frame = np.full((640, 960, 3), 114, np.uint8)
    frame[:540] = cv_resize_u8(example(), (540, 960))
    return frame


def shifted(frame: np.ndarray):
    """The frame and three copies shifted by a few pixels, so tracks persist."""
    return [np.roll(frame, s, axis=(0, 1)) for s in SHIFTS]


def jax_engine(conf: float = 0.25, names=None):
    """The JAX package's DetectorEngine over DET_N at IMGSZ, f32, built as
    its cli/pipe.py builds it."""
    import jax.numpy as jnp

    from manual_yolo_tpu.core.serialization import load_params
    from manual_yolo_tpu.game import taxonomy
    from manual_yolo_tpu.models import yolov8
    from manual_yolo_tpu.runtime.engine import DetectorEngine

    params, meta = load_params(DET_N)
    sp = meta.get("spec", {})
    spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
    params = yolov8.fold_params(params, spec)
    names = names or {int(k): v for k, v in meta.get("names", {}).items()} or taxonomy.CLASSES
    return DetectorEngine(params, spec, names, imgsz=IMGSZ, conf=conf,
                          compute_dtype=jnp.float32)


def port_engine(conf: float = 0.25, names=None):
    from manual_yolo_tpu_torch.runtime.engine import DetectorEngine

    eng = DetectorEngine.from_npz(DET_N, imgsz=IMGSZ, conf=conf,
                                  compute_dtype="float32", device="cpu")
    if names:
        eng.names = names
    return eng


def nms_batch_inputs():
    """B=4 frames of 700 anchors, nc=6: random; scores on a coarse grid with
    whole rows repeated (ties in argmax and in top-k); all below the gate
    (empty); and clustered boxes."""
    rng = np.random.default_rng(11)
    b, a, nc = 4, 700, 6
    xy = rng.uniform(0, 500, (b, a, 2))
    xy[3] = rng.uniform(100, 140, (a, 2))
    wh = rng.uniform(8, 80, (b, a, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (b, a, nc)) ** 4).astype(np.float32)
    scores[1] = np.round(scores[1] * 8) / 8
    scores[1, 50:90] = scores[1, 49]
    boxes[1, 50:90] = boxes[1, 49]
    scores[2] *= 0.2
    return boxes, scores


class FakeClock:
    """Stands in for a module's ``time``: each ``time()`` call moves 0.5 s on."""

    def __init__(self, start: float = 1_000_000.0, tick: float = 0.5):
        self.now, self.tick = start, tick

    def time(self) -> float:
        self.now += self.tick
        return self.now

    def sleep(self, _seconds: float) -> None:
        pass


class StubOCR:
    """A field reader with no model: ``read_fields`` answers by class name,
    and a call reads the game id, which changes once after ``switch_after``
    reads."""

    TEXTS = {"my_stack": "1.2k", "total_pot": "350", "villian1_name": "bob"}

    def __init__(self, switch_after: int = 2):
        self.switch_after, self.calls = switch_after, 0

    def read_fields(self, crops, names, min_confidence=0.35):
        return [self.TEXTS.get(n, "7" if n.endswith("_rank") else None) for n in names]

    def __call__(self, crop, class_name):
        self.calls += 1
        return "G1" if self.calls <= self.switch_after else "G2"


BOX_KEYS = frozenset({"bbox", "coordinates", "x1", "y1", "x2", "y2"})


def assert_close(got, ref, path="", tol=1e-3, diffs=None, box=False):
    """Nested dicts/lists equal, but floats within ``tol`` and the integers
    of box corners (under a key of BOX_KEYS; ``int()`` truncates them)
    within 1 px. Those that differ are appended to ``diffs`` when given."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (path, got, ref)
        for k in ref:
            assert_close(got[k], ref[k], f"{path}.{k}", tol, diffs, box or k in BOX_KEYS)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{path}[{i}]", tol, diffs, box)
    elif isinstance(ref, (bool, str)) or ref is None:
        assert got == ref, (path, got, ref)
    elif isinstance(ref, (int, np.integer)):
        assert isinstance(got, (int, np.integer)), (path, got, ref)
        assert abs(int(got) - int(ref)) <= (1 if box else 0), (path, got, ref)
        if diffs is not None and int(got) != int(ref):
            diffs.append((path, int(got), int(ref)))
    else:
        assert abs(float(got) - float(ref)) <= tol, (path, got, ref)
