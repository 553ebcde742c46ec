"""The port on a CUDA card: the NMS kernel against its plain twin, and the
bf16 pipeline on the card against the f32 pipeline on the CPU.

Every test here carries the ``gpu`` marker and skips without a card. The
file needs no JAX (the card's host has none), so on that host it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _candidates(rng, b, k):
    xy = rng.uniform(0, 400, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    cls = rng.integers(0, 3, (b, k, 1)) * pt_nms.MAX_WH
    boxes = (np.concatenate([xy, xy + wh], -1) + cls).astype(np.float32)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    return boxes, valid


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(1, 512), (4, 512), (2, 37), (1, 2048)])
def test_nms_keep_kernel_matches_plain(cuda_device, b, k):
    """The CUDA kernel against its plain twin on the card: bit-exact."""
    boxes, valid = _candidates(np.random.default_rng(b * k), b, k)
    bt = torch.from_numpy(boxes).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    before = nms_keep.launches
    got = nms_keep(bt, vt, 0.7)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(bt, vt, 0.7))


@pytest.mark.gpu
def test_nms_keep_kernel_rejects_what_it_cannot_take(cuda_device):
    boxes = torch.zeros((1, 4096, 4), device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        nms_keep(boxes, torch.zeros((1, 4096), dtype=torch.bool, device=cuda_device), 0.5)
    boxes = torch.zeros((1, 8, 5), device=cuda_device)[..., :4]
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(boxes, torch.zeros((1, 8), dtype=torch.bool, device=cuda_device), 0.5)


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu(cuda_device):
    """bf16 on the card vs f32 on the CPU, with the golden tolerance of
    tests/test_golden_e2e.py: same classes, boxes within 5 px, same rank text."""
    kw = dict(imgsz=640, conf=0.5, iou=0.7)
    gpu = pt_shot.load_fused_pipeline(DET, CLS, device=cuda_device, compute_dtype="bfloat16", **kw)
    cpu = pt_shot.load_fused_pipeline(DET, CLS, device="cpu", compute_dtype="float32", **kw)
    frame = pt_shot.imread_bgr(IMAGE)
    before = nms_keep.launches
    got = gpu.process_frame(frame)
    assert nms_keep.launches == before + 1
    key = lambda d: (d["class_id"], d["bbox"][0], d["bbox"][1])
    got, ref = sorted(got, key=key), sorted(cpu.process_frame(frame), key=key)
    assert [d["class_name"] for d in got] == [d["class_name"] for d in ref]
    for g, r in zip(got, ref):
        assert np.abs(np.subtract(g["bbox"], r["bbox"])).max() <= 5
        if r["class_name"].endswith("_rank"):
            assert g["ocr_text"] == r["ocr_text"]
