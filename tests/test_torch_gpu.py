"""The port on a CUDA card: the NMS kernel against its plain twin, the bf16
pipeline on the card against the f32 pipeline on the CPU, the CRNN and the OCR
engine on the card against the CPU, the host C++ library against its plain
twins (built by the card's host), and the batched NMS and the detector
engine's tiled batch, each in one kernel launch.

Every test here carries the ``gpu`` marker and skips without a card. The
file needs no JAX (the card's host has none), so on that host it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import crnn  # noqa: E402
from manual_yolo_tpu_torch.ops import ctc  # noqa: E402
from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain  # noqa: E402
from manual_yolo_tpu_torch.runtime import native, png  # noqa: E402
from manual_yolo_tpu_torch.runtime import ocr as pt_ocr  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8  # noqa: E402
from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.ops.letterbox import letterbox_batch  # noqa: E402
from manual_yolo_tpu_torch.parallel.inference import tiled_frames  # noqa: E402
from manual_yolo_tpu_torch.runtime.engine import DetectorEngine  # noqa: E402
from torch_loop_cases import nms_batch_inputs  # noqa: E402
from torch_nms_cases import NMS_CASES, nms_case  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_keep_kernel_matches_plain(cuda_device, case):
    """The CUDA kernel against its plain twin on the card: bit-exact."""
    boxes, valid, thres = nms_case(case)
    bt = torch.from_numpy(boxes).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    before = nms_keep.launches
    got = nms_keep(bt, vt, thres)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(bt, vt, thres))


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


@pytest.mark.gpu
@pytest.mark.parametrize("weights,img_h", [("crnn_real_a.npz", 32), ("crnn_h64.npz", 64)])
def test_crnn_on_card_matches_cpu(cuda_device, weights, img_h):
    """f32 logits (TF32 off) within 1e-4 of the CPU's."""
    params, _ = load_params(os.path.join(REPO, "weights", weights))
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (6, img_h, 256, 1)).astype(np.float32))
    with torch.inference_mode():
        got = crnn.from_jax_params(params, cuda_device)(x.to(cuda_device)).cpu()
        ref = crnn.from_jax_params(params, "cpu")(x)
    assert got.shape == (6, 64, crnn.NUM_CLASSES)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_host_library_matches_plain_twins(cuda_device):
    """The card host's g++ build of csrc/host.cpp: CTC beam and scores against
    the numpy twins, the PNG unfilter against _unfilter on all filter types."""
    rng = np.random.default_rng(3)
    for _ in range(4):
        logp = torch.log_softmax(torch.from_numpy(
            rng.normal(0, 3, (64, crnn.NUM_CLASSES)).astype(np.float32)), -1).numpy()
        got, ref = ctc.prefix_beam_decode(logp), ctc.prefix_beam_decode_plain(logp)
        assert [p for p, _ in got] == [p for p, _ in ref]
        cands = [p for p, _ in ref] + [(), (3, 3)]
        np.testing.assert_allclose(ctc.score_candidates(logp, cands),
                                   ctc.score_candidates_plain(logp, cands), rtol=1e-6)
    h, w, bpp = 7, 9, 3
    rows = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(h) % 5
    np.testing.assert_array_equal(native.png_unfilter(rows.reshape(-1), h, w * bpp, bpp),
                                  png._unfilter(rows.reshape(-1), h, w, bpp).reshape(h, -1))


def _text_crop(rng, h, w):
    """A light uint8 BGR crop with a few dark strokes."""
    img = np.full((h, w, 3), rng.integers(150, 230), np.uint8)
    for _ in range(int(rng.integers(3, 9))):
        y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        img[y:y + int(rng.integers(3, h // 2 + 4)), x:x + int(rng.integers(1, 4))] = rng.integers(0, 60)
    return img


@pytest.mark.gpu
def test_read_fields_conf_on_card_matches_cpu(cuda_device):
    """Seeded crops of every field kind: the same texts, confidences within 1e-3."""
    rng = np.random.default_rng(5)
    names = ["villian1_name", "villian1_stack", "total_pot", "game_id", "card1_rank", "my_bet"]
    crops = [_text_crop(rng, int(rng.integers(18, 34)), int(rng.integers(40, 160))) for _ in names]
    gpu = pt_ocr.default_ocr_engine(device=cuda_device)
    cpu = pt_ocr.default_ocr_engine(device="cpu")
    got, ref = gpu.read_fields_conf(crops, names), cpu.read_fields_conf(crops, names)
    assert [t for t, _ in got] == [t for t, _ in ref]
    assert max(abs(c - rc) for (_, c), (_, rc) in zip(got, ref)) <= 1e-3
    assert gpu.errors == 0 and cpu.errors == 0


@pytest.mark.gpu
def test_nms_batch_on_card_matches_cpu_in_one_launch(cuda_device):
    """A seeded batch with tied scores and an empty frame: the same Detections
    as the CPU (plain keep mask), from one kernel launch for the 4 frames."""
    boxes, scores = (torch.from_numpy(x) for x in nms_batch_inputs())
    before = nms_keep.launches
    got = pt_nms.nms_batch(boxes.to(cuda_device), scores.to(cuda_device),
                           conf_thres=0.25, iou_thres=0.6)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    ref = pt_nms.nms_batch(boxes, scores, conf_thres=0.25, iou_thres=0.6)
    assert int(ref.count[2]) == 0 and int(ref.count[1]) > 10
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.gpu
@pytest.mark.parametrize("frame_name", ["seeded_1200x1920", "poker_labeled"])
def test_detect_batch_of_tiles_is_one_launch(cuda_device, frame_name):
    """The hand session's tiled step at its defaults (imgsz 1280, conf 0.35,
    640-px tiles at 0.2): detect_batch makes one launch for all tiles (12 on
    the seeded frame, 6 on the example), and the keep masks of those tiles'
    candidates equal the plain twin's."""
    frame = (np.random.default_rng(0).integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
             if frame_name == "seeded_1200x1920" else pt_shot.imread_bgr(IMAGE))
    tiles, _ = tiled_frames(frame, 640, 0.2)
    assert len(tiles) == (12 if frame_name == "seeded_1200x1920" else 6)
    engine = DetectorEngine.from_npz(DET, imgsz=1280, conf=0.35, device=cuda_device)
    before = nms_keep.launches
    det = engine.detect_batch(tiles)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    assert det.boxes.shape == (len(tiles), 300, 4)
    with torch.inference_mode():
        rgb = torch.from_numpy(tiles).to(cuda_device).flip(-1)
        canvas, _, _ = letterbox_batch(rgb, (1280, 1280))
        boxes, scores = yolov8.decode_boxes(engine.model(canvas), (1280, 1280), engine.spec.strides)
        cand = pt_nms.nms_candidates(boxes, scores, conf_thres=0.35)
        kb, kv = cand.nms_boxes.contiguous(), cand.valid.contiguous()
        assert torch.equal(nms_keep(kb, kv, 0.7), nms_keep_plain(kb, kv, 0.7))

