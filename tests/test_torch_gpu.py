"""The port on a CUDA card: the NMS kernel against its plain twin, the bf16
pipeline on the card against the f32 pipeline on the CPU, the CRNN and the OCR
engine on the card against the CPU, the host C++ library against its plain
twins (built by the card's host), the batched NMS and the detector
engine's tiled batch, each in one kernel launch, the serving
BatchStream: one launch per tick, and its f32 rank reads equal to the CPU's
over 20 pipelined ticks, its delta codec's decoders on the card bit for bit
the CPU's, and training: three f32 train steps of each model
on the card against the CPU, the kernel on one eval batch of candidates
(B=8, conf 0.001), two bf16 detector steps, and ``cli.train_cls``; the
reference's formats: a .pt classifier's ``classify_crops`` on the card
against the CPU, and ``build_matched_rank_dataset`` over the JPEG fixtures
on the card against the CPU; what the screenshot and live CLIs write: the
annotated screenshot on the card in one launch, its PNG equal to
``annotate`` of the run's detections, and the JPEG encoder of the card's
host library giving cv2's committed hashes and writing the live loop's
screenshots; OCR training: three f32 CRNN steps and a bf16 CRAFT step on
the card against the CPU, and the TrueType stand-in on the card's host
(no PIL there) against PIL's committed results; the last modules: one f32
re-id embedder step on the card against the CPU, and ``ShardedDetector``
over a one-rank NCCL group in one launch, equal to the engine.

Every test here carries the ``gpu`` marker and skips without a card. The
file needs no JAX (the card's host has none), so on that host it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib
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
from manual_yolo_tpu_torch.cli.serve import table_sim_source  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_u8  # noqa: E402
from manual_yolo_tpu_torch.runtime import serving as pt_serving  # noqa: E402
from manual_yolo_tpu_torch.runtime.serving import load_batch_stream  # noqa: E402
from torch_loop_cases import nms_batch_inputs  # noqa: E402
from torch_nms_cases import NMS_CASES, nms_case  # noqa: E402
from torch_train_cases import MATCHED, detect_batch, rank_folder_dataset  # noqa: E402
from manual_yolo_tpu_torch.train import classifier as pt_cls  # noqa: E402
from manual_yolo_tpu_torch.train import detector as pt_det  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw  # noqa: E402
from manual_yolo_tpu_torch.train.data import DetectSample, make_eval_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
DET_N = os.path.join(REPO, "weights", "poker_detector_n.npz")
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
    the numpy twins, the PNG unfilter against _unfilter on all filter types,
    the 3:1 decimation and the uint8 linear resize against theirs."""
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
    frame = rng.integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
    dst = np.empty((400, 640, 3), np.uint8)
    assert native.decimate_u8_into(frame, dst, 3)
    np.testing.assert_array_equal(dst, native.decimate_u8_plain(frame, 3))
    for out in [(427, 640), (64, 91), (2000, 3000)]:
        crop = frame[:out[0] // 2 + 7, :out[1] // 3 + 5]
        np.testing.assert_array_equal(native.resize_u8(crop, out), cv_resize_u8(crop, out))


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



def _fleet_ticks(tables: int, ticks: int):
    """cli/serve.py's table-sim fleet from the example at 1200x1920."""
    base = cv_resize_u8(pt_shot.imread_bgr(IMAGE), (1200, 1920))
    sources = [table_sim_source(base, seed=i) for i in range(tables)]
    return [[next(src) for src in sources] for _ in range(ticks)]


@pytest.mark.gpu
def test_batch_stream_tick_is_one_launch(cuda_device):
    """Every tick (raw, skip with memo, slots, a dense change, which goes up
    as segs with the fused classify) is one forward and one keep-mask launch
    for all tables."""
    base = _fleet_ticks(4, 1)[0]
    rep = [base[0].copy()] + base[1:]
    rep[0][100:200, 300:400] = 0
    bright = [np.clip(f.astype(np.int16) + 3, 0, 255).astype(np.uint8) for f in base]
    with load_batch_stream(DET_N, CLS, batch=4, device=cuda_device) as s:
        for i, frames in enumerate([base, base, rep, bright]):
            before = nms_keep.launches
            s.submit_batch(frames)
            s.collect_batch()
            assert nms_keep.launches == before + 1, i
        assert s.mode_counts["raw"] == 1 and s.mode_counts["skip"] == 1
        assert s.mode_counts["slots"] == 1 and s.mode_counts["segs"] == 1 and s.memo_hits == 1


def _pipelined(stream, ticks):
    """cli/serve.py's loop: collect once more than 2 ticks are in flight, so
    the finisher's f32 classifier runs while the dispatcher's f32 detector
    runs on another thread."""
    out = []
    for frames in ticks:
        stream.submit_batch(frames)
        if stream.in_flight > 2:
            out.append(stream.collect_batch())
    while stream.in_flight:
        out.append(stream.collect_batch())
    return out


def _tf32_probs(stream, crops):
    """The stream's f32 classifier with TF32 forced on, as cuDNN's default
    (or a thread restoring the flags under another's forward) leaves it."""
    @contextlib.contextmanager
    def tf32():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    full_f32, yolov8.full_f32 = yolov8.full_f32, tf32
    try:
        return stream._classify_probs(crops).cpu().numpy()
    finally:
        yolov8.full_f32 = full_f32


F32_PROB_TOL = 1e-5


@pytest.mark.gpu
def test_batch_stream_f32_ranks_on_card_match_cpu(cuda_device):
    """20 pipelined ticks of a 4-table fleet in f32, on the card and on the
    CPU: the same classes, box corners within 1 px; and the CPU's host tail
    (crop gather, classifier, rank gates) on the card's readbacks gives the
    card's results exactly, with the f32 rank probabilities within 1e-5.
    The same crops through the card's classifier with TF32 forced on miss
    the CPU's by more: the check sees a forward that ran with TF32 on."""
    ticks = _fleet_ticks(4, 20)
    kw = dict(batch=4, compute_dtype=torch.float32)
    card = load_batch_stream(DET_N, CLS, device=cuda_device, **kw)
    cpu = load_batch_stream(DET_N, CLS, device="cpu", **kw)
    calls, probs = [], []
    finish, fused, classify = card._finish_batch, card._finish_batch_fused, card._classify_probs

    def rec_finish(frames, metas, flat, full):
        calls.append((frames, metas, flat.copy(), full.cpu(), None))
        return finish(frames, metas, flat, full)

    def rec_fused(frames, metas, flat, pred, full):
        calls.append((frames, metas, flat.copy(), full.cpu(), pred))
        return fused(frames, metas, flat, pred, full)

    def rec_classify(crops):
        out = classify(crops)
        probs.append((crops, out.cpu().numpy()))
        return out

    flags = []
    submit = card.submit_batch

    def rec_submit(frames):
        submit(frames)
        flags.append(card._pending[-1]["memo"])

    card._finish_batch, card._finish_batch_fused = rec_finish, rec_fused
    card._classify_probs, card.submit_batch = rec_classify, rec_submit
    try:
        got, ref = _pipelined(card, ticks), _pipelined(cpu, ticks)
        assert card.mode_counts == cpu.mode_counts and card.memo_hits == cpu.memo_hits
        for g_tick, r_tick in zip(got, ref):
            for g_dets, r_dets in zip(g_tick, r_tick):
                assert sorted(d["class_name"] for d in g_dets) == sorted(d["class_name"] for d in r_dets)
                left = list(g_dets)
                for r in r_dets:
                    g = min((d for d in left if d["class_id"] == r["class_id"]),
                            key=lambda d: np.abs(np.subtract(d["bbox"], r["bbox"])).max())
                    left.remove(g)
                    assert np.abs(np.subtract(g["bbox"], r["bbox"])).max() <= 1
        cpu._rect_cache, cpu._prev_crops, cpu._last_cls_probs = {}, None, None
        ref_probs = []
        cpu_classify = cpu._classify_probs

        def rec_cpu(crops):
            out = cpu_classify(crops)
            ref_probs.append(out.numpy())
            return out

        cpu._classify_probs = rec_cpu
        replay = [cpu._finish_batch(frames, metas, flat, full) if pred is None
                  else cpu._finish_batch_fused(frames, metas, flat, pred, full)
                  for frames, metas, flat, full, pred in calls]
        assert sum(flags) == card.memo_hits and len(probs) == len(ref_probs) > 0
        assert replay == [g for g, memo in zip(got, flags) if not memo]
        assert max(float(np.abs(p - r).max()) for (_, p), r in zip(probs, ref_probs)) <= F32_PROB_TOL
        assert float(np.abs(_tf32_probs(card, probs[0][0]) - ref_probs[0]).max()) > F32_PROB_TOL
        assert sum(bool(d["ocr_text"]) for dets in replay[0] for d in dets) >= 4
    finally:
        card.close()
        cpu.close()


@pytest.mark.gpu
def test_codec_decoders_on_card_match_cpu(cuda_device):
    """Serving's delta-codec decoders on the card against the CPU, bit for bit,
    and against the encoded plane: segs over a canvas's content rows (a
    photometric shift that clips, noise, a repaint) and over a crop plane,
    the content-rows tribit and nibble, and the whole-canvas nibble."""
    rng = np.random.default_rng(4)
    B, S, top, nh = 4, 160, 20, 120
    prev = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    cur = prev.copy()
    act = slice(top, top + nh)
    cur[0, act] = np.clip(prev[0, act].astype(np.int16) + 9, 0, 255).astype(np.uint8)
    cur[1, act] = np.clip(prev[1, act].astype(np.int16) + rng.integers(-2, 3, (nh, S, 3)),
                          0, 255).astype(np.uint8)
    cur[2, top + 5:top + 25, 30:90] = rng.integers(0, 256, (20, 60, 3), np.uint8)
    small = np.clip(prev.astype(np.int16) + rng.integers(-3, 4, prev.shape), 0, 255).astype(np.uint8)

    def both(decode, payload, prev_plane, *args):
        out = [decode(torch.from_numpy(payload).to(dev), torch.from_numpy(prev_plane).to(dev),
                      *args).cpu().numpy() for dev in (cuda_device, "cpu")]
        np.testing.assert_array_equal(out[0], out[1])
        return out[0]

    def segs(cur_p, prev_p, top_p, nh_p, segw):
        n, h, w, _ = cur_p.shape
        nseg = n * nh_p * (w // segw)
        bufs = pt_serving.BatchStream._make_segs_bufs(segw, nseg, n * nh_p * w * 3, 1)
        counts = native.seg_encode(cur_p, prev_p, top_p, nh_p, segw, *(bufs[k] for k in (
            "p1", "p2", "p3", "raw", "m4", "m8", "s4", "s8", "nib", "byte", "bias", "cls")))
        segb = segw * 3
        payload, npb = pt_serving.BatchStream._assemble_segs_payload(
            bufs, 0, counts, (segb // 8, segb // 4, segb * 3 // 8, segb), nseg, n, n * nh_p * w * 3)
        got = both(pt_serving._segs_decoder(n, h, w, top_p, nh_p, segw, npb), payload.copy(), prev_p)
        want = cur_p.copy()
        want[:, :top_p] = 114
        want[:, top_p + nh_p:] = 114
        np.testing.assert_array_equal(got.reshape(cur_p.shape), want)

    segs(cur, prev, top, nh, 40)
    segs(small[:, :64, :64].copy(), prev[:, :64, :64].copy(), 0, 64, 64)  # 4 crops
    for kind, rows in (("tribit", (top, nh)), ("nibble", (top, nh)), ("nibble", (0, S))):
        t, n = rows
        n_val = B * n * S * 3
        n_pay, n_bias = (n_val * 3 // 8, B * n * 3) if kind == "tribit" else (n_val // 2, B * 3)
        payload = np.zeros(n_pay + n_bias, np.uint8)
        encode = native.tribit_encode if kind == "tribit" else native.nibble_encode
        assert encode(small, prev, t, n, payload[:n_pay], payload[n_pay:])
        decode = pt_serving.tribit_decode if kind == "tribit" else pt_serving.nibble_decode
        got = both(lambda p, q: decode(p, q, B, S, S, t, n), payload, prev)
        want = prev.copy()
        want[:, t:t + n] = small[:, t:t + n]
        np.testing.assert_array_equal(got.reshape(prev.shape), want)


def _train_models(variant, device, dtype=torch.float32):
    """A train model (and for the detector its EMA twin) from the committed
    checkpoint, BN unfolded, with an AdamW as its trainer builds it."""
    params, meta = load_params(DET_N if variant == "detect" else CLS)
    spec = yolov8.build_spec(variant, "n", int(meta["spec"]["nc"]))
    model = yolov8.load_jax_params(yolov8.build_model(spec, dtype, train=True), params).to(device).train()
    if variant == "detect":
        return model, adamw(model.parameters(), 5e-4)
    return model, adamw(pt_cls.decay_groups(model, 5e-4), 5e-4)


def _three_steps(variant, device, dtype=torch.float32):
    """(losses, the first step's gradients, trainable weights, BN statistics)
    of three steps at lr 1e-3 (two in bf16) from the committed checkpoint on
    a seeded batch."""
    model, opt = _train_models(variant, device, dtype)
    losses = []
    if variant == "detect":
        ema = _train_models(variant, device, dtype)[0].eval()
        x, t, m = (torch.from_numpy(a).to(device) for a in detect_batch(2, 128, 6, model.spec.nc))
        for k in range(3 if dtype == torch.float32 else 2):
            losses.append(float(pt_det.detect_step(model, ema, opt, x, t, m, k, 1e-3)[0]))
            grads = grads if k else torch.cat([p.grad.float().flatten().cpu() for p in model.parameters()])
    else:
        z = np.load(MATCHED)
        x = torch.from_numpy(z["train_x"][:64].astype(np.float32) / 255.0).to(device)
        y = torch.from_numpy(z["train_y"][:64].astype(np.int32)).to(device)
        for k in range(3):
            losses.append(float(pt_cls.classify_step(model, opt, x, y, 1e-3)))
            grads = grads if k else torch.cat([p.grad.float().flatten().cpu() for p in model.parameters()])
    flat = lambda ts: torch.cat([t.detach().float().flatten().cpu() for t in ts]).numpy()
    stats = [b for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")]
    return losses, grads, flat(model.parameters()), flat(stats)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["detect", "classify"])
def test_three_f32_train_steps_on_card_match_cpu(cuda_device, variant):
    """Three f32 train steps (TF32 off) at lr 1e-3 from the committed
    checkpoint on the card and on the CPU, held as ``chip_smoke.py``'s
    ``train_f32_vs_cpu`` holds them (its note gives the reasons): the first
    loss within 1e-5 relative and its gradients within 1e-4 of the largest
    (2e-3 for the detector, whose SPPF max pools route tied gradients
    differently on the two devices);
    the later losses within 1e-3; the median weight within 3e-5, all but 5%
    of the weights within 3e-4, every one within 1e-2; BN statistics within
    5e-3 relative."""
    got, got_g, got_w, got_s = _three_steps(variant, cuda_device)
    ref, ref_g, ref_w, ref_s = _three_steps(variant, torch.device("cpu"))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    grad_tol = 2e-3 if variant == "detect" else 1e-4
    assert float((got_g - ref_g).abs().max()) <= grad_tol * float(ref_g.abs().max())
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    dw = np.abs(got_w - ref_w)
    assert np.median(dw) <= 3e-5 and (dw > 3e-4).mean() <= 0.05 and dw.max() <= 1e-2
    np.testing.assert_allclose(got_s, ref_s, rtol=5e-3, atol=5e-3)


@pytest.mark.gpu
def test_two_bf16_detector_steps_are_finite(cuda_device):
    losses, _, weights, stats = _three_steps("detect", cuda_device, torch.bfloat16)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert np.all(np.isfinite(weights)) and np.all(np.isfinite(stats))


@pytest.mark.gpu
def test_nms_keep_on_an_eval_batch(cuda_device):
    """The candidates of one evaluate_detector batch (8 frames at imgsz 640,
    conf 0.001: nearly every one of the 512 slots valid) through the kernel
    and the plain twin: bit for bit, one launch."""
    params, meta = load_params(DET_N)
    spec = yolov8.build_spec("detect", "n", int(meta["spec"]["nc"]))
    model = yolov8.load_jax_params(yolov8.build_model(spec), yolov8.fold_params(params, spec))
    model = model.to(cuda_device).eval()
    frame = png.imread_bgr(IMAGE)
    frames = np.stack([np.roll(frame, (3 * i, -5 * i), (0, 1)) for i in range(8)])
    imgs = make_eval_batch([DetectSample(f, np.zeros((0, 4), np.float32), np.zeros(0, np.int32))
                            for f in frames], 640)[0]
    with torch.no_grad():
        boxes, scores = yolov8.decode_boxes(model(torch.from_numpy(imgs).to(cuda_device)),
                                            (640, 640), spec.strides)
    cand = pt_nms.nms_candidates(boxes, scores, conf_thres=0.001)
    b, v = cand.nms_boxes.contiguous(), cand.valid.contiguous()
    assert b.shape == (8, 512, 4) and int(v.sum()) > 8 * 400
    before = nms_keep.launches
    got = nms_keep(b, v, 0.7)
    assert nms_keep.launches == before + 1
    assert torch.equal(got, nms_keep_plain(b, v, 0.7))


@pytest.mark.gpu
def test_cli_train_cls_one_epoch_on_card(cuda_device, tmp_path, capsys):
    from manual_yolo_tpu_torch.cli import train_cls

    root, _ = rank_folder_dataset(str(tmp_path / "ds"), per_class=(5, 2))
    out = str(tmp_path / "run" / "best.npz")
    assert train_cls.main(["--data", root, "--out", out, "--epochs", "1", "--batch", "16",
                           "--init-from-npz", CLS]) == 0
    res = capsys.readouterr().out
    assert '"best_top1"' in res and os.path.exists(out)


@pytest.mark.gpu
def test_pt_classifier_classify_crops_on_card_match_cpu(cuda_device, tmp_path):
    """A .pt written from the committed rank classifier: on the card the same
    names as the CPU, confidences within 1e-5, logits equal to the .npz's."""
    from manual_yolo_tpu_torch.models.classifier import RankClassifier
    from torch_pt_cases import write_from_npz

    pt = str(tmp_path / "rank.pt")
    write_from_npz(pt, CLS, ema="model_off")
    card = RankClassifier.from_torch_checkpoint(pt, device=cuda_device)
    cpu = RankClassifier.from_torch_checkpoint(pt, device="cpu")
    with np.load(MATCHED) as z:
        x = z["valid_x"][:24]
    rng = np.random.default_rng(0)
    crops = [np.ascontiguousarray(c[::int(rng.integers(1, 3)), :, ::-1]) for c in x]
    got, ref = card.classify_crops(crops), cpu.classify_crops(crops)
    assert [n for n, _ in got] == [n for n, _ in ref]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in ref], rtol=0, atol=1e-5)
    batch = torch.rand(4, 64, 64, 3, device=cuda_device)
    npz = RankClassifier.from_npz(CLS, device=cuda_device)
    assert torch.equal(card.logits(batch), npz.logits(batch))


@pytest.mark.gpu
def test_build_matched_on_card_matches_cpu(cuda_device, tmp_path, capsys):
    """Matched crops re-cut from JPEG screenshots (the committed fixtures)
    on the card: the CPU's labels and bytes."""
    from manual_yolo_tpu_torch.train.matched_crops import build_matched_rank_dataset
    from torch_train_cases import matched_sources

    shots = [os.path.join(REPO, "tests", "torch_jpeg", f)
             for f in ("poker_labeled_420.jpg", "frame_1200x1920.jpg")]
    det, rank = str(tmp_path / "det"), str(tmp_path / "rank")
    matched_sources(det, rank, shots)
    for split, jitter in (("train", 2), ("valid", 0)):
        got = build_matched_rank_dataset(rank, det, split, jitter=jitter, device=cuda_device)
        ref = build_matched_rank_dataset(rank, det, split, jitter=jitter, device="cpu")
        assert got[2] == ref[2] and len(got[1]) == 13 * (jitter + 1)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])


class _Recording:
    """Delegates process_frame and keeps the detections it returned."""

    def __init__(self, pipeline):
        self.pipeline, self.dets = pipeline, None

    def process_frame(self, frame):
        self.dets = self.pipeline.process_frame(frame)
        return [dict(d) for d in self.dets]


@pytest.mark.gpu
def test_annotated_shot_on_card_is_one_launch(cuda_device, tmp_path):
    """process_screenshot with its default output image on the card: one
    kernel launch; the PNG equals annotate() of the run's detections and
    the input frame outside the drawn boxes and labels."""
    from manual_yolo_tpu_torch.ops import nms_kernel
    from manual_yolo_tpu_torch.runtime.draw import text_size

    pipe = _Recording(pt_shot.load_fused_pipeline(DET, CLS, imgsz=640, conf=0.5,
                                                  device=cuda_device))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        nms_kernel.nms_keep.launches = 0
        pt_shot.process_screenshot(pipe, IMAGE, "r.json", use_llm_fallback=False)
        torch.cuda.synchronize()
        assert nms_kernel.nms_keep.launches == 1
        got = png.imread_bgr("poker_labeled.png")
    finally:
        os.chdir(cwd)
    frame = png.imread_bgr(IMAGE)
    np.testing.assert_array_equal(got, pt_shot.annotate(frame, pipe.dets))
    drawn = np.zeros(frame.shape[:2], bool)
    for d in pipe.dets:
        x1, y1, x2, y2 = d["bbox"]
        drawn[max(0, y1 - 1):y2 + 2, max(0, x1 - 1):x2 + 2] = True
        (w, h), base = text_size(f"{d['class_name']}:{d.get('ocr_text') or ''}", 0.5)
        oy = max(0, y1 - 5)
        drawn[max(0, oy - h):oy + base + 1, max(0, x1):x1 + w] = True
    np.testing.assert_array_equal(got[~drawn], frame[~drawn])
    assert len(pipe.dets) >= 10


@pytest.mark.gpu
def test_jpeg_encoder_on_card_host(cuda_device, tmp_path, monkeypatch):
    """The host library built on the card's host encodes the committed cases
    to cv2's hashes, and the live loop on the card writes its screenshots
    through it: one encode per saved frame, the bytes of encode_jpeg."""
    import hashlib

    from manual_yolo_tpu_torch.runtime.jpeg import encode_jpeg
    from manual_yolo_tpu_torch.runtime.live import LiveLoop
    from torch_encode_cases import CASES, load_hashes, sources

    committed = load_hashes()["cases"]
    src = sources(png.imread_bgr)
    for name, (source, quality) in CASES.items():
        digest = hashlib.sha256(encode_jpeg(src[source], quality)).hexdigest()
        assert digest == committed[name]["sha256"], name
    calls = []
    real = native.jpeg_encode
    monkeypatch.setattr(native, "jpeg_encode", lambda img, q: calls.append(q) or real(img, q))
    pipe = pt_shot.load_fused_pipeline(DET_N, CLS, imgsz=320, conf=0.25, device=cuda_device)
    loop = LiveLoop(pipeline=pipe, output_dir=str(tmp_path), save_screenshots=True,
                    screenshot_interval=0.0)
    frame = png.imread_bgr(IMAGE)
    loop.run(iter([frame, frame[::-1].copy()]), max_frames=2)
    shots = sorted(f for f in os.listdir(tmp_path) if f.endswith(".jpg"))
    assert len(shots) == 2 and calls == [95, 95]
    assert (tmp_path / shots[0]).read_bytes() in (encode_jpeg(frame), encode_jpeg(frame[::-1]))


@pytest.mark.gpu
def test_truetype_renders_match_committed_pil_results(cuda_device):
    """The card's host has no PIL and no fonts: the glyph table's layout,
    masks and blur give PIL's committed results there too."""
    import json

    import torch_truetype_cases

    with open(torch_truetype_cases.EXPECT) as f:
        assert json.load(f) == torch_truetype_cases.port_expectations()


def _ocr_batches(n: int, batch: int):
    from manual_yolo_tpu_torch.train import ocr as pt_ocr_train

    cfg = pt_ocr_train.OCRTrainConfig(width=128, hidden=32, batch=batch)
    imgs, labels, pad, _ = pt_ocr_train.build_pool(np.random.default_rng(0), cfg, n * batch)
    imgs = (np.clip(imgs[..., 0] * 255 + 0.5, 0, 255).astype(np.uint8)).astype(np.float32) / 255
    return [(imgs[k * batch:(k + 1) * batch], labels[k * batch:(k + 1) * batch],
             pad[k * batch:(k + 1) * batch]) for k in range(n)]


@pytest.mark.gpu
def test_three_f32_crnn_steps_on_card_match_cpu(cuda_device):
    """Three f32 ``ocr_step``s (CRNN hidden 32, width 128, batch 8) from one
    initialisation on the card and the CPU: the first loss within 1e-5
    relative, the later within 1e-3, every parameter within 2 x the summed
    learning rates and 1e-6 (AdamW's lr * sign(g) on gradients the devices
    round apart near 0; the weights' own f32 rounding)."""
    from manual_yolo_tpu_torch.train import ocr as pt_ocr_train

    batches = _ocr_batches(3, 8)
    lrs = [5e-5, 6e-5, 7e-5]
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = crnn.for_training(crnn.from_jax_params(
            crnn.init_params(torch.Generator().manual_seed(0), 32), dev).train())
        params = [p for p in model.parameters() if p.requires_grad]
        opt = adamw(params, pt_ocr_train.WEIGHT_DECAY)
        losses = [float(pt_ocr_train.ocr_step(model, opt, params, *(torch.from_numpy(a).to(dev)
                                                                    for a in b), lr))
                  for b, lr in zip(batches, lrs)]
        runs[dev.type] = (losses, crnn.to_jax_params(model))
    (lc, pc), (lr_, pr) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc[0], lr_[0], rtol=1e-5)
    np.testing.assert_allclose(lc[1:], lr_[1:], rtol=1e-3)
    for k in pr:
        for n in pr[k]:
            np.testing.assert_allclose(pc[k][n], pr[k][n], rtol=0, atol=2 * sum(lrs) + 1e-6,
                                       err_msg=f"{k}.{n}")


@pytest.mark.gpu
def test_bf16_craft_step_on_card_matches_cpu(cuda_device):
    """One bf16 ``craft_step`` at 64x64, batch 2, from one initialisation on
    the card and the CPU: the loss within 2e-2 relative (each conv's output
    rounded to bf16 on both, by different conv algorithms), every parameter
    within 2 x lr and 1e-6 (AdamW's first step is lr * g / (|g| + eps): a
    weight whose bf16 gradients' signs differ steps 2 x lr apart, measured
    on 6% of vgg.0's), the running statistics within 5e-2 relative to
    1 + |x|."""
    from manual_yolo_tpu_torch.models import craft
    from manual_yolo_tpu_torch.train import craft as pt_craft_train

    x, y, _ = pt_craft_train.build_pool(np.random.default_rng(1),
                                        pt_craft_train.CraftTrainConfig(pool_size=2, size=64))
    params0 = craft.init_params(torch.Generator().manual_seed(0))
    lr, out = 1e-4, {}
    for dev in (cuda_device, torch.device("cpu")):
        model = craft.from_jax_params(params0, dev)
        model.compute_dtype = torch.bfloat16
        params = list(model.parameters())
        opt = adamw(params, pt_craft_train.WEIGHT_DECAY)
        loss = pt_craft_train.craft_step(model, opt, params, torch.from_numpy(x).to(dev),
                                         torch.from_numpy(y).to(dev), lr)
        out[dev.type] = (float(loss), craft.to_jax_params(model))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=2e-2)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in tree:
                yield from leaves(tree[k], f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}.{i}")
        else:
            yield path, tree

    for (path, a), (_, b) in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        if path.endswith(".mean") or path.endswith(".var"):
            assert (np.abs(a - b) / (1 + np.abs(b))).max() <= 5e-2, path
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr + 1e-6, err_msg=path)


@pytest.mark.gpu
def test_f32_embedder_step_on_card_matches_cpu(cuda_device):
    """One f32 ``embed_step`` (TF32 off) of the re-id trainer from the rank
    classifier with one projection head on 24 views, on the card and the
    CPU, by the classifier's rule: the loss within 1e-5 relative, the
    gradients within 1e-4 of the largest."""
    from manual_yolo_tpu_torch.train import embedder as pt_emb

    windows = np.random.default_rng(0).integers(0, 255, (12, 128, 128, 3), np.uint8)
    rng = np.random.default_rng(1)
    views = np.empty((24, 64, 64, 3), np.float32)
    views[0::2], views[1::2] = pt_emb.sample_views(rng, windows), pt_emb.sample_views(rng, windows)
    params, _ = load_params(CLS)
    proj = pt_emb.init_projection(torch.Generator().manual_seed(1), 256, 128)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        spec = yolov8.build_spec("classify", "n", 13)
        model = yolov8.load_jax_params(yolov8.build_model(spec, train=True), params).to(dev).train()
        head = pt_emb.ProjectionHead(proj).to(dev)
        opt = adamw(list(model.parameters()) + list(head.parameters()), 1e-4)
        loss = pt_emb.embed_step(model, head, opt, torch.from_numpy(views).to(dev), 5e-4, 0.1, 1e-4)
        grads = torch.cat([p.grad.float().flatten().cpu() for p in
                           list(model.parameters()) + list(head.parameters())])
        out[dev.type] = (float(loss), grads)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    g, r = out["cuda"][1], out["cpu"][1]
    assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.gpu
def test_sharded_detector_on_card_is_one_launch_per_call(cuda_device, tmp_path):
    """``ShardedDetector`` over a one-rank NCCL group on the card: one NMS
    kernel launch per call, and the result of ``DetectorEngine.detect_batch``
    on the same model, frames and settings."""
    import torch.distributed as dist

    from manual_yolo_tpu_torch.parallel import mesh as mesh_lib
    from manual_yolo_tpu_torch.parallel.inference import ShardedDetector

    mesh_lib.init_process_group(0, 1, str(tmp_path / "store"), device="cuda")
    try:
        params, meta = load_params(DET_N)
        spec = yolov8.build_spec("detect", meta["spec"]["scale"], int(meta["spec"]["nc"]))
        folded = yolov8.fold_params(params, spec)
        det = ShardedDetector(folded, spec, mesh_lib.make_mesh(1), imgsz=640,
                              compute_dtype=torch.bfloat16, device=cuda_device)
        engine = DetectorEngine(det.engine.model, imgsz=640, device=cuda_device)
        frames = np.stack([png.imread_bgr(IMAGE)] * 3)
        before = nms_keep.launches
        got = det(frames)
        assert nms_keep.launches == before + 1
        ref = engine.detect_batch(frames)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(got.count.min()) > 0
    finally:
        dist.destroy_process_group()
