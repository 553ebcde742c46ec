"""The ported slice as a whole against the JAX package: the fused frame
pipeline and the single-screenshot runtime, at full width with the committed
weights, in f32 on the CPU; plus the port's PNG reader, device rule, CLI
and its copies of the host-only modules."""

import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu import config as jax_config  # noqa: E402
from manual_yolo_tpu.game import schema as jax_schema  # noqa: E402
from manual_yolo_tpu.game import taxonomy as jax_tax  # noqa: E402
from manual_yolo_tpu.game import text as jax_text  # noqa: E402
from manual_yolo_tpu.runtime import pipeline as jax_pipe  # noqa: E402
from manual_yolo_tpu.runtime import shot as jax_shot  # noqa: E402
from manual_yolo_tpu_torch import config as pt_config  # noqa: E402
from manual_yolo_tpu_torch.game import accumulate as pt_acc  # noqa: E402
from manual_yolo_tpu_torch.game import schema as pt_schema  # noqa: E402
from manual_yolo_tpu_torch.game import taxonomy as pt_tax  # noqa: E402
from manual_yolo_tpu_torch.game import text as pt_text  # noqa: E402
from manual_yolo_tpu_torch.runtime import pipeline as pt_pipe  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import read_png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' pipelines: full width (YOLOv8s 640, yolov8n-cls), f32, conf 0.5."""
    kw = dict(imgsz=640, conf=0.5, iou=0.7, compute_dtype="float32")
    return (pt_shot.load_fused_pipeline(DET, CLS, device="cpu", **kw),
            jax_shot.load_fused_pipeline(DET, CLS, **kw))


def _frames():
    return {
        "poker_labeled": pt_shot.imread_bgr(IMAGE),
        "seeded_1200x1920": np.random.default_rng(0).integers(
            0, 256, (1200, 1920, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("name", ["poker_labeled", "seeded_1200x1920"])
def test_process_frame_matches_jax(pipelines, name):
    """Same classes in the same order, scores within 1e-3, boxes within
    1 px, the same rank text."""
    pt, jx = pipelines
    frame = _frames()[name]
    got, ref = pt.process_frame(frame), jx.process_frame(frame)
    assert [d["class_name"] for d in got] == [d["class_name"] for d in ref]
    for g, r in zip(got, ref):
        assert abs(g["conf"] - r["conf"]) <= 1e-3, (g, r)
        assert np.abs(np.subtract(g["bbox"], r["bbox"])).max() <= 1, (g, r)
        assert g["ocr_text"] == r["ocr_text"], (g, r)
    if name == "poker_labeled":
        assert len(got) >= 10 and sum(bool(d["ocr_text"]) for d in got) >= 2


def test_frame_result_matches_jax(pipelines):
    """The raw FrameResult tensors: classes and rank slots equal, scores and
    boxes within 1e-3, rank probabilities within 1e-4."""
    pt, jx = pipelines
    frame = _frames()["poker_labeled"]
    got = pt(frame)
    ref = jax.device_get(jx(frame))
    np.testing.assert_array_equal(got.classes.numpy(), ref.classes)
    np.testing.assert_array_equal(got.rank_det_idx.numpy(), ref.rank_det_idx)
    assert int(got.count) == int(ref.count)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.rank_probs.numpy(), ref.rank_probs, rtol=0, atol=1e-4)


def test_process_screenshot_json_matches_jax(pipelines, tmp_path):
    """The same poker_result.json but for its time field. The port reads the
    PNG with its own decoder; the JAX side with cv2."""
    pt, jx = pipelines
    out_pt, out_jx = tmp_path / "pt.json", tmp_path / "jx.json"
    res_pt = pt_shot.process_screenshot(pt, IMAGE, str(out_pt))
    res_jx = jax_shot.process_screenshot(jx, IMAGE, str(out_jx), output_image=None,
                                         use_llm_fallback=False)
    on_disk = json.loads(out_pt.read_text())
    assert on_disk == res_pt
    for r in (res_pt, res_jx, on_disk):
        r.pop("time")
    assert res_pt == res_jx
    assert res_pt["card1"] and res_pt["community_cards"]


def test_crop_resize_center_matches_jax():
    """Batched crops vs the JAX per-box crop (vmapped), within 1e-3 on 0..255."""
    rng = np.random.default_rng(12)
    frame = rng.integers(0, 256, (300, 500, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(-10, 400, (8, 2)), rng.uniform(1, 120, (8, 2))], -1)
    boxes[:, 2:] += boxes[:, :2]
    boxes = boxes.astype(np.float32)
    boxes[0] = 0.0  # an empty slot, as the pipeline pads
    got = pt_pipe.crop_resize_center(torch.from_numpy(frame), torch.from_numpy(boxes), 64, 6.0)
    ref = jax.vmap(lambda b: jax_pipe.crop_resize_center(jnp.asarray(frame), b, 64, 6.0))(
        jnp.asarray(boxes))
    assert got.shape == (8, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_accumulate_merges_like_jax(pipelines, tmp_path):
    pt, jx = pipelines
    seed = {"game_id": "G1", "card1": "", "my_stack": "100"}
    for p in ("pt.json", "jx.json"):
        (tmp_path / p).write_text(json.dumps(seed))
    res_pt = pt_shot.process_screenshot(pt, IMAGE, str(tmp_path / "pt.json"), accumulate=True)
    res_jx = jax_shot.process_screenshot(jx, IMAGE, str(tmp_path / "jx.json"), output_image=None,
                                         accumulate=True, use_llm_fallback=False)
    res_pt.pop("time"), res_jx.pop("time")
    assert res_pt == res_jx and res_pt["game_id"] == "G1"


# --- entry points and the device rule -------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_shot.load_fused_pipeline(DET, CLS)
    from manual_yolo_tpu_torch.models.classifier import RankClassifier

    with pytest.raises(RuntimeError, match="cuda"):
        RankClassifier.from_npz(CLS)
    from manual_yolo_tpu_torch.cli import shot as cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--image", IMAGE])


def test_unported_options_raise(pipelines, tmp_path):
    pt, _ = pipelines
    with pytest.raises(NotImplementedError):
        pt_shot.process_screenshot(pt, IMAGE, str(tmp_path / "r.json"), output_image="x.png")
    with pytest.raises(NotImplementedError):
        pt_shot.process_screenshot(pt, IMAGE, str(tmp_path / "r.json"), use_llm_fallback=True)
    assert not (tmp_path / "r.json").exists()


def test_cli_shot_on_cpu_matches_jax(tmp_path, capsys):
    """The port's CLI at imgsz 320, f32, against JAX process_screenshot."""
    from manual_yolo_tpu_torch.cli import shot as cli

    out = tmp_path / "cli.json"
    rc = cli.main(["--image", IMAGE, "--output-json", str(out), "--device", "cpu",
                   "--imgsz", "320", "--dtype", "float32"])
    assert rc == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == got
    jx = jax_shot.load_fused_pipeline(DET, CLS, imgsz=320, conf=0.5, compute_dtype="float32")
    ref = jax_shot.process_screenshot(jx, IMAGE, str(tmp_path / "jx.json"), output_image=None,
                                      use_llm_fallback=False)
    got.pop("time"), ref.pop("time")
    assert got == ref


# --- PNG reader ------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(img: np.ndarray, filters) -> bytes:
    """A PNG writer that applies the given filter type to each row in turn."""
    h, w, ch = img.shape
    bpp, prev, out = ch, np.zeros(w * ch, np.int64), b""
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, prev, upleft)])
        out += bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    color = {3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def test_read_png_matches_cv2_on_example():
    cv2 = pytest.importorskip("cv2")
    got = read_png(IMAGE)
    assert got.shape == (900, 1600, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(pt_shot.imread_bgr(IMAGE), cv2.imread(IMAGE))


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_all_filter_types(tmp_path, channels):
    """Rows filtered None/Sub/Up/Average/Paeth decode to the pixels; RGBA
    drops alpha. Cross-checked with cv2 where it is installed."""
    img = np.random.default_rng(channels).integers(0, 256, (11, 9, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(str(path)), img[..., :3])
    try:
        import cv2
    except ImportError:
        return
    np.testing.assert_array_equal(pt_shot.imread_bgr(str(path)), cv2.imread(str(path)))


def test_read_png_rejects_unsupported(tmp_path):
    bad = tmp_path / "gray16.png"
    body = struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(body)) + b"IHDR" + body + b"\0" * 4)
    with pytest.raises(ValueError, match="8-bit"):
        read_png(str(bad))
    notpng = tmp_path / "x.png"
    notpng.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(notpng))
    with pytest.raises(FileNotFoundError):
        pt_shot.imread_bgr(str(tmp_path / "missing.png"))


# --- the host-only copies --------------------------------------------------


def test_game_copies_match_jax():
    assert pt_tax.CLASSES == jax_tax.CLASSES
    assert pt_tax.RANK_CLASSES == jax_tax.RANK_CLASSES
    assert pt_tax.OCR_CLASSES == jax_tax.OCR_CLASSES
    for s in ["", "a", "0", "T", "10", "O", "S", "1", "k ", "Q|", "7"]:
        assert pt_text.normalize_rank_text(s) == jax_text.normalize_rank_text(s)
    for n in pt_tax.CLASS_NAMES:
        assert pt_text.suit_char(n) == jax_text.suit_char(n)
    args = ({"card1_rank": "A", "flop1_rank": "2"}, {"card1_rank": "h"}, {"flop1_rank": "2s"},
            [{"button": "button_fold", "center": [1, 2]}])
    assert pt_schema.build_flat_result(*args, now=0) == jax_schema.build_flat_result(*args, now=0)
    merged, changes = pt_acc.merge_detected_values({"card1": "As"}, {"card1": "Kd", "pot": "3"})
    assert merged["card1"] == "As" and changes["other_updated"] == ["pot"]


def test_config_copy_matches_jax_and_reads_json_only(tmp_path):
    assert pt_config.AppConfig().to_dict() == jax_config.AppConfig().to_dict()
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"detector": {"imgsz": 320}, "rank": {"crop_pad": 4}}))
    assert pt_config.AppConfig.load(str(cfg)).to_dict() == \
        jax_config.AppConfig.load(str(cfg)).to_dict()
    yml = tmp_path / "c.yaml"
    yml.write_text("detector: {imgsz: 320}\n")
    with pytest.raises(ValueError, match="JSON"):
        pt_config.AppConfig.load(str(yml))
