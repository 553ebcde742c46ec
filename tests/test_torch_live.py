"""The live loop's slice of the port against the JAX package: the detector
engine (single and batched, and its batched NMS), batched letterbox, tiling
and the tile merge, the uint8 resize against cv2, the appearance embedder,
ByteTrack, GameTracker, LiveLoop, PNG frame sources and the detect CLI; in
f32 on the CPU, with the committed YOLOv8n detector at imgsz 320 (inputs in
tests/torch_loop_cases.py).

Tolerance: f32 boxes, scores and embeddings within 1e-4 (or one f32 ulp,
1.2e-4 for a box corner above 1024 px); class lists and track ids equal;
integer box corners within 1 px."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.game import state as jax_state  # noqa: E402
from manual_yolo_tpu.ops import nms as jax_nms  # noqa: E402
from manual_yolo_tpu.parallel import inference as jax_inf  # noqa: E402
from manual_yolo_tpu.runtime import capture as jax_capture  # noqa: E402
from manual_yolo_tpu.runtime import embedder as jax_emb  # noqa: E402
from manual_yolo_tpu.runtime import live as jax_live  # noqa: E402
from manual_yolo_tpu.runtime import shot as jax_shot  # noqa: E402
from manual_yolo_tpu.track import bytetrack as jax_bt  # noqa: E402
from manual_yolo_tpu_torch.game import state as pt_state  # noqa: E402
from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_u8  # noqa: E402
from manual_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_batch  # noqa: E402
from manual_yolo_tpu_torch.parallel import inference as pt_inf  # noqa: E402
from manual_yolo_tpu_torch.runtime import capture as pt_capture  # noqa: E402
from manual_yolo_tpu_torch.runtime import embedder as pt_emb  # noqa: E402
from manual_yolo_tpu_torch.runtime import live as pt_live  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402
from manual_yolo_tpu_torch.track import bytetrack as pt_bt  # noqa: E402
from torch_loop_cases import (  # noqa: E402
    CLS, DET_N, F32_TOL, IMAGE, IMGSZ, REID, TILE, StubOCR, assert_close, assert_f32_close, example,
    jax_engine, nms_batch_inputs, port_engine, shifted, tiled_example,
)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache, and
    torch to 2 threads: the suite runs 6 workers on a shared CPU."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    threads = torch.get_num_threads()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def engines():
    return port_engine(), jax_engine()


def _np(det):
    return pt_nms.Detections(*(np.asarray(t) for t in det))


def _scale(frame_hw) -> float:
    """1 / the letterbox ratio of a frame at IMGSZ."""
    return max(frame_hw) / IMGSZ


def _assert_dets_close(got, ref, scale):
    got, ref = _np(got), _np(jax.device_get(ref))
    np.testing.assert_array_equal(got.count, ref.count)
    np.testing.assert_array_equal(got.classes, ref.classes)
    assert_f32_close(got.scores, ref.scores)
    assert_f32_close(got.boxes, ref.boxes, scale)


# --- the engine ------------------------------------------------------------


@pytest.mark.parametrize("name", ["example", "tiled_example"])
def test_engine_detect_matches_jax(engines, name):
    pt, jx = engines
    frame = {"example": example, "tiled_example": tiled_example}[name]()
    got, ref = pt.detect(frame), jx.detect(frame)
    assert int(got.count) >= 10
    _assert_dets_close(got, ref, _scale(frame.shape[:2]))


def test_engine_detect_batch_matches_jax(engines):
    """The 12 tiles of the tiled frame, one batch on each side."""
    pt, jx = engines
    tiles, _ = pt_inf.tiled_frames(tiled_example(), TILE, 0.2)
    assert tiles.shape == (12, TILE, TILE, 3)
    got, ref = pt.detect_batch(tiles), jx.detect_batch(tiles)
    assert got.boxes.shape == (12, 300, 4) and int(got.count.sum()) >= 10
    _assert_dets_close(got, ref, _scale(tiles.shape[1:3]))


def test_engine_batch_equals_its_own_frames(engines):
    """detect_batch over the tiles against detect on each tile alone."""
    pt, _ = engines
    tiles, _ = pt_inf.tiled_frames(tiled_example(), TILE, 0.2)
    batch = _np(pt.detect_batch(tiles))
    for i, tile in enumerate(tiles):
        one = _np(pt.detect(tile))
        assert int(one.count) == int(batch.count[i])
        np.testing.assert_array_equal(one.classes, batch.classes[i])
        assert_f32_close(one.scores, batch.scores[i])
        assert_f32_close(one.boxes, batch.boxes[i])


@pytest.mark.parametrize("name", ["example", "tiled_example"])
def test_engine_detect_to_list_matches_jax(engines, name):
    """The same classes in the same order, conf within 1e-4, corners (int()
    of f32 boxes) within 1 px; the corners that differ are counted and shown."""
    pt, jx = engines
    frame = {"example": example, "tiled_example": tiled_example}[name]()
    got, ref = pt.detect_to_list(frame), jx.detect_to_list(frame)
    assert [d["class_name"] for d in got] == [d["class_name"] for d in ref]
    diffs = []
    assert_close(got, ref, tol=F32_TOL, diffs=diffs)
    print(f"{name}: {len(diffs)} of {4 * len(ref)} corners differ by 1 px: {diffs}")


def test_engine_entry_point_needs_cpu_or_a_card(monkeypatch):
    from manual_yolo_tpu_torch.runtime.engine import DetectorEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        DetectorEngine.from_npz(DET_N, imgsz=IMGSZ)
    with pytest.raises(ValueError, match="compute_dtype"):
        DetectorEngine.from_npz(DET_N, compute_dtype="float16", device="cpu")


# --- batched NMS -----------------------------------------------------------


def test_nms_batch_matches_jax_vmap():
    boxes, scores = nms_batch_inputs()
    kw = dict(conf_thres=0.25, iou_thres=0.6, pre_nms=512, max_det=300)
    got = pt_nms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jax.vmap(lambda b, s: jax_nms.nms(b, s, **kw))(jnp.asarray(boxes), jnp.asarray(scores))
    counts = np.asarray(ref.count)
    assert counts[2] == 0 and counts[0] > 10 and counts[1] > 10
    got, ref = _np(got), _np(jax.device_get(ref))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_nms_batch_rows_equal_single_nms_with_one_keep_call(monkeypatch):
    """One keep-mask call over (B, K, 4) for the batch; each row equals the
    single-frame nms of that frame."""
    boxes, scores = (torch.from_numpy(x) for x in nms_batch_inputs())
    calls = []
    real = pt_nms.nms_keep

    def spy(b, v, t):
        calls.append(tuple(b.shape))
        return real(b, v, t)

    monkeypatch.setattr(pt_nms, "nms_keep", spy)
    batch = pt_nms.nms_batch(boxes, scores, conf_thres=0.25, iou_thres=0.6)
    assert calls == [(4, 512, 4)]
    for i in range(4):
        one = pt_nms.nms(boxes[i], scores[i], conf_thres=0.25, iou_thres=0.6)
        for g, r in zip(one, batch):
            assert torch.equal(g, r[i])


def test_letterbox_batch_equals_each_frame_upscaled():
    """A batch of 160x120 frames to 320 (the tiles' 2x upscale): bit for bit
    the single-frame letterbox of each frame, and within 1e-4 of JAX's."""
    from manual_yolo_tpu.ops.letterbox import letterbox as jax_letterbox

    frames = np.random.default_rng(2).integers(0, 256, (5, 160, 120, 3), dtype=np.uint8)
    canvas, r, pad = letterbox_batch(torch.from_numpy(frames), (320, 320))
    assert canvas.shape == (5, 320, 320, 3) and r == 2.0
    for i, f in enumerate(frames):
        one, r1, pad1 = letterbox(torch.from_numpy(f), (320, 320))
        assert (r1, pad1) == (r, pad)
        assert torch.equal(one, canvas[i])
        ref = np.asarray(jax_letterbox(jnp.asarray(f), (320, 320))[0])
        np.testing.assert_allclose(one.numpy(), ref, rtol=0, atol=F32_TOL)


# --- tiling and merge --------------------------------------------------------


@pytest.mark.parametrize("hw,tile,overlap", [((640, 960), 320, 0.2), ((1200, 1920), 640, 0.2),
                                             ((900, 1600), 640, 0.2), ((300, 500), 640, 0.2)])
def test_tiled_frames_match_jax(hw, tile, overlap):
    frame = np.random.default_rng(0).integers(0, 256, hw + (3,), dtype=np.uint8)
    got, got_off = pt_inf.tiled_frames(frame, tile, overlap)
    ref, ref_off = jax_inf.tiled_frames(frame, tile, overlap)
    assert got_off == ref_off
    np.testing.assert_array_equal(got, ref)


def test_merge_tile_detections_matches_jax():
    """Seeded per-tile detections that overlap across tiles, with empty tiles."""
    rng = np.random.default_rng(5)
    b, m = 6, 300
    offsets = [(x, y) for y in (0, 200) for x in (0, 200, 400)]
    count = np.array([0, 40, 7, 0, 60, 25], np.int32)
    boxes = np.zeros((b, m, 4), np.float32)
    scores = np.zeros((b, m), np.float32)
    classes = np.full((b, m), -1, np.int32)
    for t in range(b):
        n = count[t]
        xy = rng.uniform(150, 250, (n, 2)) - np.asarray(offsets[t]) + 200
        boxes[t, :n] = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 2))], -1)
        scores[t, :n] = np.sort(rng.uniform(0.2, 1.0, n))[::-1]
        classes[t, :n] = rng.integers(0, 3, n)
    det = (boxes, scores, classes, count)
    got = pt_inf.merge_tile_detections(pt_nms.Detections(*map(torch.from_numpy, det)),
                                       offsets, conf_thres=0.25, iou_thres=0.5)
    ref = jax_inf.merge_tile_detections(jax_nms.Detections(*map(jnp.asarray, det)),
                                        offsets, conf_thres=0.25, iou_thres=0.5)
    assert 10 < len(ref["scores"]) < int(count.sum())
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(got[k], ref[k])


# --- the uint8 resize and the embedder ----------------------------------------


@pytest.mark.parametrize("hw", [(3, 8), (8, 3), (1, 1), (21, 47), (64, 64), (128, 128),
                                (97, 301), (200, 600), (600, 200)])
def test_cv_resize_u8_matches_cv2(hw):
    """Byte for byte cv2.resize(INTER_LINEAR) on uint8, to 64x64 and to other
    sizes up and down, with 3 channels and 1."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    for out in [(64, 64), (5, 9), (hw[0] * 3, hw[1] * 2), (max(1, hw[0] // 2), hw[1] + 7)]:
        for shape in (hw + (3,), hw):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            ref = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
            np.testing.assert_array_equal(cv_resize_u8(img, out), ref)


@pytest.fixture(scope="module")
def embedders():
    return (pt_emb.AppearanceEmbedder.from_npz(REID, device="cpu"),
            jax_emb.AppearanceEmbedder.from_npz(REID))


@pytest.mark.parametrize("n", [1, 5])
def test_embedder_matches_jax(engines, embedders, n):
    """Crops of the example's detections (5 crops: bucket 8 with 3 rows of
    padding), within 1e-4, unit norm."""
    pt, jx = embedders
    frame = example()
    dets = engines[0].detect_to_list(frame)[:n]
    crops = [frame[d["y1"]:d["y2"], d["x1"]:d["x2"]] for d in dets]
    got, ref = pt(crops), np.asarray(jx(crops))
    assert got.shape == ref.shape and got.shape[0] == n and got.shape[1] >= 64
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embedder_edge_crops_match_jax(embedders):
    """An empty crop, a gray crop and no crops at all."""
    pt, jx = embedders
    gray = np.random.default_rng(1).integers(0, 256, (17, 40), dtype=np.uint8)
    crops = [np.zeros((0, 5, 3), np.uint8), gray]
    np.testing.assert_allclose(pt(crops), np.asarray(jx(crops)), rtol=0, atol=F32_TOL)
    assert pt([]).shape == np.asarray(jx([])).shape == (0, 1)


def test_default_embedder_resolution(tmp_path):
    assert pt_emb.default_embedder(str(tmp_path / "missing.npz"), device="cpu") is None
    emb = pt_emb.default_embedder(device="cpu")
    assert emb is not None and emb.device.type == "cpu"
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(Exception):
        pt_emb.default_embedder(str(bad), device="cpu")


# --- ByteTrack and GameTracker ----------------------------------------------


def _track_sequence(seed=3, steps=12):
    """Boxes that drift, with confidences above and below the activation
    gate; some vanish for a few frames and come back."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 800, (9, 2))
    size = rng.uniform(20, 90, (9, 2))
    seq = []
    for t in range(steps):
        dets = []
        for i in range(9):
            if (i + t) % 5 == 0 and i % 2:
                continue
            xy = base[i] + t * (i - 4) * 1.5 + rng.normal(0, 1.0, 2)
            dets.append({"x1": int(xy[0]), "y1": int(xy[1]),
                         "x2": int(xy[0] + size[i, 0]), "y2": int(xy[1] + size[i, 1]),
                         "conf": float(rng.choice([0.9, 0.6, 0.2, 0.12, 0.05])),
                         "class_id": int(i % 4)})
        seq.append(dets)
    return seq


def test_bytetrack_matches_jax():
    pt, jx = pt_bt.ByteTrack(), jax_bt.ByteTrack()
    ids = set()
    for dets in _track_sequence():
        got, ref = pt.update(dets), jx.update(dets)
        assert got == ref
        ids |= {d["tracker_id"] for d in got}
    assert len(ids) > 5 and [t.track_id for t in pt.tracks] == [t.track_id for t in jx.tracks]
    for a, b in zip(pt.tracks, jx.tracks):
        np.testing.assert_array_equal(a.mean, b.mean)


def test_game_tracker_matches_jax(tmp_path):
    """Hero cards, board, villains, buttons, a new hand, and the saved files."""
    frames = [
        [{"class_name": "card1_rank", "ocr_text": "A"}, {"class_name": "card2_rank", "ocr_text": "K"},
         {"class_name": "card1_suite_heart"}, {"class_name": "villian2_name", "ocr_text": "bob"},
         {"class_name": "villian2_stack", "ocr_text": "1.2k"}, {"class_name": "total_pot", "ocr_text": "300"},
         {"class_name": "button_call", "bbox": [10, 20, 30, 40], "ocr_text": "call"}],
        [{"class_name": "card1_rank", "ocr_text": "A"}, {"class_name": "flop1_rank", "ocr_text": "7"},
         {"class_name": "flop2_rank", "ocr_text": "8"}, {"class_name": "flop3_rank", "ocr_text": "9"},
         {"class_name": "flop2_suite_club"}, {"class_name": "iinput_field", "bbox": [1, 2, 3, 4]}],
        [{"class_name": "card1_rank", "ocr_text": "Q"}, {"class_name": "card2_rank", "ocr_text": "2"},
         {"class_name": "turn_rank", "ocr_text": "J"}, {"class_name": "my_stack", "ocr_text": "55"}],
    ]
    pt = pt_state.GameTracker(output_dir=str(tmp_path / "pt"))
    jx = jax_state.GameTracker(output_dir=str(tmp_path / "jx"))
    for dets in frames:
        assert pt.update(dets) == jx.update(dets)
        assert pt.game_id == jx.game_id
        pt.save(), jx.save()
    assert pt.game_id == 2
    for name in ("game_1.json", "game_2.json"):
        assert (tmp_path / "pt" / name).read_text() == (tmp_path / "jx" / name).read_text()


# --- the live loop -----------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    kw = dict(imgsz=IMGSZ, conf=0.25, iou=0.7, compute_dtype="float32")
    return (pt_shot.load_fused_pipeline(DET_N, CLS, device="cpu", **kw),
            jax_shot.load_fused_pipeline(DET_N, CLS, **kw))


def _rows(out_dir):
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "detections.jsonl"))]
    for r in rows:
        r.pop("timestamp")
    return rows


def test_live_loop_matches_jax(fused, tmp_path):
    """Four frames (the example and shifted copies) with a stub OCR that has
    read_fields: the same detections.jsonl rows less timestamps, the same
    game JSON and the same exported array, and no caught error."""
    outs = {}
    for name, pipe, mod in (("pt", fused[0], pt_live), ("jx", fused[1], jax_live)):
        out = str(tmp_path / name)
        loop = mod.LiveLoop(pipeline=pipe, output_dir=out, ocr=StubOCR(),
                            game_update_interval=0.0)
        loop.run(iter(shifted(example())), max_frames=4)
        if name == "pt":
            assert loop.errors == 0 and loop.frame_count == 4
            assert set(loop.timer.stats()) == {"infer", "ocr", "track", "persist"}
        mod.export_detections_array(out)
        outs[name] = out
    got, ref = _rows(outs["pt"]), _rows(outs["jx"])
    assert [r["frame"] for r in ref] == [0, 1, 2, 3]
    assert sum(len(r["detections"]) for r in ref) >= 40
    assert any(d["ocr_text"] == "350" for d in ref[0]["detections"])
    for g, r in zip(got, ref):
        assert [d["class_name"] for d in g["detections"]] == [d["class_name"] for d in r["detections"]]
        assert [d["tracker_id"] for d in g["detections"]] == [d["tracker_id"] for d in r["detections"]]
    assert_close(got, ref)
    games = sorted(f for f in os.listdir(outs["jx"]) if f.startswith("game_"))
    assert games and games == sorted(f for f in os.listdir(outs["pt"]) if f.startswith("game_"))
    for f in games:
        assert_close(json.load(open(os.path.join(outs["pt"], f))),
                     json.load(open(os.path.join(outs["jx"], f))))
    arrays = [json.load(open(os.path.join(outs[n], "detections.json"))) for n in ("pt", "jx")]
    for a in arrays:
        for r in a:
            r.pop("timestamp")
    assert_close(*arrays)


class _Failing:
    def __call__(self, crop, class_name):
        raise RuntimeError("no text here")


class _Canned:
    def process_frame(self, frame):
        return [{"class_id": 34, "class_name": "my_stack", "bbox": [1, 1, 9, 9],
                 "conf": 0.9, "ocr_text": ""}]


def test_live_loop_counts_caught_errors_and_refuses_cv2_options(tmp_path, monkeypatch):
    """A failing OCR is counted and the frame goes on. save_screenshots
    writes the JAX LiveLoop's .jpg files under a fixed clock: the same names
    (every other frame at an interval of 2 s, the clock moving 1.5 s a
    step) and the same bytes. show_window still raises: it needs a display."""
    from torch_loop_cases import FakeClock

    loop = pt_live.LiveLoop(pipeline=_Canned(), output_dir=str(tmp_path), ocr=_Failing())
    info = loop.step(np.zeros((20, 20, 3), np.uint8))
    loop.close()
    assert loop.errors == 1 and info["detections"][0]["ocr_text"] == ""
    frames = [np.ascontiguousarray(f[200:520, 300:781]) for f in shifted(example())]
    shots = {}
    for name, mod in (("pt", pt_live), ("jx", jax_live)):
        monkeypatch.setattr(mod, "time", FakeClock())
        out = tmp_path / f"shots_{name}"
        shot_loop = mod.LiveLoop(pipeline=_Canned(), output_dir=str(out), save_screenshots=True,
                                 screenshot_interval=2.0)
        shot_loop.run(iter(frames), max_frames=len(frames))
        shots[name] = {f: (out / f).read_bytes() for f in os.listdir(out) if f.endswith(".jpg")}
    assert len(shots["jx"]) == len(frames) // 2 and len(frames) >= 4
    assert sorted(shots["pt"]) == sorted(shots["jx"])
    for f, data in shots["pt"].items():
        assert data == shots["jx"][f], f
    with pytest.raises(NotImplementedError):
        pt_live.LiveLoop(pipeline=_Canned(), output_dir=str(tmp_path / "x"), show_window=True)


# --- frame sources -------------------------------------------------------------


def test_file_source_reads_png_directory_like_jax(tmp_path):
    rng = np.random.default_rng(8)
    for i, hw in enumerate([(30, 40), (12, 7), (50, 50)]):
        cv2.imwrite(str(tmp_path / f"f{2 - i}.png"), rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    got = list(pt_capture.file_source(str(tmp_path)))
    ref = list(jax_capture.file_source(str(tmp_path)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    single = list(pt_capture.make_source(IMAGE))
    assert len(single) == 1
    np.testing.assert_array_equal(single[0], cv2.imread(IMAGE))


@pytest.mark.parametrize("name", ["shot.jpg", "clip.mp4", "shot.bmp", "shot.tiff"])
def test_file_source_refuses_what_it_cannot_read(tmp_path, name):
    """A JPEG or BMP path, and a directory holding it beside a PNG, read as
    cv2 reads them (the JAX package's frames). A video path raises, naming
    the file and the formats that are read; so does a file of another
    format under an image name (a TIFF saved as .bmp), alone or in a
    directory (a directory's videos are not frames in either package)."""
    img = cv2.imread(IMAGE)[:60, :90]
    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.uint8))
    if name.endswith(".mp4"):
        (tmp_path / name).write_bytes(b"\x00\x00\x00\x18ftypmp42")
    elif name.endswith(".tiff"):
        name = "tiff_as.bmp"
        (tmp_path / name).write_bytes(cv2.imencode(".tiff", img)[1].tobytes())
    else:
        cv2.imwrite(str(tmp_path / name), img)
    paths = [tmp_path / name] + ([] if name.endswith(".mp4") else [tmp_path])
    for path in paths:
        if name in ("shot.jpg", "shot.bmp"):
            got = list(pt_capture.file_source(str(path)))
            ref = list(jax_capture.file_source(str(path)))
            assert len(got) == len(ref) == (1 if path.is_file() else 2)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
            continue
        with pytest.raises(ValueError, match=f"{name}.*PNG"):
            next(pt_capture.file_source(str(path)))


def test_synthetic_source_matches_jax():
    got = pt_capture.make_source("synthetic", hw=(20, 30), seed=4)
    ref = jax_capture.make_source("synthetic", hw=(20, 30), seed=4)
    for _ in range(2):
        np.testing.assert_array_equal(next(got), next(ref))
    with pytest.raises(RuntimeError, match="mss"):
        next(pt_capture.make_source("screen"))


# --- the CLI ---------------------------------------------------------------------


def test_cli_detect_on_cpu_matches_jax(tmp_path, capsys):
    """The detect CLIs over two frames of a PNG, OCR off and f32 through a
    config file: the same detections.jsonl less timestamps and game JSON."""
    from manual_yolo_tpu.cli import detect as jax_cli
    from manual_yolo_tpu_torch.cli import detect as pt_cli

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ocr": {"enabled": False},
                               "detector": {"compute_dtype": "float32"}}))
    common = ["--config", str(cfg), "--source", IMAGE, "--detector", DET_N,
              "--classifier", CLS, "--imgsz", str(IMGSZ), "--max-frames", "2"]
    assert pt_cli.main(common + ["--output-dir", str(tmp_path / "pt"), "--device", "cpu",
                                 "--stats"]) == 0
    assert jax_cli.main(common + ["--output-dir", str(tmp_path / "jx")]) == 0
    out = capsys.readouterr().out
    assert '"infer"' in out
    got, ref = _rows(tmp_path / "pt"), _rows(tmp_path / "jx")
    assert len(ref) == 1 and len(ref[0]["detections"]) >= 10  # the PNG is one frame
    assert_close(got, ref)
    assert sorted(os.listdir(tmp_path / "pt")) == sorted(os.listdir(tmp_path / "jx"))


def test_cli_detect_save_screenshots(tmp_path, capsys):
    """--save-screenshots with live.screenshot_interval 0 from the config
    writes one .jpg per frame, each decoding to the frame as cv2 does."""
    from manual_yolo_tpu_torch.cli import detect as pt_cli

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ocr": {"enabled": False}, "live": {"screenshot_interval": 0.0},
                               "detector": {"compute_dtype": "float32"}}))
    src = tmp_path / "frames"
    src.mkdir()
    frames = [np.ascontiguousarray(f[:240, :320]) for f in shifted(example())[:2]]
    for i, f in enumerate(frames):
        cv2.imwrite(str(src / f"f{i}.png"), f)
    out = tmp_path / "out"
    assert pt_cli.main(["--config", str(cfg), "--source", str(src), "--detector", DET_N,
                        "--classifier", CLS, "--imgsz", str(IMGSZ), "--device", "cpu",
                        "--save-screenshots", "--output-dir", str(out)]) == 0
    capsys.readouterr()
    jpgs = sorted((f for f in os.listdir(out) if f.endswith(".jpg")),
                  key=lambda f: int(f.split("_")[2]))
    assert [f.split("_")[2] for f in jpgs] == ["0", "1"]
    for f, frame in zip(jpgs, frames):
        assert (out / f).read_bytes() == cv2.imencode(".jpg", frame)[1].tobytes()


def test_cli_detect_needs_cpu_or_a_card(tmp_path, monkeypatch):
    from manual_yolo_tpu_torch.cli import detect as pt_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        pt_cli.main(["--source", IMAGE, "--max-frames", "1",
                     "--output-dir", str(tmp_path)])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ocr": {"enabled": False}}))
    with pytest.raises(NotImplementedError):
        pt_cli.main(["--config", str(cfg), "--source", IMAGE, "--detector", DET_N,
                     "--imgsz", str(IMGSZ), "--device", "cpu", "--show",
                     "--output-dir", str(tmp_path)])
