"""The serving slice's host side against the JAX package, on the CPU: the
host library's frame ring, JSONL appender and pixel loops (against the JAX
package's native module and their plain twins), the odd-integer decimation
against cv2's INTER_LINEAR, FieldOCRMemo against the JAX package's over a
frame stream with a deterministic fake recognizer, and cli.serve end to end
with ``--device cpu`` against the JAX package's CLI."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import cv2  # noqa: E402

from manual_yolo_tpu.runtime import fieldocr as jax_fieldocr  # noqa: E402
from manual_yolo_tpu.runtime import native as jax_native  # noqa: E402
from manual_yolo_tpu_torch.runtime import fieldocr as pt_fieldocr  # noqa: E402
from manual_yolo_tpu_torch.runtime import native  # noqa: E402
from torch_loop_cases import CLS, DET_N  # noqa: E402


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


def test_frame_ring_matches_jax_and_plain_twin():
    """The same pushes and pops, FIFO and latest-only, through a ring that
    overflows: the same frames, counts and drops."""
    shape = (6, 8, 3)
    rings = [native.FrameRing(3, shape), jax_native.FrameRing(3, shape),
             native.PlainFrameRing(3, shape)]
    frame = lambda i: np.full(shape, i, np.uint8)  # noqa: E731
    script = ["push"] * 5 + ["fifo", "latest", "latest"] + ["push"] * 2 + ["fifo", "fifo", "fifo"]
    seen = []
    for ring in rings:
        out, i = [], 0
        for op in script:
            if op == "push":
                ring.push(frame(i))
                i += 1
            else:
                got = ring.pop(latest=op == "latest")
                out.append(None if got is None else int(got[0, 0, 0]))
            out.append((ring.available, ring.dropped))
        seen.append(out)
    native_ring = rings[0]
    with pytest.raises(ValueError):
        native_ring.push(np.zeros((2, 2, 3), np.uint8))
    for ring in rings[:2]:
        ring.close()
    assert seen[0] == seen[1]
    # the deque twin drops the overwritten frames and the skipped ones alike
    assert [v for v in seen[0] if not isinstance(v, tuple)] == \
        [v for v in seen[2] if not isinstance(v, tuple)]


def test_json_log_matches_jax_and_plain_twin(tmp_path):
    lines = ['{"tick":0,"detections":3}', "x" * 10000, json.dumps({"t": "é"})]
    texts = []
    for name, cls in (("port", native.JsonLog), ("jax", jax_native.JsonLog),
                      ("plain", native.PlainJsonLog)):
        path = str(tmp_path / name / "log.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        log = cls(path)
        written = [log.append(line) for line in lines]
        assert log.lines == len(lines)
        log.close()
        assert written == [len(line.encode()) + 1 for line in lines]
        with open(path, "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] == texts[2]


def test_bgra_to_bgr_and_crop_match_jax_and_plain_twins():
    rng = np.random.default_rng(0)
    bgra = rng.integers(0, 256, (37, 53, 4), np.uint8)
    got = native.bgra_to_bgr(bgra)
    np.testing.assert_array_equal(got, jax_native.bgra_to_bgr(bgra))
    np.testing.assert_array_equal(got, native.bgra_to_bgr_plain(bgra))
    img = rng.integers(0, 256, (120, 90, 3), np.uint8)
    for rect in [(10, 5, 40, 60), (-7, -3, 20, 200), (100, 80, 300, 300), (50, 50, 50, 60),
                 (60, 10, 20, 30), (0, 0, 120, 90)]:
        got = native.crop_u8(img, *rect)
        np.testing.assert_array_equal(got, jax_native.crop_u8(img, *rect))
        np.testing.assert_array_equal(got, native.crop_u8_plain(img, *rect))
        assert got.flags.c_contiguous
    with pytest.raises(ValueError):
        native.crop_u8(img[..., 0], 0, 0, 4, 4)


@pytest.mark.parametrize("s,hw", [(3, (1200, 1920)), (3, (600, 960)), (5, (250, 400))])
def test_decimate_matches_cv2_jax_and_plain_twin(s, hw):
    frame = np.random.default_rng(s).integers(0, 256, hw + (3,), np.uint8)
    oh, ow = hw[0] // s, hw[1] // s
    got, ref = np.zeros((oh, ow, 3), np.uint8), np.zeros((oh, ow, 3), np.uint8)
    assert native.decimate_u8_into(frame, got, s)
    assert jax_native.decimate_u8_into(frame, ref, s)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, native.decimate_u8_plain(frame, s))
    np.testing.assert_array_equal(got, cv2.resize(frame, (ow, oh), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("hw,out", [((50, 40, 3), (80, 64)), ((37, 90, 3), (64, 156)),
                                    ((1200, 1920, 3), (427, 640)), ((300, 500), (200, 333)),
                                    ((1, 1, 3), (64, 64)), ((900, 1600, 3), (1200, 1920))])
def test_resize_u8_matches_cv2_and_plain_twin(hw, out):
    """The host library's uint8 linear resize (the serving path's crop and
    letterbox resize) against cv2 and ops/image.py::cv_resize_u8, byte for
    byte, down and up, gray and BGR."""
    from manual_yolo_tpu_torch.ops.image import cv_resize_u8

    img = np.random.default_rng(len(hw) + out[0]).integers(0, 256, hw, np.uint8)
    got = native.resize_u8(img, out)
    np.testing.assert_array_equal(got, cv_resize_u8(img, out))
    np.testing.assert_array_equal(got, cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(ValueError):
        native.resize_u8(img.astype(np.int16), out)


def test_decimate_declines_what_it_cannot_take():
    frame = np.zeros((120, 180, 3), np.uint8)
    dst = np.zeros((30, 45, 3), np.uint8)
    assert not native.decimate_u8_into(frame, dst, 4)  # even factor
    assert not native.decimate_u8_into(frame, np.zeros((40, 61, 3), np.uint8), 3)  # not 3:1
    assert not native.decimate_u8_into(frame[:, ::2], np.zeros((40, 30, 3), np.uint8), 3)
    assert not dst.any()


def test_arrays_equal_matches_jax():
    a = np.random.default_rng(1).integers(0, 256, (50, 40, 3), np.uint8)
    b = a.copy()
    c = a.copy()
    c[49, 39, 2] ^= 1
    for x, y in [(a, a), (a, b), (a, c), (a, a[:, :20]), (a, a.astype(np.int16)),
                 (a[:, ::2], b[:, ::2]), (a[:, ::2], c[:, ::2])]:
        assert native.arrays_equal(x, y) == jax_native.arrays_equal(x, y) == \
            (x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y))


class FakeEngine:
    """A recognizer with no model: the text is a digest of the crop's pixels,
    so the same pixels read the same and any repaint reads anew."""

    def __init__(self):
        self.calls = []

    def read_fields(self, crops, names, min_confidence=0.35):
        self.calls.append(len(crops))
        return [None if int(c.sum()) % 7 == 0 else f"{n[:4]}{int(c.sum()) % 997}"
                for c, n in zip(crops, names)]


def _field_stream():
    """(frames, results) per batch for 2 lanes: static fields, a photometric
    shift, a repaint, a lane that copies the other's pixels, an empty crop."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (200, 300, 3), np.uint8)
    dets = [
        {"class_id": 49, "class_name": "villian1_name", "bbox": [10, 10, 80, 30]},
        {"class_id": 42, "class_name": "total_pot", "bbox": [100, 50, 180, 70]},
        {"class_id": 34, "class_name": "my_stack", "bbox": [150, 150, 260, 175]},
        {"class_id": 6, "class_name": "card1_rank", "bbox": [40, 100, 60, 130]},
        {"class_id": 31, "class_name": "game_id", "bbox": [400, 400, 420, 420]},
    ]
    shifted = np.clip(base.astype(np.int16) + 4, 0, 255).astype(np.uint8)
    repaint = base.copy()
    repaint[52:68, 110:170] = rng.integers(0, 256, (16, 60, 3), np.uint8)
    batches = [[base, base], [base, shifted], [repaint, shifted], [repaint, repaint],
               [base, None], [shifted, base]]
    return [(frames, [[dict(d, ocr_text="") for d in dets] for _ in frames])
            for frames in batches]


@pytest.mark.parametrize("async_reads", [False, True])
def test_field_ocr_memo_matches_jax(async_reads):
    outs = []
    for module in (pt_fieldocr, jax_fieldocr):
        engine = FakeEngine()
        memo = module.FieldOCRMemo(engine, async_reads=async_reads)
        texts = []
        try:
            for frames, results in _field_stream():
                memo.process(frames, results)
                memo.flush()
                texts.append([[d["ocr_text"] for d in dets] for dets in results])
        finally:
            memo.close()
        outs.append((texts, memo.stats(), engine.calls))
    assert outs[0] == outs[1]
    stats = outs[0][1]
    assert stats["fields_read"] > 0 and stats["fields_memo"] > 0 and stats["fields_dedup"] > 0


def test_is_text_field_and_same_content_match_jax():
    from manual_yolo_tpu_torch.game import taxonomy

    for name in taxonomy.CLASS_NAMES:
        assert pt_fieldocr.is_text_field(name) == jax_fieldocr.is_text_field(name)
    rng = np.random.default_rng(2)
    crop = rng.integers(20, 230, (12, 30, 3), np.uint8)
    cached = crop.astype(np.int16)
    for other in [crop, crop + 5, np.clip(crop.astype(np.int16) + 30, 0, 255).astype(np.uint8),
                  rng.integers(0, 256, (12, 30, 3), np.uint8), crop[:, :20]]:
        assert pt_fieldocr.same_content(cached, other) == jax_fieldocr.same_content(cached, other)


SERVE_ARGS = ["--tables", "2", "--ticks", "8", "--imgsz", "192", "--width", "480",
              "--height", "300", "--detector", DET_N, "--classifier", CLS,
              "--save-every", "4", "--warmup-ticks", "2"]


def _serve_outputs(out: str):
    tables = {}
    for ti in range(2):
        with open(os.path.join(out, f"table_{ti:02d}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        games = {}
        for name in sorted(os.listdir(os.path.join(out, f"table_{ti:02d}"))):
            with open(os.path.join(out, f"table_{ti:02d}", name)) as f:
                games[name] = json.load(f)
        tables[ti] = (rows, games)
    return tables


def test_serve_cli_fleet_end_to_end(tmp_path, capsys):
    """cli.serve --device cpu: per-table JSONL rows and game files, and a
    summary line, as the JAX package's CLI writes them for the same fleet."""
    from manual_yolo_tpu.cli import serve as jax_serve
    from manual_yolo_tpu_torch.cli import serve as pt_serve

    out = str(tmp_path / "port")
    assert pt_serve.main(SERVE_ARGS + ["--out", out, "--device", "cpu", "--dtype", "float32"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    got = _serve_outputs(out)
    for rows, games in got.values():
        assert len(rows) == 8 and all("detections" in r for r in rows)
        assert games, "game-state files must be persisted"
        assert {"hero", "board", "villains", "game_state"} <= set(games[sorted(games)[-1]])
    assert summary["tables"] == 2 and summary["ticks"] == 8 and summary["frames"] == 16

    ref_out = str(tmp_path / "jax")
    assert jax_serve.main(SERVE_ARGS + ["--out", ref_out]) == 0
    ref_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["modes"], summary["memo_hits"]) == (ref_summary["modes"], ref_summary["memo_hits"])
    ref = _serve_outputs(ref_out)
    for ti in got:
        assert [r["detections"] for r in got[ti][0]] == [r["detections"] for r in ref[ti][0]]
        assert sorted(got[ti][1]) == sorted(ref[ti][1])


def test_serve_cli_rejects_a_pt_classifier(tmp_path):
    from manual_yolo_tpu_torch.cli import serve as pt_serve

    with pytest.raises(ValueError, match="npz"):
        pt_serve.main(["--tables", "1", "--ticks", "1", "--device", "cpu",
                       "--classifier", "weights/rank_classifier.pt", "--out", str(tmp_path)])


def test_table_sim_sources_match_jax():
    """The same frames, and the same array object where a frame is unchanged."""
    from manual_yolo_tpu.cli import serve as jax_serve
    from manual_yolo_tpu_torch.cli import serve as pt_serve

    got = pt_serve.build_sources("table-sim", 2, (60, 80))
    ref = jax_serve.build_sources("table-sim", 2, (60, 80))
    for a, b in zip(got, ref):
        prev_a = prev_b = None
        for _ in range(40):
            fa, fb = next(a), next(b)
            np.testing.assert_array_equal(fa, fb)
            assert (fa is prev_a) == (fb is prev_b)
            prev_a, prev_b = fa, fb
