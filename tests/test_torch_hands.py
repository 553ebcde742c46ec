"""The hand-session slice of the port against the JAX package: DeepSORT with
and without the appearance embedder, HandSessionPipeline (full-frame detect,
the tiled batch and its merge, track votes, buttons, game-id OCR and hand
records) and the pipe CLI; in f32 on the CPU, with the committed YOLOv8n
detector at imgsz 320 and 320-px tiles (12 per frame; inputs in
tests/torch_loop_cases.py).

Both packages' hand sessions read the same fake clock (their module's
``time`` is replaced), so hand records compare by content."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import cv2  # noqa: E402

from manual_yolo_tpu.game import taxonomy as jax_tax  # noqa: E402
from manual_yolo_tpu.runtime import embedder as jax_emb  # noqa: E402
from manual_yolo_tpu.runtime import hands as jax_hands  # noqa: E402
from manual_yolo_tpu.track import deepsort as jax_ds  # noqa: E402
from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.runtime import embedder as pt_emb  # noqa: E402
from manual_yolo_tpu_torch.runtime import hands as pt_hands  # noqa: E402
from manual_yolo_tpu_torch.track import deepsort as pt_ds  # noqa: E402
from torch_loop_cases import (  # noqa: E402
    DET_N, IMGSZ, REID, TILE, FakeClock, StubOCR, assert_close, jax_engine,
    port_engine, shifted, tiled_example,
)

# the detector finds no game id on the example; the hand session's game-id
# OCR runs on the boxes of a class it does find, named game_id on both sides
AS_GAME_ID = "position_SB"


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
def embedders():
    return (pt_emb.AppearanceEmbedder.from_npz(REID, device="cpu"),
            jax_emb.AppearanceEmbedder.from_npz(REID))


def _deepsort_steps(seed=7, steps=10):
    """Seeded boxes on the tiled frame that drift at different speeds and
    sometimes vanish for a step, with the frame each step sees."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(20, 500, (8, 2))
    size = rng.uniform(30, 110, (8, 2))
    frames = shifted(tiled_example())
    out = []
    for t in range(steps):
        dets = []
        for i in range(8):
            if (i + t) % 4 == 0 and i % 3 == 1:
                continue
            xy = base[i] + t * (i - 3) * 2.0 + rng.normal(0, 1.0, 2)
            box = [float(xy[0]), float(xy[1]), float(xy[0] + size[i, 0]), float(xy[1] + size[i, 1])]
            dets.append((box, float(rng.uniform(0.4, 1.0)), f"class{i % 3}"))
        out.append((dets, frames[t % len(frames)]))
    return out


@pytest.mark.parametrize("with_embedder", [False, True])
def test_deepsort_matches_jax(embedders, with_embedder):
    """The same confirmed tracks at every step: ids, classes, boxes within
    1e-4, and (with the embedder) the features in each track's gallery."""
    pt = pt_ds.DeepSortTracker(embedder=embedders[0] if with_embedder else None)
    jx = jax_ds.DeepSortTracker(embedder=embedders[1] if with_embedder else None)
    ids = set()
    for dets, frame in _deepsort_steps():
        got, ref = pt.update_tracks(dets, frame=frame), jx.update_tracks(dets, frame=frame)
        assert [(t.track_id, t.det_class) for t in got] == [(t.track_id, t.det_class) for t in ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.to_ltrb(), r.to_ltrb(), rtol=0, atol=1e-4)
            assert len(g.features) == len(r.features) == (g.hits if with_embedder else 0)
            for fg, fr in zip(g.features, r.features):
                np.testing.assert_allclose(fg, fr, rtol=0, atol=1e-4)
        ids |= {t.track_id for t in got}
    assert len(ids) >= 8


@pytest.fixture(scope="module")
def hand_engines():
    names = dict(jax_tax.CLASSES)
    names[next(k for k, v in names.items() if v == AS_GAME_ID)] = jax_tax.GAME_ID_CLASS
    return port_engine(names=names), jax_engine(names=names)


def _session(mod, ds_mod, engine, embedder, out_dir):
    ds = ds_mod.DeepSortTracker(max_age=6, n_init=1, max_cosine_distance=0.25,
                                nn_budget=100, embedder=embedder)
    return mod.HandSessionPipeline(engine=engine, output_dir=out_dir, tile=TILE,
                                   ocr=StubOCR(switch_after=2), tracker=ds)


def test_hand_session_matches_jax(hand_engines, embedders, tmp_path, monkeypatch):
    """Four steps (the tiled frame and shifted copies), the re-id embedder,
    and a game id that changes once: the same active tracks, buttons and
    input field at every step (ids and classes equal, boxes within 1 px), the
    same hand records, and one keep-mask call per detect on the port's side:
    2 on each tiled step, the second over all 12 tiles."""
    calls = []
    real = pt_nms.nms_keep

    def spy(b, v, t):
        calls.append(tuple(b.shape))
        return real(b, v, t)

    monkeypatch.setattr(pt_nms, "nms_keep", spy)
    monkeypatch.setattr(pt_hands, "time", FakeClock())
    monkeypatch.setattr(jax_hands, "time", FakeClock())
    pt = _session(pt_hands, pt_ds, hand_engines[0], embedders[0], str(tmp_path / "pt"))
    jx = _session(jax_hands, jax_ds, hand_engines[1], embedders[1], str(tmp_path / "jx"))
    diffs, tiled_steps = [], 0
    for frame in shifted(tiled_example()):
        before = len(calls)
        got, ref = pt.step(frame), jx.step(frame)
        for key in ("active", "buttons", "input", "detections"):
            assert_close(got[key], ref[key], path=key, diffs=diffs)
        assert [t["track_id"] for t in got["active"]] == [t["track_id"] for t in ref["active"]]
        tiled_steps += calls[before:] == [(1, 512, 4), (12, 512, 4)]
        assert calls[before:] in ([(1, 512, 4)], [(1, 512, 4), (12, 512, 4)])
    assert tiled_steps == 4
    assert ref["buttons"] and len(ref["active"]) >= 10
    assert pt.hand_index == jx.hand_index == 1 and pt.last_game_id == "G2"
    print(f"hand session: {len(diffs)} box corners differ by 1 px: {diffs}")

    def records(out):
        """The records less time_end: the schema stamps it from the wall clock."""
        recs = [json.load(open(os.path.join(out, f))) for f in sorted(os.listdir(out))]
        return [dict(r, time_end=None) for r in recs]

    got, ref = records(tmp_path / "pt"), records(tmp_path / "jx")
    assert len(ref) == 1 and ref[0]["buttons"] and ref[0]["time_start"]
    assert_close(got, ref)
    assert set(pt.timer.stats()) == {"detect", "track", "ocr"}


def test_hand_session_refuses_the_debug_window(hand_engines, tmp_path):
    pipe = pt_hands.HandSessionPipeline(engine=hand_engines[0], output_dir=str(tmp_path))
    with pytest.raises(NotImplementedError):
        pipe.run(iter([tiled_example()]), show=True)


def test_avg_bbox_matches_jax():
    from collections import deque

    h = deque([(1, 2, 30, 41), (2, 2, 31, 40), (4, 3, 29, 44)], maxlen=7)
    assert pt_hands.avg_bbox(h) == jax_hands.avg_bbox(h) == (2, 2, 30, 41)
    assert pt_hands.avg_bbox(deque()) == (0, 0, 0, 0)


# --- the CLI ---------------------------------------------------------------------


def _pipe_argv(tmp_path, name):
    frame = tmp_path / "frame.png"
    if not frame.exists():
        cv2.imwrite(str(frame), tiled_example())
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"ocr": {"enabled": False},
                               "detector": {"compute_dtype": "float32"}}))
    return ["--config", str(cfg), "--source", str(frame), "--detector", DET_N,
            "--imgsz", str(IMGSZ), "--tile", str(TILE), "--fps", "100",
            "--max-frames", "2", "--embedder-weights", REID,
            "--output-dir", str(tmp_path / name)]


def test_cli_pipe_on_cpu_matches_jax(tmp_path, capsys):
    """The pipe CLIs on a PNG, with the re-id embedder, OCR off and f32
    through a config file: the same per-step lines and output files."""
    from manual_yolo_tpu.cli import pipe as jax_cli
    from manual_yolo_tpu_torch.cli import pipe as pt_cli

    assert pt_cli.main(_pipe_argv(tmp_path, "pt") + ["--device", "cpu", "--stats"]) == 0
    pt_out = capsys.readouterr().out
    assert jax_cli.main(_pipe_argv(tmp_path, "jx")) == 0
    jx_out = capsys.readouterr().out
    lines = [ln for ln in jx_out.splitlines() if ln.startswith("hand#")]
    assert len(lines) == 1 and lines[0] != "hand#0 active:0 buttons:0"
    assert [ln for ln in pt_out.splitlines() if ln.startswith("hand#")] == lines
    assert '"detect"' in pt_out
    assert sorted(os.listdir(tmp_path / "pt")) == sorted(os.listdir(tmp_path / "jx"))


def test_cli_pipe_needs_cpu_or_a_card_and_raises_on_a_bad_embedder(tmp_path, monkeypatch):
    """Without --device cpu and no card it raises; an embedder file that
    fails to load raises too (the JAX CLI runs on without it); --no-embedder
    runs motion-only."""
    from manual_yolo_tpu_torch.cli import pipe as pt_cli

    argv = _pipe_argv(tmp_path, "pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        pt_cli.main(argv)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(Exception):
        pt_cli.main(argv + ["--device", "cpu", "--embedder-weights", str(bad)])
    assert pt_cli.main(argv + ["--device", "cpu", "--no-embedder",
                               "--embedder-weights", str(bad)]) == 0
