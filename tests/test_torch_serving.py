"""The serving slice of the port against the JAX package, on the CPU in f32:
BatchStream (raw stream; skip, memo and slots; a letterbox geometry change;
a dense change; the packed readback and its overflow path) and
StreamingEngine, on the same frames, with the committed YOLOv8n detector
and rank classifier at imgsz 640, B=4 tables.

Frames: the example scaled to 1200x1920, the deployment's table frame, which
letterboxes onto the 640 canvas exactly 3:1 (the odd-integer decimation),
each table shifted by a few pixels; a 1280x1920 frame for the geometry
change (the uint8 resize path). At imgsz 192 the YOLOv8n finds no rank on
the example, so the rank path would go untested.

Tolerance, stream against stream: the same per-table class lists, box
corners within 1 px (an f32 difference of 1e-4 can cross a 1/16-px step of
the packed readback), confidences within 0.002; mode_counts, memo_hits and
readback_overflows equal, except that a dense change the JAX package sends
through its delta codec (``segs``) goes up raw in the port (asserted).

Rank texts are held exactly on the same readback: the JAX package's host
tail (its ``_finish_batch`` and rank gates, or its streaming engine's crop
stage) runs on the port's packed readback (or detections) of every tick,
and must give the port's results, texts, boxes and confidences, exactly.
Stream against stream they can differ: where a box corner lands one
1/16-px step apart, its crop rect moves a pixel, the class-wide crop-rect
hysteresis may then settle on another cached rect a few pixels away, and
on the example's cards the classifier reads another rank there (5 and 6 on
the hero's first card). On the deployment's tick (YOLOv8s, tick 0 of
cli/serve.py's table-sim fleet, ``torch_serve_cases.py``) they are held
stream against stream too, texts included, in bf16 and in f32, against the
JAX package's results kept in ``torch_serve_golden.json``."""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.runtime import serving as jax_serving  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_u8  # noqa: E402
from manual_yolo_tpu_torch.runtime import serving as pt_serving  # noqa: E402
import torch_serve_cases as serve_cases  # noqa: E402
from torch_loop_cases import CLS, DET_N, REPO, example  # noqa: E402

DET_S = f"{REPO}/weights/poker_detector.npz"

IMGSZ, B = 640, 4
SHIFTS = [(0, 0), (2, 3), (-3, 1), (4, -2)]  # (dy, dx) of the four tables


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


def tables(hw=(1200, 1920)):
    base = cv_resize_u8(example(), hw)
    return [np.ascontiguousarray(np.roll(base, s, axis=(0, 1))) for s in SHIFTS]


def jax_stream(**kw):
    return jax_serving.load_batch_stream(DET_N, CLS, batch=B, imgsz=IMGSZ,
                                         compute_dtype=jnp.float32, use_pallas_nms=False, **kw)


def port_stream(**kw):
    return pt_serving.load_batch_stream(DET_N, CLS, batch=B, imgsz=IMGSZ,
                                        compute_dtype=torch.float32, device="cpu", **kw)


def run(stream, ticks):
    """Each tick submitted and collected in turn; (results, mode_counts,
    memo_hits) after each."""
    out = []
    for frames in ticks:
        stream.submit_batch(frames)
        out.append((stream.collect_batch(), dict(stream.mode_counts), stream.memo_hits))
    return out


def capture_readbacks(ps):
    """Record the inputs of each call of the port stream's host tail: (frames,
    letterbox metas, packed readback, full plane)."""
    calls = []
    inner = ps._finish_batch

    def record(frames, metas, flat, full):
        calls.append((frames, metas, flat.copy(), full.cpu().numpy()))
        return inner(frames, metas, flat, full)

    ps._finish_batch = record
    return calls


def jax_tail(js, calls):
    """The JAX package's host tail (its worker's _finish_batch and its
    applier's rank gates) over the port's readbacks, from a fresh crop-rect
    cache and crop chain."""
    js._rect_cache, js._prev_crops, js._dev_last_cls_probs = {}, None, None
    out = []
    for frames, metas, flat, full in calls:
        results, probs, rows, pairs = js._finish_batch(frames, metas, flat, full)
        if pairs:
            probs = np.asarray(probs).reshape(rows, -1)
            for row, (bi, di) in pairs:
                js._apply_rank_prob(results, bi, di, probs[row])
        out.append(results)
    return out


def fresh(port_out):
    """The port's results of the ticks that were not memo hits."""
    memo = [0] + [m for _, _, m in port_out]
    return [r for (r, _, m), m0 in zip(port_out, memo) if m == m0]


def pair_dets(got, ref, box_tol, gate=None, margin=0.0):
    """One table's detections paired, each reference detection with the
    nearest of its class (a 1-px difference may reorder two boxes of one
    class in any sort by position), box corners within ``box_tol``. With
    ``gate``, a detection of either list whose confidence is below
    gate + margin may go unpaired (it passes the gate in one package only);
    without it the class lists must be equal."""
    left, pairs = list(got), []
    for r in ref:
        same = [d for d in left if d["class_id"] == r["class_id"]]
        g = min(same, key=lambda d: np.abs(np.subtract(d["bbox"], r["bbox"])).max()) if same else None
        if g is None or np.abs(np.subtract(g["bbox"], r["bbox"])).max() > box_tol:
            assert gate is not None and r["conf"] < gate + margin, (r, g)
            continue
        left.remove(g)
        pairs.append((g, r))
    assert all(gate is not None and d["conf"] < gate + margin for d in left), left
    return pairs


def assert_same_dets(got, ref):
    """One tick's results: per table the same class list, boxes within 1 px,
    confidences within 0.002."""
    assert len(got) == len(ref)
    for g_dets, r_dets in zip(got, ref):
        for g, r in pair_dets(g_dets, r_dets, 1):
            assert abs(g["conf"] - r["conf"]) <= 0.002, (g, r)


@pytest.fixture(scope="module")
def raw_run():
    base = tables()
    ticks = [base, [np.ascontiguousarray(np.roll(f, (1, 1), axis=(0, 1))) for f in base],
             base[::-1]]
    js, ps = jax_stream(delta=False), port_stream(delta=False)
    calls = capture_readbacks(ps)
    try:
        jax_out, port_out = run(js, ticks), run(ps, ticks)
        return jax_out, port_out, jax_tail(js, calls), (js.readback_overflows,
                                                         ps.readback_overflows)
    finally:
        js.close()
        ps.close()


def test_raw_stream_matches_jax(raw_run):
    jax_out, port_out, _, overflows = raw_run
    for (got, modes, memo), (ref, ref_modes, ref_memo) in zip(port_out, jax_out):
        assert_same_dets(got, ref)
        assert modes == ref_modes and memo == ref_memo == 0
    assert min(len(dets) for dets in port_out[0][0]) >= 20
    assert overflows == (0, 0)  # the packed path
    assert port_out[-1][1]["raw"] == 3


def test_raw_stream_texts_match_jax_on_the_same_readback(raw_run):
    _, port_out, replay, _ = raw_run
    assert [r for r, _, _ in port_out] == replay
    n_ranks = [sum(bool(d["ocr_text"]) for dets in r for d in dets) for r in replay]
    assert min(n_ranks) >= 6, n_ranks  # the rank classifier read every tick


def _repaint(frame, y, x, seed):
    out = frame.copy()
    out[y:y + 40, x:x + 60] = np.random.default_rng(seed).integers(0, 255, (40, 60, 3), np.uint8)
    return out


@pytest.fixture(scope="module")
def delta_run():
    """One delta=True stream through every mode the port keeps, then a dense
    change. The ticks, and what the JAX package does with each:
      0 first tick: raw; 1 the same arrays: skip + memo; 2 copies of the same
      bytes: skip + memo; 3 one table repainted: slots; 4 table 0 at another
      letterbox geometry: raw; 5 back to one geometry: raw; 6 every table
      shifted +3 in brightness: segs (a dense change); 7 copies of tick 6:
      skip + memo."""
    base = tables()
    tall = cv_resize_u8(example(), (1280, 1920))
    bright = [np.clip(f.astype(np.int16) + 3, 0, 255).astype(np.uint8) for f in base]
    rep = [_repaint(base[0], 300, 500, 1)] + base[1:]
    ticks = [base, base, [f.copy() for f in base], rep, [tall] + rep[1:], base,
             bright, [f.copy() for f in bright]]
    js, ps = jax_stream(delta=True), port_stream(delta=True)
    calls = capture_readbacks(ps)
    try:
        jax_out, port_out = run(js, ticks), run(ps, ticks)
        return jax_out, port_out, jax_tail(js, calls)
    finally:
        js.close()
        ps.close()


MODES = ["raw", "skip", "skip", "slots", "raw", "raw", "segs", "skip"]


def test_delta_stream_skip_memo_slots_geometry_match_jax(delta_run):
    jax_out, port_out, _ = delta_run
    prev = None
    for t, ((got, modes, memo), (ref, ref_modes, ref_memo)) in enumerate(zip(port_out[:6],
                                                                             jax_out[:6])):
        assert_same_dets(got, ref)
        assert modes == ref_modes, (t, modes, ref_modes)
        assert memo == ref_memo, (t, memo, ref_memo)
        grew = [k for k in modes if modes[k] != (prev or {}).get(k, 0)]
        assert grew == [MODES[t]], (t, modes)
        prev = modes
    assert port_out[5][2] == 2  # ticks 1 and 2 reused the results


def test_delta_stream_dense_change_goes_up_raw(delta_run):
    """The JAX package codes tick 6 as segs; the port sends it raw (its
    content rows). The results agree; the counts differ by exactly that."""
    jax_out, port_out, _ = delta_run
    for (got, _, memo), (ref, _, ref_memo) in zip(port_out[6:], jax_out[6:]):
        assert_same_dets(got, ref)
        assert memo == ref_memo
    modes, ref_modes = port_out[-1][1], jax_out[-1][1]
    assert ref_modes["segs"] == 1 and modes["segs"] == 0
    assert modes["raw"] == ref_modes["raw"] + ref_modes["segs"]
    assert {k: v for k, v in modes.items() if k not in ("raw", "segs")} == \
        {k: v for k, v in ref_modes.items() if k not in ("raw", "segs")}
    assert port_out[-1][2] == jax_out[-1][2] == 3


def test_delta_stream_texts_match_jax_on_the_same_readback(delta_run):
    _, port_out, replay = delta_run
    assert fresh(port_out) == replay
    assert len(replay) == 5  # ticks 1, 2 and 7 were memo hits


def test_readback_overflow_path_matches_jax():
    """max_det 8: with readback_det 4 every tick reads the full f16 plane
    (both packages count it), with readback_det 8 the packed path; all three
    give the same detections."""
    frames = tables()
    js = jax_stream(delta=False, max_det=8, readback_det=4)
    lo, hi = port_stream(delta=False, max_det=8, readback_det=4), \
        port_stream(delta=False, max_det=8, readback_det=8)
    calls = capture_readbacks(lo)
    try:
        ref = run(js, [frames])[0][0]
        got_lo, got_hi = run(lo, [frames])[0][0], run(hi, [frames])[0][0]
        overflows = js.readback_overflows
        replay = jax_tail(js, calls)[0]  # the JAX package's overflow path on the port's plane
    finally:
        for s in (js, lo, hi):
            s.close()
    assert lo.readback_overflows == overflows == 1
    assert hi.readback_overflows == 0
    assert all(len(d) == 8 for d in ref)
    assert_same_dets(got_lo, ref)
    assert_same_dets(got_hi, ref)
    assert got_lo == replay


def test_bf16_stream_matches_jax_bf16():
    """The deployment's detector, YOLOv8s in bf16, on one 4-table tick at the
    golden test's conf 0.5, against the JAX package's bf16 stream, under the
    golden tolerance: boxes within 5 px, the same class lists but for boxes
    with a confidence under 0.55 (the two frameworks' bf16 roundings can put
    them on either side of the gate), and the same rank texts, held on the
    same readback as above: a box a pixel apart is another crop, and on this
    frame the classifier reads the flop3 card as 5 from the port's box and 8
    from the JAX package's, a pixel over."""
    frames = tables()
    kw = dict(batch=B, imgsz=IMGSZ, conf=0.5, delta=False)
    js = jax_serving.load_batch_stream(DET_S, CLS, compute_dtype=jnp.bfloat16,
                                       use_pallas_nms=False, **kw)
    ps = pt_serving.load_batch_stream(DET_S, CLS, compute_dtype=torch.bfloat16, device="cpu", **kw)
    calls = capture_readbacks(ps)
    try:
        ref, got = run(js, [frames])[0][0], run(ps, [frames])[0][0]
        replay = jax_tail(js, calls)[0]
    finally:
        js.close()
        ps.close()
    n_pairs = sum(len(pair_dets(g, r, 5, gate=0.5, margin=0.05)) for g, r in zip(got, ref))
    assert n_pairs >= 40
    assert got == replay
    assert sum(d["ocr_text"] != "" for d in got[0]) >= 3


@pytest.fixture(scope="module")
def tick0_golden():
    with open(serve_cases.GOLDEN) as f:
        return json.load(f)


def test_tick0_golden_is_the_jax_package_s(tick0_golden):
    """tests/torch_serve_golden.json, which chip_smoke.py holds the card's
    bf16 serving tick against, is what the JAX package gives on that tick
    today, in bf16 and in f32."""
    assert tick0_golden["margin"] == serve_cases.MARGIN
    for dtype in ("bfloat16", "float32"):
        assert serve_cases.jax_tick(dtype) == tick0_golden[dtype], dtype


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tick0_matches_the_jax_package_s_golden(tick0_golden, dtype):
    """The deployment's tick (YOLOv8s, 4 table-sim tables at 1200x1920,
    conf 0.5), stream against stream with the JAX package in the same dtype:
    in bf16 the golden tolerance (boxes within 5 px, confidences within the
    margin, the same class lists but for detections within the margin of
    the gate), in f32 the stream tolerance above; every rank text equal."""
    got, ref = serve_cases.port_tick(dtype), tick0_golden[dtype]
    box_tol, conf_tol, gate = (5, serve_cases.MARGIN, serve_cases.CONF) if dtype == "bfloat16" \
        else (1, 0.002, None)
    n_ranks = 0
    for g_dets, r_dets in zip(got, ref):
        for g, r in pair_dets(g_dets, r_dets, box_tol, gate=gate, margin=serve_cases.MARGIN):
            assert abs(g["conf"] - r["conf"]) <= conf_tol, (g, r)
            assert g["ocr_text"] == r["ocr_text"], (g, r)
            n_ranks += bool(r["ocr_text"])
    assert len(got) == len(ref) == serve_cases.TABLES and n_ranks >= 3 * serve_cases.TABLES


def test_letterbox_into_matches_jax_and_clears_padding():
    """The staging letterbox, both paths (3:1 decimation, uint8 resize), byte
    for byte against the JAX package's; a slot whose geometry changes gets
    its padding refilled."""
    js = types.SimpleNamespace(imgsz=128, _slot_geom={})
    ps = types.SimpleNamespace(imgsz=128, _slot_geom={})
    rng = np.random.default_rng(0)
    frames = [np.full((64, 256, 3), 250, np.uint8), np.full((256, 64, 3), 250, np.uint8),
              rng.integers(0, 256, (240, 384, 3), np.uint8),   # 3:1
              rng.integers(0, 256, (300, 500, 3), np.uint8)]
    dj, dp = np.full((128, 128, 3), 114, np.uint8), np.full((128, 128, 3), 114, np.uint8)
    for f in frames:
        mj = jax_serving.BatchStream._letterbox_into(js, dj, f, key=(0, 0))
        mp = pt_serving.BatchStream._letterbox_into(ps, dp, f, key=(0, 0))
        assert mp == mj
        np.testing.assert_array_equal(dp, dj)
        if f.shape[:2] == (256, 64):
            # (64, 10) held the wide frame and is the tall frame's padding now
            assert dp[64, 10, 0] == 114 and dp[64, 64, 0] == 250


def test_stable_rect_hysteresis():
    """Rects within the pad tolerance of a cached one reuse it; others, or
    other classes, get their own entry; at most 8 per class."""
    stub = types.SimpleNamespace(_rect_cache={}, crop_pad=6)
    sr = pt_serving.BatchStream._stable_rect
    base = (100, 200, 160, 260)
    assert sr(stub, 5, base) == base
    assert sr(stub, 5, (104, 196, 166, 258)) == base
    assert sr(stub, 5, (94, 206, 154, 266)) == base
    far = (100, 200, 160, 267)
    assert sr(stub, 5, far) == far
    assert sr(stub, 5, (99, 201, 161, 259)) == base
    other = (101, 201, 161, 261)
    assert sr(stub, 9, other) == other
    for k in range(20):
        sr(stub, 5, (1000 * k, 0, 1000 * k + 50, 50))
    assert len(stub._rect_cache[5]) <= 8


def _small_stream(**kw):
    return pt_serving.load_batch_stream(DET_N, CLS, batch=2, imgsz=IMGSZ,
                                        compute_dtype=torch.float32, device="cpu", **kw)


def test_recovers_after_dispatch_failure():
    """A batch that fails in the dispatcher raises in collect_batch; the next
    tick goes up raw and gives a fresh stream's results."""
    s, ref = _small_stream(), _small_stream()
    frames1 = tables()[:2]
    frames2 = [np.clip(f.astype(np.int16) + 3, 0, 255).astype(np.uint8) for f in frames1]
    try:
        s.submit_batch(frames1)
        s.collect_batch()

        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")

        s._detect_core = boom
        s.submit_batch(frames2)
        with pytest.raises(RuntimeError, match="injected"):
            s.collect_batch()
        del s._detect_core
        assert s._delta_broken
        raw_before = s.mode_counts["raw"]
        s.submit_batch(frames2)
        got = s.collect_batch()
        assert s.mode_counts["raw"] == raw_before + 1
        want = run(ref, [frames1, frames2])[-1][0]
        assert got == want
    finally:
        s.close()
        ref.close()


def test_close_with_batch_in_flight_does_not_hang():
    s = _small_stream()
    s.submit_batch(tables()[:2])  # not collected
    s.close()
    s.close()  # idempotent
    assert not s._dispatch_thread.is_alive() and not s._finish_thread.is_alive()
    with pytest.raises(RuntimeError):
        s.submit_batch(tables()[:2])


def test_memo_results_are_copies():
    """A memo tick returns the last results, and mutating what was collected
    does not leak into the next memo tick."""
    with _small_stream() as s:
        frames = tables()[:2]
        first = run(s, [frames])[0][0]
        second = run(s, [[f.copy() for f in frames]])[0][0]
        assert s.memo_hits == 1 and second == first
        second[0][0]["ocr_text"] = "MUTATED"
        third = run(s, [frames])[0][0]
        assert s.memo_hits == 2 and third == first


def capture_detections(pe):
    """Record what the port engine's detect queue hands its crop stage:
    (frame, letterbox ratio, (top, left), detections on the host)."""
    calls = []
    inner = pe._advance_q1

    def record():
        frame, r, pad, det = pe._q1[0]
        calls.append((frame, r, pad, type(det)(*(t.cpu().numpy() for t in det))))
        inner()

    pe._advance_q1 = record
    return calls


@pytest.fixture(scope="module")
def streaming_run():
    """Both packages' StreamingEngine over the same frames, polled then
    drained; and the JAX package's crop stage and rank gates (its
    ``_advance_q1`` and ``_finish_q2``) over the port's detections."""
    frames = tables() + [tables((1280, 1920))[1]]
    kw = dict(imgsz=IMGSZ, detect_depth=1, classify_depth=1)
    je = jax_serving.load_streaming_engine(DET_N, CLS, compute_dtype=jnp.float32,
                                           use_pallas_nms=False, **kw)
    pe = pt_serving.load_streaming_engine(DET_N, CLS, compute_dtype=torch.float32,
                                          device="cpu", **kw)
    calls = capture_detections(pe)
    outs = []
    for e in (je, pe):
        polled = [e.process(f) for f in frames]
        outs.append((polled, e.drain()))
    replay = []
    for call in calls:
        je._q1.append(call)
        je._advance_q1()
        replay.append(je._finish_q2())
    return outs, replay, len(frames)


def test_streaming_engine_matches_jax(streaming_run):
    """process + drain: the first poll is None until the queues are full,
    then the frames come back in order, equal to the JAX package's."""
    ((j_polled, j_rest), (p_polled, p_rest)), _, n = streaming_run
    assert [r is None for r in p_polled] == [r is None for r in j_polled] == \
        [True, True] + [False] * (n - 2)
    got = [r for r in p_polled if r is not None] + p_rest
    ref = [r for r in j_polled if r is not None] + j_rest
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert_same_dets([g], [r])
    assert sum(bool(d["ocr_text"]) for dets in got for d in dets) >= 6


def test_streaming_engine_texts_match_jax_on_the_same_detections(streaming_run):
    """The rank crops, their classification and the rank gates, held
    exactly: the JAX package's engine, handed the port's detections of each
    frame, gives the port's results, texts included."""
    (_, (p_polled, p_rest)), replay, n = streaming_run
    got = [r for r in p_polled if r is not None] + p_rest
    assert len(replay) == n and got == replay
    assert all(sum(bool(d["ocr_text"]) for d in dets) >= 1 for dets in got)


def test_loaders_reject_a_pt_classifier_and_need_a_card():
    with pytest.raises(ValueError, match="npz"):
        pt_serving.load_batch_stream(DET_N, "weights/rank_classifier.pt", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_serving.load_streaming_engine(DET_N, CLS)
