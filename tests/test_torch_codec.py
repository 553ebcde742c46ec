"""Serving's lossless delta codec in the port against the JAX package, on the
CPU: the encoders (``csrc/host.cpp``), their numpy twins and the JAX
package's native encoders byte for byte; the port's decoders (torch ops on
uint8 tensors) bit for bit against the JAX package's (``_segs_decoder``, and
the nibble and tribit decodes of its BatchStream) and against the encoded
plane; BatchStream with the codec on, mode for mode, against the JAX
package's and against a ``delta=False`` stream.

Tolerances: every byte exact for the encoders, the payload layout and the
decoders. Stream against stream, the same mode and crop-mode counts, fused
hits and misses after every tick; per table the same class lists, box
corners within 1 px and confidences within 0.002 (the tolerance of
tests/test_torch_serving.py: an f32 difference of 1e-4 can cross a 1/16-px
step of the packed readback); the rank texts of detections whose box is the
same equal.

The mixed stream is the example as four 1200x1920 tables, in the manner of
bench.py's jittered stream: a global jitter within [-6, 6] per channel and a
local repaint on every table, a tick of per-pixel noise within +-3, and a
letterbox geometry change followed by noise within +-7. It runs the committed
YOLOv8n detector (trained weights: a random-init detector gives near-equal
scores, which two frameworks' f32 may order differently) at imgsz 320, where
the canvas segment is 40 px as at 640, and at imgsz 192, where it is 32 px.
The lossless check of the fused predictive classify is the JAX package's own
(tests/test_serving.py): a random-init YOLOv8n and classifier, carried into
the port with ``load_jax_params``, at imgsz 192 and conf 1e-6."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.game import taxonomy as jax_taxonomy  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jax_yolov8  # noqa: E402
from manual_yolo_tpu.runtime import native as jax_native  # noqa: E402
from manual_yolo_tpu.runtime import serving as jax_serving  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as pt_yolov8  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_u8  # noqa: E402
from manual_yolo_tpu_torch.runtime import native as pt_native  # noqa: E402
from manual_yolo_tpu_torch.runtime import serving as pt_serving  # noqa: E402
from torch_loop_cases import CLS, DET_N, example  # noqa: E402


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


def clip_u8(x) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# seg_encode cases: (cur, prev, top, nh, segw), (nslots, H, W, 3) planes


def seg_const():
    """Unchanged rows (class 0 at bias 0) and a constant +2 region whose
    segments stay class 0 at bias 2 (the slot's shift probe sees 0)."""
    rng = np.random.default_rng(1)
    prev = rng.integers(0, 256, (2, 24, 80, 3), np.uint8)
    cur = prev.copy()
    cur[1, 12:20, 40:80] = prev[1, 12:20, 40:80] + np.uint8(2)  # mod 256: a delta of 2
    return cur, prev, 2, 20, 40


def seg_dense():
    """A fresh random plane: raw and sparse-byte segments."""
    rng = np.random.default_rng(2)
    prev = rng.integers(0, 256, (2, 24, 80, 3), np.uint8)
    return rng.integers(0, 256, prev.shape, np.uint8), prev, 0, 24, 40


def seg_mixed():
    """tests/test_serving.py's mixed stream: a +3 shift (const and
    clamp-shift segments), +-2 noise (2/3-bit), a repaint (raw, sparse byte)
    and 0/1 increments (1-bit)."""
    rng = np.random.default_rng(0)
    top, nh = 8, 48
    prev = rng.integers(0, 256, (4, 64, 64, 3), np.uint8)
    cur = prev.copy()
    act = slice(top, top + nh)
    cur[0, act] = clip_u8(cur[0, act].astype(np.int16) + 3)
    cur[1, act] = clip_u8(cur[1, act].astype(np.int16) + rng.integers(-2, 3, (nh, 64, 3)))
    cur[2, top + 10:top + 30, 10:40] = rng.integers(0, 256, (20, 30, 3), np.uint8)
    cur[3, act] = clip_u8(cur[3, act].astype(np.int16) + rng.integers(0, 2, (nh, 64, 3)))
    return cur, prev, top, nh, 8


def seg_whole_slot():
    """tests/test_serving.py's whole-slot clamp-shift: slot 0 is exactly
    clamp(prev + j) with a saturated band (every segment class 5, span-0 ones
    too); slot 1 is repainted."""
    rng = np.random.default_rng(7)
    prev = rng.integers(0, 256, (2, 32, 64, 3), np.uint8)
    prev[0, :4] = 255
    cur = prev.copy()
    cur[0] = clip_u8(prev[0].astype(np.int16) + np.array([3, -5, 2]))
    cur[1, 10:20, 10:30] = rng.integers(0, 256, (10, 20, 3), np.uint8)
    return cur, prev, 0, 32, 8


def seg_sparse():
    """tests/test_serving.py's sparse-exception classes at 40-px segments: a
    -3 shift with scattered deviations (class 8), a +9 shift over a clipped
    stripe (class 9 or 6/7), a dense repaint (raw) and scattered arbitrary
    bytes (class 10)."""
    rng = np.random.default_rng(13)
    W, top, nh = 80, 4, 40
    prev = rng.integers(30, 220, (2, 48, W, 3), np.uint8)
    cur = prev.copy()
    act = slice(top, top + nh)
    cur[0, top:top + 8] = clip_u8(cur[0, top:top + 8].astype(np.int16) + 5)
    cur[0, top + 8:top + 16] = clip_u8(cur[0, top + 8:top + 16].astype(np.int16) - 3)
    for r in range(8, 16):
        idx = rng.choice(W * 3, size=10, replace=False)
        flat = cur[0, top + r].reshape(-1)
        flat[idx] = clip_u8(flat[idx].astype(np.int16) + int(rng.integers(2, 8)))
    prev[1, act] = np.clip(prev[1, act], 30, 220)
    prev[1, top + 20:top + 24] = 252
    content = prev[1].astype(np.int16).copy()
    content[top + 20:top + 24] = 255 - rng.integers(0, 6, (4, W, 3))
    cur[1] = clip_u8(content + 9)
    cur[0, top + 24:top + 32] = rng.integers(0, 256, (8, W, 3), np.uint8)
    for r in range(32, 38):
        idx = rng.choice(W * 3, size=30, replace=False)
        cur[0, top + r].reshape(-1)[idx] = rng.integers(0, 256, 30).astype(np.uint8)
    return cur, prev, top, nh, 40


def seg_clip_boundary():
    """tests/test_serving.py's shift-residual case: a +20 brightening over
    antialiased highlights that clip at 255 (classes 6 and 7), and a repaint."""
    rng = np.random.default_rng(11)
    top, nh, W, j = 8, 48, 64, 20
    prev = np.zeros((2, 64, W, 3), np.uint8)
    cur = np.zeros_like(prev)
    mid = rng.integers(80, 160, (2, 24, W, 3)).astype(np.uint8)
    prev[:, top:top + 24] = mid
    cur[:, top:top + 24] = mid + j
    hi = np.where(np.arange(W) % 2 == 0, 250, 100)[None, None, :, None]
    prev[:, top + 24:top + nh] = hi.astype(np.uint8)
    e_row = np.where(np.arange(24) % 2 == 0, -2, -5)[None, :, None, None]
    shifted = np.clip(hi + j, 0, 255)
    cur[:, top + 24:top + nh] = np.where(hi == 250, shifted + e_row, shifted).astype(np.uint8)
    cur[1, top + 4:top + 8, 8:32] = rng.integers(0, 256, (4, 24, 3), np.uint8)
    return cur, prev, top, nh, 8


def seg_shift_sparse():
    """A +4 shift over mid-range content (row 0 clean, so the slot's probe
    finds j = 4) with a few two-sided +-3 deviations in some segments: the
    sparse nibble over the shift base (class 9)."""
    rng = np.random.default_rng(17)
    prev = rng.integers(70, 180, (2, 16, 80, 3), np.uint8)
    cur = prev + np.uint8(4)
    for r in range(2, 14, 3):
        flat = cur[0, r].reshape(-1)
        idx = rng.choice(40 * 3, size=6, replace=False)
        flat[idx] += np.array([3, 253, 3, 253, 2, 254], np.uint8)  # +-3, +-2 mod 256
    return cur, prev, 0, 16, 40


def seg_crop_plane():
    """A classifier crop plane, 16 crops of 64x64 and one 64-px segment per
    row: a +3 shift on four crops, a fresh crop, noise on a band."""
    rng = np.random.default_rng(9)
    prev = rng.integers(30, 220, (16, 64, 64, 3), np.uint8)
    cur = prev.copy()
    cur[:4] = clip_u8(cur[:4].astype(np.int16) + 3)
    cur[4] = rng.integers(0, 256, (64, 64, 3), np.uint8)
    cur[5, 10:20] = clip_u8(cur[5, 10:20].astype(np.int16) + rng.integers(-2, 3, (10, 64, 3)))
    return cur, prev, 0, 64, 64


SEG_CASES = {"const": seg_const, "dense": seg_dense, "mixed": seg_mixed,
             "whole_slot": seg_whole_slot, "sparse": seg_sparse,
             "clip_boundary": seg_clip_boundary, "shift_sparse": seg_shift_sparse,
             "crop_plane": seg_crop_plane}


def seg_bufs(nseg: int, segw: int):
    segb = segw * 3
    sizes = (nseg * segb // 8, nseg * segb // 4, nseg * segb * 3 // 8, nseg * segb, nseg, nseg,
             nseg * segb // 8, nseg * segb // 8, nseg * segb, nseg * segb, nseg * 3, nseg)
    return tuple(np.zeros(n, np.uint8) for n in sizes)


@pytest.fixture(scope="module")
def seg_runs():
    """Each case through the port's encoder, its twin and the JAX package's."""
    out = {}
    for name, make in SEG_CASES.items():
        cur, prev, top, nh, segw = make()
        nseg = cur.shape[0] * nh * (cur.shape[2] // segw)
        runs = {}
        for impl, fn in (("port", pt_native.seg_encode), ("plain", pt_native.seg_encode_plain),
                         ("jax", jax_native.seg_encode)):
            bufs = seg_bufs(nseg, segw)
            runs[impl] = (fn(cur, prev, top, nh, segw, *bufs), bufs)
        out[name] = (cur, prev, top, nh, segw, runs)
    return out


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_encode_byte_identical_to_twin_and_jax(seg_runs, case):
    cur, prev, top, nh, segw, runs = seg_runs[case]
    counts, bufs = runs["port"]
    assert counts is not None
    for impl in ("plain", "jax"):
        assert runs[impl][0] == counts, (impl, runs[impl][0], counts)
        for i, (a, b) in enumerate(zip(runs[impl][1], bufs)):
            np.testing.assert_array_equal(a, b, err_msg=f"{impl} buffer {i}")


def test_seg_encode_cases_cover_every_class(seg_runs):
    classes = set()
    for cur, prev, top, nh, segw, runs in seg_runs.values():
        nseg = cur.shape[0] * nh * (cur.shape[2] // segw)
        classes |= set(np.unique(runs["port"][1][11][:nseg]).tolist())
    assert classes == set(range(11)), classes
    whole = seg_runs["whole_slot"]
    sps = whole[3] * (whole[0].shape[2] // whole[4])
    assert (whole[5]["port"][1][11][:sps] == 5).all()


def test_seg_encode_rejects_unusable_segment_widths():
    """None for a width that is not a multiple of 8 or is over 64 px, from
    the port's encoder and its twin alike."""
    cur = np.zeros((1, 8, 80, 3), np.uint8)
    for segw in (12, 80):
        bufs = seg_bufs(8 * 80 // 8, 8)
        assert pt_native.seg_encode(cur, cur, 0, 8, segw, *bufs) is None
        assert pt_native.seg_encode_plain(cur, cur, 0, 8, segw, *bufs) is None


def test_encoders_reject_bad_buffers_before_the_call():
    """The C++ encoders get pointers: a short or non-uint8 output buffer,
    canvases of another shape or rows outside them raise ValueError first."""
    cur = np.zeros((2, 16, 40, 3), np.uint8)
    n = 2 * 8 * 40 * 3
    with pytest.raises(ValueError):
        pt_native.nibble_encode(cur, cur, 0, 8, np.zeros(n // 2 - 1, np.uint8), np.zeros(6, np.uint8))
    with pytest.raises(ValueError):
        pt_native.tribit_encode(cur, cur, 0, 8, np.zeros(n, np.int16), np.zeros(48, np.uint8))
    with pytest.raises(ValueError):
        pt_native.nibble_encode(cur, cur[:1], 0, 8, np.zeros(n, np.uint8), np.zeros(6, np.uint8))
    with pytest.raises(ValueError):
        pt_native.nibble_encode(cur, cur, 10, 8, np.zeros(n, np.uint8), np.zeros(6, np.uint8))
    bufs = list(seg_bufs(2 * 8 * 5, 8))
    bufs[8] = bufs[8][:10]  # the nibble stream
    with pytest.raises(ValueError):
        pt_native.seg_encode(cur, cur, 0, 8, 8, *bufs)


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segs_payload_and_decode_bit_exact_against_jax(seg_runs, case):
    """The port's payload assembly byte for byte the JAX package's, and the
    port's _segs_decoder bit for bit the JAX package's and the encoded plane
    (the bars outside the content rows 114)."""
    cur, prev, top, nh, segw, _ = seg_runs[case]
    nslots, H, W, _ = cur.shape
    nseg = nslots * nh * (W // segw)
    segb = segw * 3
    qs = (segb // 8, segb // 4, segb * 3 // 8, segb)
    raw = nslots * nh * W * 3
    # a fresh random plane does not pay (no smaller than half its bytes):
    # both packages say so, and its payload is decoded from buffers sized as
    # for a plane 4 times as large
    sizes = (raw, 4 * raw) if case == "dense" else (raw,)
    for size in sizes:
        pays = {}
        for name, cls in (("port", pt_serving.BatchStream), ("jax", jax_serving.BatchStream)):
            bufs = cls._make_segs_bufs(segw, nseg, size, 1)
            counts = pt_native.seg_encode(cur, prev, top, nh, segw, *(bufs[k] for k in (
                "p1", "p2", "p3", "raw", "m4", "m8", "s4", "s8", "nib", "byte", "bias", "cls")))
            pays[name] = cls._assemble_segs_payload(bufs, 0, counts, qs, nseg, nslots, size)
        assert (pays["port"] is None) == (pays["jax"] is None) == (size < sizes[-1])
    (payload, npb), (jpayload, jnpb) = pays["port"], pays["jax"]
    assert npb == jnpb
    np.testing.assert_array_equal(payload, jpayload)
    got = pt_serving._segs_decoder(nslots, H, W, top, nh, segw, npb)(
        torch.from_numpy(payload.copy()), torch.from_numpy(prev).reshape(-1))
    want = np.asarray(jax.jit(jax_serving._segs_decoder(nslots, H, W, top, nh, segw, npb))(
        jnp.asarray(payload), jnp.asarray(prev.reshape(-1))))
    expect = cur.copy()
    expect[:, :top] = 114
    expect[:, top + nh:] = 114
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(cur.shape), expect)


# ---------------------------------------------------------------------------
# nibble and tribit: tests/test_native.py's cases, on square canvases so that
# the JAX package's BatchStream decodes them

NB, NS, NTOP, NNH = 3, 32, 5, 20


def nibble_delta(case, rng):
    shape = (NB, NS, NS, 3)
    if case == "small":
        return rng.integers(-7, 8, shape, np.int16)
    if case == "constant":
        return np.broadcast_to(rng.integers(-12, 13, (NB, 1, 1, 3), np.int16), shape)
    if case == "negative":
        return rng.integers(-15, 1, (NB, 1, 1, 3), np.int16) + rng.integers(0, 2, shape, np.int16)
    if case == "clip":
        return rng.integers(120, 128, (NB, 1, 1, 3), np.int16) - rng.integers(0, 8, shape, np.int16)
    return rng.integers(-128, 128, shape, np.int16)  # big: rejected


def tribit_delta(case, rng):
    shape = (NB, NS, NS, 3)
    if case == "tiny":
        return rng.integers(-3, 4, shape, np.int16)
    if case == "rowconst":
        return np.broadcast_to(rng.integers(-30, 31, (NB, NS, 1, 3), np.int16), shape)
    if case == "negative":
        return rng.integers(-7, 1, (NB, NS, 1, 3), np.int16) + rng.integers(0, 2, shape, np.int16)
    d = rng.integers(-3, 4, shape, np.int16)  # reject: span 20 in one row
    d[1, NTOP + 4, 3, 1] = 20
    return d.copy()


@pytest.fixture(scope="module")
def jax_decoders():
    """A JAX BatchStream at (NB, NS) whose shared compute program is stubbed
    to hand back the decoded canvas: its nibble and tribit decodes alone."""
    js = jax_serving.load_batch_stream(DET_N, CLS, batch=NB, imgsz=NS,
                                       compute_dtype=jnp.float32, use_pallas_nms=False)
    js._compute_fused = lambda det_p, cls_p, canv, crops: (None, None, canv, crops)
    progs = js._get_active_progs(NTOP, NNH)
    yield {"nibble": lambda p, prev: progs["nibble"](None, p, prev)[2],
           "tribit": lambda p, prev: progs["tribit"](None, p, prev)[2],
           "nibble_full": lambda p, prev: js._detect_nibble(None, p, prev)[2]}
    js.close()


CODEC_CASES = [("nibble", c) for c in ("small", "constant", "negative", "clip", "big")] + \
    [("nibble_full", c) for c in ("small", "clip", "big")] + \
    [("tribit", c) for c in ("tiny", "rowconst", "negative", "reject")]


@pytest.mark.parametrize("kind,case", CODEC_CASES)
def test_nibble_tribit_encode_and_decode_bit_exact(jax_decoders, kind, case):
    """The port's encoder byte for byte its twin and the JAX package's (or
    all three reject), and the port's decode bit for bit the JAX package's
    and the current canvas: rows [NTOP, NTOP+NNH), or the whole canvas."""
    rng = np.random.default_rng(len(kind) * 100 + len(case))
    # content that the deltas do not wrap (the encoders see a wrapped delta
    # as a wide span); "clip" adds up to 127
    lo, hi = (0, 128) if case == "clip" else (32, 224)
    prev = rng.integers(lo, hi, (NB, NS, NS, 3), np.uint8)
    d = (tribit_delta if kind == "tribit" else nibble_delta)(case, rng)
    cur = (prev.astype(np.int16) + d).astype(np.uint8)  # mod 256 on purpose
    top, nh = (0, NS) if kind == "nibble_full" else (NTOP, NNH)
    n_val = NB * nh * NS * 3
    if kind == "tribit":
        n_pay, n_bias = n_val * 3 // 8, NB * nh * 3
        encoders = (pt_native.tribit_encode, pt_native.tribit_encode_plain,
                    jax_native.tribit_encode)
    else:
        n_pay, n_bias = n_val // 2, NB * 3
        encoders = (pt_native.nibble_encode, pt_native.nibble_encode_plain,
                    jax_native.nibble_encode)
    outs = []
    for enc in encoders:
        out = np.zeros(n_pay + n_bias, np.uint8)
        outs.append((enc(cur, prev, top, nh, out[:n_pay], out[n_pay:]), out))
    assert [ok for ok, _ in outs] == [outs[0][0]] * 3
    if case in ("big", "reject"):
        assert outs[0][0] is False
        return
    assert outs[0][0] is True
    for _, out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0][1])
    payload = outs[0][1]
    decode = pt_serving.tribit_decode if kind == "tribit" else pt_serving.nibble_decode
    got = decode(torch.from_numpy(payload), torch.from_numpy(prev).reshape(-1), NB, NS, NS,
                 top, nh).numpy()
    want = np.asarray(jax_decoders[kind](jnp.asarray(payload), jnp.asarray(prev.reshape(-1))))
    np.testing.assert_array_equal(got, want)
    expect = prev.copy()
    expect[:, top:top + nh] = cur[:, top:top + nh]
    np.testing.assert_array_equal(got.reshape(cur.shape), expect)


# ---------------------------------------------------------------------------
# BatchStream with the codec, port against the JAX package


def pair_dets(got, ref):
    """One table's detections paired, each reference detection with the
    nearest of its class; box corners within 1 px, confidences within 0.002,
    the same class lists."""
    left, pairs = list(got), []
    for r in ref:
        same = [d for d in left if d["class_id"] == r["class_id"]]
        assert same, r
        g = min(same, key=lambda d: np.abs(np.subtract(d["bbox"], r["bbox"])).max())
        assert np.abs(np.subtract(g["bbox"], r["bbox"])).max() <= 1, (g, r)
        assert abs(g["conf"] - r["conf"]) <= 0.002, (g, r)
        left.remove(g)
        pairs.append((g, r))
    assert not left, left
    return pairs


def mixed_ticks():
    """(ticks, expected mode of each): the example as 4 tables (1200x1920,
    each rolled a few px), then per tick a global jitter within [-6, 6] per
    channel and a 40x60 repaint on every table, one table repainted alone,
    per-pixel noise within +-3, copies, table 0 at another geometry, noise
    within +-7 at that geometry."""
    rng = np.random.default_rng(0)
    base = cv_resize_u8(example(), (1200, 1920))
    t0 = [np.ascontiguousarray(np.roll(base, (i, 2 * i), axis=(0, 1))) for i in range(4)]

    def jitter_repaint(frames):
        out = []
        for i, f in enumerate(frames):
            g = clip_u8(f.astype(np.int16) + rng.integers(-6, 7, (1, 1, 3), np.int16))
            y, x = 100 + 37 * i, 200 + 53 * i
            g[y:y + 40, x:x + 60] = rng.integers(0, 256, (40, 60, 3), np.uint8)
            out.append(g)
        return out

    def noise(frames, a):
        return [clip_u8(f.astype(np.int16) + rng.integers(-a, a + 1, f.shape, np.int16))
                for f in frames]

    t1 = jitter_repaint(t0)
    t2 = jitter_repaint(t1)
    t3 = jitter_repaint(t2)
    t4 = list(t3)
    t4[2] = t3[2].copy()
    t4[2][600:640, 900:960] = 255 - t4[2][600:640, 900:960]
    t5 = noise(t4, 3)
    t6 = [f.copy() for f in t5]
    t7 = [cv_resize_u8(example(), (1280, 1920))] + t6[1:]
    t8 = noise(t7, 7)
    ticks = [t0, t1, t2, t3, t4, t5, t6, t7, t8]
    modes = ["raw", "segs", "segs", "segs", "slots", "tribit", "skip", "raw", "nibble"]
    return ticks, modes


@pytest.mark.parametrize("imgsz", [320, 192])
def test_mixed_stream_matches_jax_mode_for_mode(imgsz):
    """Port and JAX BatchStream (delta on, B=4, f32) on the mixed stream:
    after every tick the same mode and crop-mode counts, fused hits, misses
    and fallbacks; the same detections within the tolerance, texts equal on
    equal boxes; the port's resident canvas the host staging and the JAX
    package's resident canvas byte for byte, its resident predicted crop
    plane the host's."""
    ticks, modes = mixed_ticks()
    js = jax_serving.load_batch_stream(DET_N, CLS, batch=4, imgsz=imgsz,
                                       compute_dtype=jnp.float32, use_pallas_nms=False)
    ps = pt_serving.load_batch_stream(DET_N, CLS, batch=4, imgsz=imgsz,
                                      compute_dtype=torch.float32, device="cpu")
    assert ps._segw == js._segw == (40 if imgsz == 320 else 32)
    prev_modes, n_texts = None, 0
    try:
        for t, (frames, mode) in enumerate(zip(ticks, modes)):
            js.submit_batch(frames)
            ps.submit_batch(frames)
            ref, got = js.collect_batch(), ps.collect_batch()
            assert ps.mode_counts == js.mode_counts, (t, ps.mode_counts, js.mode_counts)
            grew = [k for k in ps.mode_counts if ps.mode_counts[k] != (prev_modes or {}).get(k, 0)]
            assert grew == [mode], (t, ps.mode_counts)
            prev_modes = dict(ps.mode_counts)
            assert ps.crop_mode_counts == js.crop_mode_counts, t
            assert (ps.fused_hits, ps.fused_misses, ps.fallback_batches, ps.memo_hits) == \
                (js.fused_hits, js.fused_misses, js.fallback_batches, js.memo_hits), t
            canvas = ps._dev_canvas.numpy()
            np.testing.assert_array_equal(canvas, ps._staging[ps._staging_i])
            np.testing.assert_array_equal(canvas.reshape(-1), np.asarray(js._dev_prev))
            if ps._pred_prev_crops is not None:
                np.testing.assert_array_equal(ps._dev_pred_crops.numpy(), ps._pred_prev_crops)
            for g_dets, r_dets in zip(got, ref):
                for g, r in pair_dets(g_dets, r_dets):
                    if g["bbox"] == r["bbox"]:
                        assert g["ocr_text"] == r["ocr_text"], (t, g, r)
                        n_texts += bool(g["ocr_text"])
    finally:
        js.close()
        ps.close()
    assert ps.crop_mode_counts["fused_raw"] == 1 and ps.crop_mode_counts["fused_segs"] == 2
    if imgsz == 320:  # YOLOv8n finds the ranks at 320, not at 192
        assert ps.fused_hits > 0 and n_texts > 0
        assert ps.crop_mode_counts["segs"] + ps.crop_mode_counts["raw"] > 1


@functools.lru_cache(maxsize=1)
def _random_init_params():
    """tests/test_serving.py's random-init YOLOv8n detector and classifier,
    from JAX seeds, folded, with numpy leaves."""
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    out = []
    for variant, nc, seed in (("detect", 64, 0), ("classify", 13, 1)):
        spec = jax_yolov8.build_spec(variant, "n", nc=nc)
        out.append(to_np(jax_yolov8.fold_params(
            jax_yolov8.init_params(jax.random.PRNGKey(seed), spec), spec)))
    return tuple(out)


def random_init_stream(delta: bool = True):
    """A port BatchStream over the random-init pair, carried in by
    load_jax_params: B=4, imgsz 192, conf 1e-6, f32."""
    det, cls = _random_init_params()
    return pt_serving.BatchStream(
        det_params=det, det_spec=pt_yolov8.build_spec("detect", "n", 64),
        cls_params=cls, cls_spec=pt_yolov8.build_spec("classify", "n", 13),
        names=jax_taxonomy.CLASSES, rank_names={i: str(i) for i in range(13)}, batch=4,
        imgsz=192, conf=1e-6, compute_dtype=torch.float32, delta=delta, device="cpu")


def test_fused_predictive_classify_lossless_against_raw_stream():
    """tests/test_serving.py's fused-classify check on the port: every tick a
    dense change (a +-2 photometric shift) and a repaint moving down each
    table, so that some rank rects are predicted and others missed; the
    delta stream's results equal the raw stream's on every tick."""
    sd, sr = random_init_stream(), random_init_stream(delta=False)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (240, 400, 3), np.uint8)

    def frame(t, i):
        f = clip_u8(base.astype(np.int16) + (t + i) % 5 - 2)
        y = 20 * ((t * 7 + i * 3) % 9)
        f[y:y + 30, 50:90] = rng.integers(0, 256, (30, 40, 3), np.uint8)
        return f

    try:
        for t in range(5):
            fr = [frame(t, i) for i in range(4)]
            sd.submit_batch(fr)
            sr.submit_batch(fr)
            assert sd.collect_batch() == sr.collect_batch(), t
        assert sd.crop_mode_counts["fused_segs"] + sd.crop_mode_counts["fused_raw"] >= 3
        assert sd.fused_hits > 0 and sd.fused_misses > 0 and sd.fallback_batches > 0
        assert sd.mode_counts["segs"] >= 3 and sr.mode_counts["raw"] == 5
    finally:
        sd.close()
        sr.close()


def test_crop_plane_ladder_raw_segs_skip_lossless():
    """The finisher's crop-plane coding: raw (no reference), segs (a +2
    shift), skip (the same bytes); the probabilities those of a raw
    classification, and the resident crop plane the host's after segs."""
    s = random_init_stream()
    try:
        rng = np.random.default_rng(9)
        prev = rng.integers(30, 220, (s.B * s.max_rank, 64, 64, 3), np.uint8)
        shifted = clip_u8(prev.astype(np.int16) + 2)
        p0 = s._classify_crops(prev)
        p1 = s._classify_crops(shifted)
        p2 = s._classify_crops(shifted.copy())
        assert s.crop_mode_counts == {"raw": 1, "segs": 1, "skip": 1, "fused_segs": 0,
                                      "fused_raw": 0}
        np.testing.assert_array_equal(s._dev_prev_crops.numpy(), shifted)
        np.testing.assert_array_equal(p1, s._probs_u8(s._classify_probs(shifted)))
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(p0, s._probs_u8(s._classify_probs(prev)))
    finally:
        s.close()


def test_prewarm_leaves_the_stream_unchanged():
    """prewarm_async and prewarm_buckets change no state a tick reads: a
    prewarmed stream gives an untouched one's results, and prewarm_buckets
    returns at most max_programs bucket keys."""
    s, ref = random_init_stream(), random_init_stream()
    rng = np.random.default_rng(9)
    base = rng.integers(20, 236, (240, 400, 3), np.uint8)
    try:
        s.prewarm_async()
        assert s._pred_segs_bufs is not None and s._crop_segs_bufs is not None
        for t in range(3):
            f = clip_u8(base.astype(np.int16) + rng.integers(-4, 5, (1, 1, 3), np.int16))
            f[40 + t * 4:60 + t * 4, 100:140] = rng.integers(0, 256, (20, 40, 3), np.uint8)
            frames = [f, f.copy(), f.copy(), f.copy()]
            s.submit_batch(frames)
            ref.submit_batch(frames)
            assert s.collect_batch() == ref.collect_batch()
            if t == 1:
                keys = s.prewarm_buckets(max_programs=3)
                assert len(keys) <= 3 and all(len(k) == 4 for k in keys)
                assert s.prewarm_buckets(deadline=0.0) == []
        assert s._fused_buckets and s.mode_counts == ref.mode_counts
    finally:
        s.close()
        ref.close()
