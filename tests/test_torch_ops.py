"""PyTorch port vs the JAX package: letterbox, box geometry, NMS and the
greedy keep mask (the CUDA kernel's plain twin, which CPU tensors take; the
kernel itself is tested on the card in test_torch_gpu.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.ops import boxes as jax_boxes  # noqa: E402
from manual_yolo_tpu.ops import letterbox as jax_lb  # noqa: E402
from manual_yolo_tpu.ops import nms as jax_nms  # noqa: E402
from manual_yolo_tpu.ops.pallas_nms import pallas_nms_keep  # noqa: E402
from manual_yolo_tpu_torch.ops import boxes as pt_boxes  # noqa: E402
from manual_yolo_tpu_torch.ops import letterbox as pt_lb  # noqa: E402
from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain  # noqa: E402
from test_pallas_nms import _greedy_keep_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _random_boxes(rng, k, lo=0, hi=400, wmin=10, wmax=120):
    xy = rng.uniform(lo, hi, (k, 2)).astype(np.float32)
    wh = rng.uniform(wmin, wmax, (k, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


# --- letterbox -------------------------------------------------------------


@pytest.mark.parametrize("src_hw", [(1200, 1920), (900, 1600)])
def test_letterbox_matches_jax(src_hw):
    """Canvas within 1/255 (bilinear of two implementations, f32)."""
    frame = np.random.default_rng(0).integers(0, 256, src_hw + (3,), dtype=np.uint8)
    cj, rj, pj = jax_lb.letterbox(jnp.asarray(frame), (640, 640))
    ct, rt, pt = pt_lb.letterbox(torch.from_numpy(frame), (640, 640))
    assert (rt, pt) == (rj, pj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1 / 255)


def test_letterbox_params_match_jax():
    for src in [(900, 1600), (1200, 1920), (1080, 1920), (333, 777), (640, 640)]:
        for scaleup in (True, False):
            assert pt_lb.letterbox_params(src, (640, 640), scaleup) == \
                jax_lb.letterbox_params(src, (640, 640), scaleup)


def test_unletterbox_matches_jax():
    """f32 affine map, within 1e-4 px."""
    boxes = _random_boxes(np.random.default_rng(3), 50, -20, 660)
    ratio, pad, src = 640 / 1920, (140, 0), (1200, 1920)
    got = pt_lb.unletterbox_boxes(torch.from_numpy(boxes), ratio, pad, src).numpy()
    ref = np.asarray(jax_lb.unletterbox_boxes(jnp.asarray(boxes), ratio, pad, src))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --- boxes -----------------------------------------------------------------


def test_pairwise_iou_matches_jax():
    """Same operation order: equal to f32 rounding (1e-6)."""
    rng = np.random.default_rng(5)
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 30)
    got = pt_boxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pt_boxes.box_area(torch.from_numpy(a)).numpy(),
        np.asarray(jax_boxes.box_area(jnp.asarray(a))), rtol=1e-6,
    )


# --- the keep mask ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_keep_plain_matches_oracle_and_pallas(seed):
    """Bit-exact, K=128, thres 0.5 (the Pallas test's inputs)."""
    rng = np.random.default_rng(seed)
    k = 128
    boxes = _random_boxes(rng, k)
    scores = np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1]
    valid = scores > 0.3

    keep_ref = _greedy_keep_numpy(boxes, valid, 0.5)
    keep_pl = np.asarray(
        pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True)
    )
    keep_pt = nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.5)
    np.testing.assert_array_equal(keep_pt[0].numpy(), keep_ref)
    np.testing.assert_array_equal(keep_pt[0].numpy(), keep_pl)


def test_nms_keep_plain_k512_class_offsets():
    """Bit-exact at the main path's K=512 with class offsets applied, on
    overlapping boxes (few centers) so that suppression happens."""
    rng = np.random.default_rng(7)
    k = 512
    centers = rng.uniform(50, 500, (12, 2))[rng.integers(0, 12, k)]
    xy = (centers + rng.normal(0, 8, (k, 2))).astype(np.float32)
    wh = rng.uniform(20, 80, (k, 2)).astype(np.float32)
    cls = rng.integers(0, 5, k).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1) + (cls * np.float32(pt_nms.MAX_WH))[:, None]
    valid = np.arange(k) < 333

    keep_ref = _greedy_keep_numpy(boxes, valid, 0.7)
    keep_pl = np.asarray(
        pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.7, interpret=True)
    )
    keep_pt = nms_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.7)
    assert 0 < keep_ref.sum() < valid.sum()  # the case suppresses
    np.testing.assert_array_equal(keep_pt[0].numpy(), keep_ref)
    np.testing.assert_array_equal(keep_pt[0].numpy(), keep_pl)


def test_nms_keep_plain_batched_rows_independent():
    """(B, K) rows are separate frames: each equals its own B=1 result."""
    rng = np.random.default_rng(11)
    boxes = np.stack([_random_boxes(rng, 96) for _ in range(3)])
    valid = np.arange(96)[None, :] < np.array([[0], [40], [96]])
    got = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], _greedy_keep_numpy(boxes[b], valid[b], 0.5))


def test_nms_keep_empty():
    boxes = torch.zeros((1, 64, 4))
    valid = torch.zeros((1, 64), dtype=torch.bool)
    assert not nms_keep(boxes, valid, 0.5).any()


def test_nms_keep_cpu_uses_plain_and_does_not_count():
    rng = np.random.default_rng(2)
    boxes = torch.from_numpy(_random_boxes(rng, 64))[None]
    valid = torch.ones((1, 64), dtype=torch.bool)
    before = nms_keep.launches
    got = nms_keep(boxes, valid, 0.5)
    assert nms_keep.launches == before
    assert torch.equal(got, nms_keep_plain(boxes, valid, 0.5))


@pytest.mark.parametrize("bad", ["dtype", "valid_dtype", "shape", "valid_shape"])
def test_nms_keep_rejects_bad_inputs(bad):
    boxes = torch.zeros((1, 8, 4))
    valid = torch.zeros((1, 8), dtype=torch.bool)
    if bad == "dtype":
        boxes = boxes.double()
    elif bad == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif bad == "shape":
        boxes = boxes[0]
    else:
        valid = valid[:, :4]
    with pytest.raises((TypeError, ValueError)):
        nms_keep(boxes, valid, 0.5)


# --- nms -------------------------------------------------------------------


def _assert_same_detections(got, ref):
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(ref.boxes))
    assert int(got.count) == int(ref.count)


def _nms_both(boxes, scores, **kw):
    got = pt_nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jax_nms.nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    return got, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_matches_jax_random(seed):
    """Equal Detections (exact) at A=8400 anchors, nc=64."""
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, 8400, 0, 600, 5, 60)
    scores = (rng.uniform(0, 1, (8400, 64)) ** 8).astype(np.float32)
    got, ref = _nms_both(boxes, scores, conf_thres=0.25, iou_thres=0.7)
    assert int(ref.count) > 10
    _assert_same_detections(got, ref)


def test_nms_matches_jax_with_ties():
    """Scores on a coarse grid tie across anchors and classes: the lower
    anchor index goes first and argmax takes the first class, as in JAX."""
    rng = np.random.default_rng(4)
    boxes = _random_boxes(rng, 8400, 0, 600, 5, 60)
    scores = np.round(rng.uniform(0, 1, (8400, 64)) ** 6 * 8) / 8
    scores = scores.astype(np.float32)
    scores[100:140] = scores[99]  # whole rows equal too
    boxes[100:140] = boxes[99]
    got, ref = _nms_both(boxes, scores, conf_thres=0.25, iou_thres=0.7)
    assert int(ref.count) > 10
    _assert_same_detections(got, ref)


def test_nms_matches_jax_empty():
    rng = np.random.default_rng(9)
    boxes = _random_boxes(rng, 8400)
    scores = rng.uniform(0, 0.2, (8400, 64)).astype(np.float32)
    got, ref = _nms_both(boxes, scores, conf_thres=0.25)
    assert int(got.count) == 0
    _assert_same_detections(got, ref)


def test_nms_small_anchor_count_pads_like_jax():
    """A < pre_nms and A < max_det: the output is padded to max_det."""
    rng = np.random.default_rng(6)
    boxes = _random_boxes(rng, 84)
    scores = rng.uniform(0, 1, (84, 13)).astype(np.float32)
    got, ref = _nms_both(boxes, scores, conf_thres=0.5, iou_thres=0.5)
    assert got.boxes.shape == (300, 4)
    _assert_same_detections(got, ref)


def test_top_k_matches_jax_on_ties():
    x = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.0, 0.0], np.float32)
    vals, idx = pt_nms.top_k(torch.from_numpy(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
