"""The port's OCR building blocks against the JAX package (and OpenCV), on the
CPU: the image ops of the preprocessing variants, the host resize and
``preprocess_gray``, the CRNN, the CTC decoders (torch greedy, C++ beam and
rescore), the host C++ library's PNG unfilter, and the PNG reader on every
PNG format; and the detector in bf16 against JAX's bf16."""

import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.models import crnn as jax_crnn  # noqa: E402
from manual_yolo_tpu.ops import ctc as jax_ctc  # noqa: E402
from manual_yolo_tpu.ops import image as jax_img  # noqa: E402
from manual_yolo_tpu.runtime import ocr as jax_ocr  # noqa: E402
from manual_yolo_tpu.runtime import shot as jax_shot  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import crnn as pt_crnn  # noqa: E402
from manual_yolo_tpu_torch.ops import ctc as pt_ctc  # noqa: E402
from manual_yolo_tpu_torch.ops import image as pt_img  # noqa: E402
from manual_yolo_tpu_torch.runtime import native  # noqa: E402
from manual_yolo_tpu_torch.runtime import png as pt_png  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402
from manual_yolo_tpu_torch.runtime.ocr import (  # noqa: E402
    CARD_ALLOW, NUMERIC_ALLOW, STRICT_NAME_ALLOW,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


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


def _canvases(seed: int, n: int = 6, h: int = 32, w: int = 256) -> np.ndarray:
    """Text-like gray canvases in [0, 1]: a light background with noise and
    dark strokes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.6, 0.9, (n, 1, 1)) + rng.normal(0, 0.05, (n, h, w))
    for i in range(n):
        for _ in range(8):
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
            x[i, y0:y0 + rng.integers(2, h // 4 + 3), x0:x0 + rng.integers(1, 10)] -= 0.5
    return np.clip(x, 0, 1).astype(np.float32)


# --- ops/image.py ------------------------------------------------------------

IMAGE_OPS = {
    "otsu_binarize": (pt_img.otsu_binarize, jax_img.otsu_binarize),
    "otsu_binarize_inverse": (lambda x: pt_img.otsu_binarize(x, True),
                              lambda x: jax_img.otsu_binarize(x, True)),
    "clahe_2": (lambda x: pt_img.clahe(x, 2.0), lambda x: jax_img.clahe(x, 2.0)),
    "clahe_3_tiles_4x2": (lambda x: pt_img.clahe(x, 3.0, (4, 2)),
                          lambda x: jax_img.clahe(x, 3.0, (4, 2))),
    "gaussian_blur_3": (pt_img.gaussian_blur, jax_img.gaussian_blur),
    "gaussian_blur_9": (lambda x: pt_img.gaussian_blur(x, 9), lambda x: jax_img.gaussian_blur(x, 9)),
    "gaussian_blur_5_sigma": (lambda x: pt_img.gaussian_blur(x, 5, 1.3),
                              lambda x: jax_img.gaussian_blur(x, 5, 1.3)),
    "sharpen": (pt_img.sharpen, jax_img.sharpen),
    "adaptive_threshold": (pt_img.adaptive_threshold_gaussian, jax_img.adaptive_threshold_gaussian),
    "erode_2": (pt_img.erode, jax_img.erode),
    "dilate_3": (lambda x: pt_img.dilate(x, 3), lambda x: jax_img.dilate(x, 3)),
    "morph_open_2": (pt_img.morph_open, jax_img.morph_open),
    "morph_close_3": (lambda x: pt_img.morph_close(x, 3), lambda x: jax_img.morph_close(x, 3)),
    "resize_cubic_up": (lambda x: pt_img.resize_cubic(x, (64, 512)),
                        lambda x: jax_img.resize_cubic(x, (64, 512))),
    "resize_cubic_down": (lambda x: pt_img.resize_cubic(x, (20, 100)),
                          lambda x: jax_img.resize_cubic(x, (20, 100))),
    "resize_bilinear_up": (lambda x: pt_img.resize_bilinear(x, (48, 300)),
                           lambda x: jax_img.resize_bilinear(x, (48, 300))),
    "resize_bilinear_down": (lambda x: pt_img.resize_bilinear(x, (13, 100)),
                             lambda x: jax_img.resize_bilinear(x, (13, 100))),
    "estimate_skew_angle": (pt_img.estimate_skew_angle, jax_img.estimate_skew_angle),
    "deskew": (pt_img.deskew, jax_img.deskew),
    "enhance_for_ocr_standard": (pt_img.enhance_for_ocr_standard, jax_img.enhance_for_ocr_standard),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_op_matches_jax(name):
    """Each op on a batch of canvases, against the JAX op vmapped over it:
    within 1e-5."""
    pt_fn, jax_fn = IMAGE_OPS[name]
    x = _canvases(1)
    got = pt_fn(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax_fn))(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_enhance_for_ocr_card_matches_jax():
    x = _canvases(2, n=3, h=20, w=30)
    got = pt_img.enhance_for_ocr_card(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.vmap(jax_img.enhance_for_ocr_card)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_rotate_bilinear_matches_jax():
    x = _canvases(3)
    ang = np.random.default_rng(3).uniform(-0.25, 0.25, len(x)).astype(np.float32)
    ang[0] = 0.0
    got = pt_img.rotate_bilinear(torch.from_numpy(x), torch.from_numpy(ang)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax_img.rotate_bilinear))(jnp.asarray(x), jnp.asarray(ang)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], x[0])


@pytest.mark.parametrize("seed", range(4))
def test_histogram_and_otsu_bin_exact(seed):
    """256-bin histograms and the Otsu threshold's bin equal JAX's exactly,
    on seeded canvases and on 64-px ones; the threshold as JAX's compiled
    program computes it (the bin times the f32 reciprocal of 255, which
    XLA puts in place of the division), as the OCR engine runs it."""
    for x in (_canvases(10 + seed), _canvases(20 + seed, n=3, h=64)):
        xt = torch.from_numpy(x)
        hist = pt_img._bincount(pt_img._quantize(xt).reshape(len(x), -1)).numpy()
        ref = np.stack([np.asarray(jax_img._hist256(jnp.asarray(c))) for c in x])
        np.testing.assert_array_equal(hist, ref)
        got = pt_img.otsu_threshold(xt).numpy()
        ref_t = np.asarray(jax.jit(jax.vmap(jax_img.otsu_threshold))(jnp.asarray(x)))
        np.testing.assert_array_equal(np.round(got * 255), np.round(ref_t * 255))
        np.testing.assert_array_equal(got, ref_t)


@pytest.mark.parametrize("h", [32, 64])
def test_skew_angle_clahe_and_otsu_bit_for_bit_with_compiled_jax(h):
    """On canvases on the k/255 grid with a flat 30/255 band (where CLAHE's
    and Otsu's quantisers turn a last bit into another bin): the rotation at
    the JAX package's angle, CLAHE and the Otsu variant equal its compiled
    (jitted, vmapped) ops bit for bit. The skew angle itself is within 1e-7
    rad: the port sums the moments in f64 on the device, the compiled
    program in f32 in XLA's order with the C library's ``atan2f``."""
    rng = np.random.default_rng(h)
    x = (rng.integers(0, 256, (12, h, 256)) / 255).astype(np.float32)
    x[:, :, :50] = np.float32(30 / 255)
    x[:6] = _canvases(h, n=6, h=h)
    ang = pt_img.estimate_skew_angle(torch.from_numpy(x)).numpy()
    ref = np.array(jax.jit(jax.vmap(jax_img.estimate_skew_angle))(jnp.asarray(x)))
    np.testing.assert_allclose(ang, ref, rtol=0, atol=1e-7)
    assert (ref != 0).all()
    rot = pt_img.rotate_bilinear(torch.from_numpy(x), torch.from_numpy(ref)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax_img.rotate_bilinear))(jnp.asarray(x), jnp.asarray(ref)))
    np.testing.assert_array_equal(rot, ref)
    for pt_fn, jax_fn in ((lambda g: pt_img.clahe(g, clip_limit=2.0),
                           lambda g: jax_img.clahe(g, clip_limit=2.0)),
                          (pt_img.otsu_binarize, jax_img.otsu_binarize)):
        got = pt_fn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.jit(jax.vmap(jax_fn))(jnp.asarray(x))))


def test_gaussian_kernel_matches_jax():
    for k, s in [(1, 0), (3, 0), (5, 0), (7, 0), (11, 0), (5, 1.3)]:
        np.testing.assert_allclose(pt_img.gaussian_kernel1d(k, s).numpy(),
                                   np.asarray(jax_img.gaussian_kernel1d(k, s)), rtol=0, atol=1e-7)


# --- host resize and preprocess_gray -------------------------------------------

RESIZES = [((23, 100), (32, 150)), ((40, 300), (32, 240)), ((32, 256), (32, 256)),
           ((30, 60), (15, 30)), ((7, 9), (32, 41)), ((50, 80), (23, 37)), ((9, 400), (64, 256))]


@pytest.mark.parametrize("cubic", [True, False], ids=["cubic", "linear"])
@pytest.mark.parametrize("shapes", RESIZES, ids=lambda s: f"{s[0]}to{s[1]}")
def test_cv_resize_matches_cv2(shapes, cubic):
    """The port's numpy resize against cv2.resize on f32 images, gray and
    3-channel: within 3e-7 (bit for bit but cubic border pixels, see
    ``test_cv_resize_bit_for_bit_with_cv2``; 3-channel cubic rounds in cv2's
    1-channel order)."""
    cv2 = pytest.importorskip("cv2")
    (h, w), (oh, ow) = shapes
    rng = np.random.default_rng(h * w)
    interp = cv2.INTER_CUBIC if cubic else cv2.INTER_LINEAR
    for img in (rng.uniform(0, 1, (h, w)), rng.uniform(0, 1, (h, w, 3))):
        img = img.astype(np.float32)
        ref = cv2.resize(img, (ow, oh), interpolation=interp)
        np.testing.assert_allclose(pt_img.cv_resize(img, (oh, ow), cubic), ref, rtol=0, atol=3e-7)


def _cv_edges(n_in: int, n_out: int) -> np.ndarray:
    """Outputs of one axis whose 4 cubic taps reach past the image."""
    return pt_img._ipp_cubic_axis(n_in, n_out)[2]


@pytest.mark.parametrize("values", ["uniform", "k255"])
@pytest.mark.parametrize("shapes", RESIZES + [((20, 30), (32, 77)), ((18, 60), (32, 107))],
                         ids=lambda s: f"{s[0]}to{s[1]}")
def test_cv_resize_bit_for_bit_with_cv2(shapes, values):
    """``cv_resize`` against ``cv2.resize`` (OpenCV's IPP build) on f32
    images, uniform or on the k/255 grid: INTER_LINEAR bit for bit, gray and
    3-channel; gray INTER_CUBIC bit for bit wherever the 4x4 taps stay
    inside the image, and within one f32 step at 1.0 (1.2e-7) on at most 8%
    of the outputs whose taps reach past an edge (cv2's border path rounds
    in an order not reproduced here)."""
    cv2 = pytest.importorskip("cv2")
    (h, w), (oh, ow) = shapes
    rng = np.random.default_rng(h * w + 1)
    img = rng.uniform(0, 1, (h, w, 3)) if values == "uniform" else rng.integers(0, 256, (h, w, 3)) / 255
    img = img.astype(np.float32)
    for x in (img[..., 0].copy(), img):
        ref = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(pt_img.cv_resize(x, (oh, ow), False), ref)
    x = img[..., 0].copy()
    ref = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_CUBIC)
    got = pt_img.cv_resize(x, (oh, ow), True)
    edge = _cv_edges(h, oh)[:, None] | _cv_edges(w, ow)[None, :]
    np.testing.assert_array_equal(got[~edge], ref[~edge])
    assert np.abs(got - ref).max() <= 1.2e-7
    assert (got != ref).sum() <= 0.08 * max(edge.sum(), 1)


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c rounded once to f32 (nearest, ties to even), in rationals."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(x))
    near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``fma32`` against the exact sum rounded once: on f64 sums that land on
    the midpoint of two f32 values, exactly or by rounding (where rounding
    the f64 sum to f32 would round twice), below f32's normal range, and on
    uniform values."""
    rng = np.random.default_rng(0)
    n = 100_000
    # products on a 2^-36 grid plus values in [0, 1): many f64 sums on f32 midpoints
    a = rng.integers(1, 1 << 12, n).astype(np.float32) * np.float32(2.0 ** -24)
    b = rng.integers(1, 1 << 12, n).astype(np.float32) * np.float32(2.0 ** -12)
    c = rng.random(n, dtype=np.float32)
    s = a.astype(np.float64) * b + c
    ties = np.nonzero((s.view(np.int64) & ((1 << 29) - 1)) == 1 << 28)[0]
    assert len(ties) > 100
    # a * b = +-2^-24 (1 - j^2 2^-46) against c = 1 + k 2^-23 (scaled): the
    # f64 sum rounds onto the f32 midpoint 1 + k 2^-23 +- 2^-24, where ties
    # to even would pick the wrong side for about half of the k
    j = rng.integers(1, 3, 300).astype(np.float32)
    k = rng.integers(1, 1 << 20, 300).astype(np.float32)
    sign = np.where(rng.random(300) < 0.5, np.float32(-1), np.float32(1))
    e1, e2 = (np.float32(2.0) ** rng.integers(-8, 9, 300).astype(np.float32) for _ in range(2))
    inexact = ((1 + j * np.float32(2.0 ** -23)) * e1,
               sign * np.float32(2.0 ** -24) * (1 - j * np.float32(2.0 ** -23)) * e2,
               (1 + k * np.float32(2.0 ** -23)) * e1 * e2)
    tiny = (rng.random(300, dtype=np.float32) * np.float32(1e-30),
            rng.random(300, dtype=np.float32) * np.float32(1e-10),
            rng.random(300, dtype=np.float32) * np.float32(1e-38))
    uniform = (rng.random(300, dtype=np.float32), rng.random(300, dtype=np.float32) - 0.5,
               rng.random(300, dtype=np.float32))
    for abc in ((a[ties[:400]], b[ties[:400]], c[ties[:400]]), inexact, tiny, uniform):
        got = pt_img.fma32(*abc)
        ref = np.array([_fma_exact(*v) for v in zip(*abc)], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


PREPROCESS = {
    "upscale": ((18, 60), 256, 32, None),
    "downscale": ((70, 200), 256, 32, None),
    "target_w_clipped": ((24, 900), 256, 32, None),
    "h64_canvas": ((22, 100), 256, 64, None),
    "game_id_pad": ((27, 158), 256, 32, 6),
    "float_input": ((25, 70), 128, 32, None),
}


@pytest.mark.parametrize("name", sorted(PREPROCESS))
def test_preprocess_gray_matches_jax(name):
    (h, w), target_w, img_h, pad = PREPROCESS[name]
    rng = np.random.default_rng(len(name))
    crop = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if name == "float_input":
        crop = crop.astype(np.float32) / 255.0
    got = pt_crnn.preprocess_gray(crop, target_w, pad=pad, img_h=img_h)
    ref = jax_crnn.preprocess_gray(crop, target_w, pad=pad, img_h=img_h)
    assert got.shape == ref.shape == (img_h, target_w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.2e-7)


# --- models/crnn.py ------------------------------------------------------------


def test_charset_matches_jax():
    assert pt_crnn.CHARSET == jax_crnn.CHARSET
    assert (pt_crnn.NUM_CLASSES, pt_crnn.BLANK, pt_crnn.IMG_H) == \
        (jax_crnn.NUM_CLASSES, jax_crnn.BLANK, jax_crnn.IMG_H)


def test_gray_conversions_match_jax():
    x = np.random.default_rng(4).uniform(0, 1, (3, 9, 11, 3)).astype(np.float32)
    for pt_fn, jax_fn in ((pt_img.rgb_to_gray, jax_img.rgb_to_gray),
                          (pt_img.bgr_to_gray, jax_img.bgr_to_gray)):
        np.testing.assert_allclose(pt_fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_crnn_narrow_random_matches_jax():
    """A narrow model (hidden 32) from JAX's init, with non-zero biases and
    layer scales: logits within 1e-4."""
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(np.asarray, jax_crnn.init_params(jax.random.PRNGKey(0), hidden=32))
    for p in params.values():
        p["b"] = rng.normal(0, 0.1, p["b"].shape).astype(np.float32)
        if "g" in p:
            p["g"] = rng.uniform(0.5, 1.5, p["g"].shape).astype(np.float32)
    x = rng.uniform(0, 1, (3, 32, 96, 1)).astype(np.float32)
    with torch.inference_mode():
        got = pt_crnn.from_jax_params(params)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_crnn.forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    assert got.shape == ref.shape == (3, 24, pt_crnn.NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("weights,img_h", [("crnn_real_a", 32), ("crnn_h64", 64)])
def test_crnn_checkpoint_matches_jax(weights, img_h):
    """The committed full-width members (hidden 256, 512-channel convs) on
    real canvases of the example's crops: logits within 1e-4."""
    params, meta = load_params(f"weights/{weights}.npz")
    assert int(meta["img_h"]) == img_h
    x = _canvases(30, n=4, h=img_h)[..., None]
    with torch.inference_mode():
        got = pt_crnn.from_jax_params(params)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax_crnn.forward)(jax.tree_util.tree_map(jnp.asarray, params),
                                              jnp.asarray(x)))
    assert got.shape == (4, 64, pt_crnn.NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --- ops/ctc.py -------------------------------------------------------------------

MASKS = {"none": None, "numeric": NUMERIC_ALLOW, "strict_name": STRICT_NAME_ALLOW,
         "card": CARD_ALLOW}


@pytest.mark.parametrize("shared_score", [False, True], ids=["own_score", "shared_score"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_greedy_decode_matches_jax(mask, shared_score):
    """ids exact, confidences within 1e-5, under several allowlist masks, with
    and without a shared score mask."""
    m = jax_ctc.allowlist_mask(MASKS[mask])
    np.testing.assert_array_equal(pt_ctc.allowlist_mask(MASKS[mask]), m)
    sm = jax_ctc.allowlist_mask(None) if shared_score else None
    lg = np.random.default_rng(len(mask)).normal(0, 3, (5, 64, pt_crnn.NUM_CLASSES)).astype(np.float32)
    lg[0, :, 0] += 40.0  # an all-blank row: confidence 0
    ids, conf = pt_ctc.greedy_decode(torch.from_numpy(lg), torch.from_numpy(m),
                                     None if sm is None else torch.from_numpy(sm))
    rid, rconf = jax_ctc.greedy_decode(jnp.asarray(lg), jnp.asarray(m),
                                       None if sm is None else jnp.asarray(sm))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rid))
    np.testing.assert_allclose(conf.numpy(), np.asarray(rconf), rtol=0, atol=1e-5)
    assert float(conf[0]) == 0.0
    for row, rrow in zip(ids.numpy(), np.asarray(rid)):
        assert pt_ctc.decode_to_text(row) == jax_ctc.decode_to_text(rrow)


def _log_probs(seed: int, scale: float, t: int = 64) -> np.ndarray:
    lg = np.random.default_rng(seed).normal(0, scale, (t, pt_crnn.NUM_CLASSES)).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(lg), axis=-1))


@pytest.mark.parametrize("scale", [1.0, 3.0, 8.0], ids=["flat", "mid", "peaked"])
def test_ctc_beam_matches_jax_and_plain(scale):
    """The C++ beam against JAX's prefix_beam_decode and the numpy twin: the
    same prefixes in the same order, scores within 1e-6 relative."""
    for seed in range(4):
        lp = _log_probs(seed, scale)
        got = pt_ctc.prefix_beam_decode(lp)
        for ref in (jax_ctc.prefix_beam_decode(lp), pt_ctc.prefix_beam_decode_plain(lp)):
            assert [p for p, _ in got] == [p for p, _ in ref]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=1e-6)
    assert len(got) == 8


@pytest.mark.parametrize("scale", [1.0, 8.0], ids=["flat", "peaked"])
def test_ctc_score_multi_matches_jax_and_plain(scale):
    for seed in range(3):
        lp = _log_probs(10 + seed, scale)
        cands = [p for p, _ in pt_ctc.prefix_beam_decode(lp)] + [(), (7,), (5, 5), (3, 9, 3, 3)]
        got = pt_ctc.score_candidates(lp, cands)
        np.testing.assert_allclose(got, jax_ctc.score_candidates(lp, cands), rtol=1e-6)
        np.testing.assert_allclose(got, pt_ctc.score_candidates_plain(lp, cands), rtol=1e-6)
        assert got.dtype == np.float32 and got.shape == (len(cands),)


def test_ctc_host_calls_validate_their_inputs():
    lp = _log_probs(0, 3.0)
    with pytest.raises(ValueError, match="candidate ids"):
        native.ctc_score_multi(lp, [(0, 1)])
    with pytest.raises(ValueError, match="T, C"):
        native.ctc_beam(lp[0])


def test_engine_allowlists_match_jax():
    from manual_yolo_tpu_torch.runtime import ocr as pt_ocr

    for name in ("NUMERIC_ALLOW", "NAME_ALLOW", "STRICT_NAME_ALLOW", "CARD_ALLOW",
                 "GAME_ID_ALLOW", "DEFAULT_RECOGNIZER_WEIGHTS"):
        assert getattr(pt_ocr, name) == getattr(jax_ocr, name)
    for cls in ["card1_rank", "game_id", "villian2_bet", "my_stack", "total_pot",
                "iinput_field", "villian3_name", "button_fold"]:
        assert pt_ocr.field_kind(cls) == jax_ocr.field_kind(cls)
    assert pt_ocr.OCREngine.LLM_GATE == jax_ocr.OCREngine.LLM_GATE


# --- the host library's PNG unfilter, and the PNG reader --------------------------


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_matches_plain_twin(bpp):
    """All five filter types (every row a different one, then each type on
    every row) against the plain Python _unfilter."""
    rng = np.random.default_rng(bpp)
    h, w = 11, 13
    for types in (np.arange(h) % 5, *(np.full(h, t) for t in range(5))):
        rows = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
        rows[:, 0] = types
        raw = rows.reshape(-1)
        np.testing.assert_array_equal(native.png_unfilter(raw, h, w * bpp, bpp),
                                      pt_png._unfilter(raw, h, w, bpp).reshape(h, -1))
    rows[3, 0] = 7
    with pytest.raises(ValueError, match="filter type 7 in row 3"):
        native.png_unfilter(rows.reshape(-1), h, w * bpp, bpp)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    v = samples.reshape(h, -1).astype(np.uint8)
    bits = ((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter row y with type y % 5."""
    out, prev = b"", np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows):
        cur = row.astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [np.zeros_like(cur), left, prev, (left + prev) // 2, _paeth(left, prev, upleft)]
        out += bytes([y % 5]) + ((cur - pred[y % 5]) % 256).astype(np.uint8).tobytes()
        prev = cur
    return out


def _encode_png(samples: np.ndarray, color: int, depth: int, interlace: bool = False,
                palette=None) -> bytes:
    """A PNG of (h, w, channels) samples at ``depth`` bits, any colour type."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack(sub, depth), bpp)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


# name: (colour type, bit depth, samples per pixel, interlaced, palette size)
PNG_FORMATS = {
    "palette_8bit": (3, 8, 1, False, 7),
    "palette_2bit": (3, 2, 1, False, 4),
    "gray_8bit": (0, 8, 1, False, 0),
    "gray_1bit": (0, 1, 1, False, 0),
    "gray_4bit": (0, 4, 1, False, 0),
    "gray_16bit": (0, 16, 1, False, 0),
    "gray_alpha_8bit": (4, 8, 2, False, 0),
    "gray_alpha_16bit": (4, 16, 2, False, 0),
    "rgb_16bit": (2, 16, 3, False, 0),
    "rgba_16bit": (6, 16, 4, False, 0),
    "interlaced_rgb_8bit": (2, 8, 3, True, 0),
    "interlaced_gray_4bit": (0, 4, 1, True, 0),
    "interlaced_palette_8bit": (3, 8, 1, True, 5),
    "interlaced_rgba_16bit": (6, 16, 4, True, 0),
}


@pytest.mark.parametrize("name", sorted(PNG_FORMATS))
def test_read_png_matches_cv2_on_every_format(tmp_path, name):
    """Each PNG format, written here with zlib, reads as cv2.imread reads it:
    (H, W, 3) uint8 BGR."""
    cv2 = pytest.importorskip("cv2")
    from manual_yolo_tpu_torch.runtime.shot import imread_bgr

    color, depth, ch, interlace, n_pal = PNG_FORMATS[name]
    rng = np.random.default_rng(len(name))
    h, w = 13, 11
    top = n_pal if color == 3 else 1 << depth
    samples = rng.integers(0, top, (h, w, ch))
    palette = rng.integers(0, 256, (n_pal, 3)) if color == 3 else None
    path = tmp_path / f"{name}.png"
    path.write_bytes(_encode_png(samples, color, depth, interlace, palette))
    ref = cv2.imread(str(path))
    assert ref is not None and ref.shape == (h, w, 3)
    got = imread_bgr(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_read_png_names_the_supported_format(tmp_path):
    jpeg = tmp_path / "shot.jpg"
    jpeg.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
    with pytest.raises(ValueError, match="only PNG files are read"):
        pt_png.read_png(str(jpeg))
    bad = tmp_path / "bad.png"
    body = struct.pack(">IIBBBBB", 4, 4, 8, 5, 0, 0, 0)  # colour type 5 does not exist
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + body + b"\0" * 4)
    with pytest.raises(ValueError, match="colour type 5 at bit depth 8 is not a PNG format"):
        pt_png.read_png(str(bad))


# --- the detector in bf16 against JAX's bf16 ---------------------------------


@pytest.mark.parametrize("name", ["poker_labeled", "seeded_1200x1920"])
def test_process_frame_bf16_matches_jax_bf16(name):
    """The detector in bf16 in both packages, at conf 0.5 (the CLI's): the same
    class list, boxes within 5 px, the same rank text, detections sorted by
    (class, x, y) as tests/test_golden_e2e.py sorts them. At conf 0.25 bf16
    near-ties between two classes flip (JAX's own bf16 and f32 disagree
    there too), so the golden setting is the one held."""
    kw = dict(imgsz=640, conf=0.5, iou=0.7, compute_dtype="bfloat16")
    pt = pt_shot.load_fused_pipeline(DET, CLS, device="cpu", **kw)
    jx = jax_shot.load_fused_pipeline(DET, CLS, **kw)
    frame = pt_shot.imread_bgr(IMAGE) if name == "poker_labeled" else \
        np.random.default_rng(0).integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
    key = lambda d: (d["class_id"], d["bbox"][0], d["bbox"][1])  # noqa: E731
    got, ref = sorted(pt.process_frame(frame), key=key), sorted(jx.process_frame(frame), key=key)
    assert [d["class_name"] for d in got] == [d["class_name"] for d in ref]
    for g, r in zip(got, ref):
        assert np.abs(np.subtract(g["bbox"], r["bbox"])).max() <= 5, (g, r)
        assert g["ocr_text"] == r["ocr_text"], (g, r)
    if name == "poker_labeled":
        assert len(got) >= 10 and sum(bool(d["ocr_text"]) for d in got) >= 2
