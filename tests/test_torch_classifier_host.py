"""PyTorch port vs the JAX package: the classifier's host API.

``preprocess_crop_host`` (PIL's ``Image.BILINEAR`` short-side resize and
centre crop, copied in numpy) bit for bit against the JAX package's, which
calls PIL; ``classify_crops`` (one batched forward, softmax, top-1) against
the JAX package's on rank crops of the committed dataset."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("PIL")

from manual_yolo_tpu.models import classifier as jax_classifier  # noqa: E402
from manual_yolo_tpu_torch.models import classifier as pt_classifier  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS_NPZ = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
MATCHED = os.path.join(REPO, "data", "rank_matched.npz")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


# (h, w): upscales (most rank crops are 20-40 px), downscales (the support
# widens: antialiased), square, exact size, one pixel off, 1xN and Nx1
# extremes, odd sizes
CROP_SHAPES = [
    (20, 14), (33, 25), (40, 30), (31, 17), (64, 64), (63, 63), (65, 64), (64, 65),
    (200, 300), (300, 200), (97, 131), (129, 65), (640, 480), (1, 1), (2, 3), (1, 500),
    (500, 1), (1, 37), (37, 1), (1000, 7), (128, 128), (100, 100),
]


@pytest.mark.parametrize("shape", CROP_SHAPES, ids=[f"{h}x{w}" for h, w in CROP_SHAPES])
def test_preprocess_crop_host_bit_equal_to_jax(shape):
    """float32 (64, 64, 3) arrays equal bit for bit, on seeded noise (every
    sample distinct, so any weight or rounding step shows) and on a slice of
    a real rank crop."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    noise = rng.integers(0, 256, (h, w, 3), np.uint8)
    with np.load(MATCHED) as z:
        crop = z["valid_x"][h % 67][..., ::-1]  # RGB -> BGR
    glyph = cv2.resize(np.ascontiguousarray(crop), (w, h), interpolation=cv2.INTER_LINEAR)
    for x in (noise, glyph):
        got = pt_classifier.preprocess_crop_host(x)
        ref = jax_classifier.preprocess_crop_host(x)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (64, 64, 3)
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("size", [32, 64, 96])
def test_preprocess_crop_host_other_sizes(size):
    x = np.random.default_rng(size).integers(0, 256, (45, 71, 3), np.uint8)
    got = pt_classifier.preprocess_crop_host(x, size)
    np.testing.assert_array_equal(got, jax_classifier.preprocess_crop_host(x, size))


def test_preprocess_crop_host_takes_a_strided_view():
    """A non-contiguous view (a crop of a frame) reads as its copy."""
    frame = np.random.default_rng(3).integers(0, 256, (90, 160, 3), np.uint8)
    view = frame[10:50:2, 30:90]
    np.testing.assert_array_equal(pt_classifier.preprocess_crop_host(view),
                                  jax_classifier.preprocess_crop_host(np.ascontiguousarray(view)))


@pytest.mark.parametrize("bad", [np.zeros((8, 8), np.uint8), np.zeros((8, 8, 3), np.float32),
                                 np.zeros((0, 8, 3), np.uint8), np.zeros((8, 8, 4), np.uint8)])
def test_preprocess_crop_host_rejects_what_is_not_a_bgr_crop(bad):
    with pytest.raises(ValueError, match="uint8 BGR crop"):
        pt_classifier.preprocess_crop_host(bad)


def _rank_crops(n: int, seed: int):
    """Rank glyphs of the committed matched dataset (valid split), resized to
    detector-box sizes of 14 to 48 px, BGR."""
    rng = np.random.default_rng(seed)
    with np.load(MATCHED) as z:
        x = z["valid_x"]
    crops = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(14, 49, 2))
        rgb = x[i % len(x)]
        crops.append(cv2.resize(np.ascontiguousarray(rgb[..., ::-1]), (w, h),
                                interpolation=cv2.INTER_AREA))
    return crops


def test_classify_crops_matches_jax():
    """Names equal to the JAX package's, confidences within 1e-5 (f32), on 40
    crops in one call; an empty list gives an empty list."""
    clf = pt_classifier.RankClassifier.from_npz(CLS_NPZ, device="cpu")
    jclf = jax_classifier.RankClassifier.from_npz(CLS_NPZ)
    crops = _rank_crops(40, 0)
    got = clf.classify_crops(crops)
    ref = jclf.classify_crops(crops)
    assert [n for n, _ in got] == [n for n, _ in ref]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in ref], rtol=0, atol=1e-5)
    assert len({n for n, _ in got}) >= 8
    assert all(isinstance(c, float) and 0 < c <= 1 for _, c in got)
    assert clf.classify_crops([]) == jclf.classify_crops([]) == []


def test_classify_crops_is_one_forward():
    """All crops of a call go through the model once, as one batch."""
    clf = pt_classifier.RankClassifier.from_npz(CLS_NPZ, device="cpu")
    batches = []
    hook = clf.model.register_forward_hook(lambda m, i, o: batches.append(i[0].shape[0]))
    try:
        out = clf.classify_crops(_rank_crops(9, 1))
    finally:
        hook.remove()
    assert batches == [9] and len(out) == 9
