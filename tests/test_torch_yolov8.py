"""PyTorch port vs the JAX package: checkpoint reading, BN folding, the
YOLOv8 detect/classify graphs, box decode and the rank classifier."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core import serialization as jax_ser  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.models.classifier import RankClassifier as JaxRankClassifier  # noqa: E402
from manual_yolo_tpu_torch.core import serialization as pt_ser  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.models.classifier import RankClassifier  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS_WEIGHTS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_bn_params(variant, nc, seed):
    """JAX ``init_params`` with seeded, non-trivial BN statistics (so that
    folding and every bias reach the outputs), as numpy."""
    spec = jy.build_spec(variant, "n", nc)
    params = _numpy_tree(jy.init_params(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)

    def rec(p):
        if isinstance(p, dict):
            if "bn" in p:
                c = p["bn"]["gamma"].shape[0]
                p["bn"] = {
                    "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "beta": rng.normal(0, 0.2, c).astype(np.float32),
                    "mean": rng.normal(0, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
                }
            for v in p.values():
                rec(v)
        elif isinstance(p, list):
            for v in p:
                rec(v)

    rec(params)
    return spec, params


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("variant,scale,nc", [
    ("detect", "n", 64), ("detect", "s", 64), ("classify", "n", 13), ("detect", "m", 7),
])
def test_build_spec_matches_jax(variant, scale, nc):
    assert dataclasses.asdict(py.build_spec(variant, scale, nc)) == \
        dataclasses.asdict(jy.build_spec(variant, scale, nc))


def test_load_params_matches_jax():
    got, gmeta = pt_ser.load_params(CLS_WEIGHTS)
    ref, rmeta = jax_ser.load_params(CLS_WEIGHTS)
    assert gmeta == rmeta
    g, r = _leaves_with_paths(got), _leaves_with_paths(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (_, a), (_, b) in zip(g, r):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_resolve_weight_path_from_any_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert pt_ser.resolve_weight_path("weights/rank_classifier_matched.npz") == CLS_WEIGHTS


def test_fold_params_matches_jax():
    """Host numpy folding vs the JAX package's: within 1e-6 (same formula)."""
    spec, params = _random_bn_params("detect", 64, 0)
    got = py.fold_params(params, spec)
    ref = jy.fold_params(params, spec)
    g, r = _leaves_with_paths(got), _leaves_with_paths(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (_, a), (_, b) in zip(g, r):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("imgsz", [64, 128])
def test_detect_raw_matches_jax(imgsz):
    """f32 raw head outputs (box DFL logits, class logits) within 1e-4."""
    spec, params = _random_bn_params("detect", 64, 1)
    folded = py.fold_params(params, spec)
    x = np.random.default_rng(imgsz).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    ref = jy.forward_detect_raw(jax.tree_util.tree_map(jnp.asarray, folded), spec, jnp.asarray(x))
    model = py.load_jax_params(py.build_model(spec), folded).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert len(got) == 3
    for (gb, gc), (rb, rc) in zip(got, ref):
        assert gb.shape == rb.shape and gc.shape == rc.shape
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("imgsz", [64, 128])
def test_classify_logits_match_jax(imgsz):
    """f32 classify logits within 1e-4."""
    spec, params = _random_bn_params("classify", 13, 2)
    folded = py.fold_params(params, spec)
    x = np.random.default_rng(imgsz).uniform(0, 1, (3, imgsz, imgsz, 3)).astype(np.float32)
    ref = jy.forward_classify(jax.tree_util.tree_map(jnp.asarray, folded), spec, jnp.asarray(x))
    model = py.load_jax_params(py.build_model(spec), folded).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_bf16_model_keeps_f32_heads():
    """Hidden layers run in bf16, the head layers promote to f32 (as JAX)."""
    spec, params = _random_bn_params("detect", 64, 3)
    model = py.load_jax_params(py.build_model(spec, torch.bfloat16), py.fold_params(params, spec))
    assert model.layers[0].conv.weight.dtype == torch.bfloat16
    assert model.layers[0].bias.dtype == torch.bfloat16
    assert model.layers[-1].box[0][2].bias.dtype == torch.float32
    with torch.inference_mode():
        raw = model(torch.rand(1, 64, 64, 3))
    assert all(b.dtype == torch.float32 and c.dtype == torch.float32 for b, c in raw)


def test_load_jax_params_rejects_unfolded_and_incomplete():
    spec, params = _random_bn_params("classify", 13, 4)
    with pytest.raises(ValueError, match="fold"):
        py.load_jax_params(py.build_model(spec), params)
    folded = py.fold_params(params, spec)
    with pytest.raises(ValueError, match="not in the checkpoint"):
        py.load_jax_params(py.build_model(spec), folded[:-1])


def test_decode_boxes_matches_jax():
    """DFL softmax + anchor grid, within 1e-4 px on random raw outputs."""
    rng = np.random.default_rng(8)
    hw = (128, 96)
    raw = []
    for s in (8, 16, 32):
        h, w = hw[0] // s, hw[1] // s
        raw.append((rng.normal(0, 2, (2, h, w, 64)).astype(np.float32),
                    rng.normal(0, 2, (2, h, w, 5)).astype(np.float32)))
    gb, gs = py.decode_boxes([(torch.from_numpy(b), torch.from_numpy(c)) for b, c in raw],
                             hw, (8, 16, 32))
    rb, rs = jy.decode_boxes([(jnp.asarray(b), jnp.asarray(c)) for b, c in raw], hw, (8, 16, 32))
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=0, atol=1e-6)


def test_make_anchors_equal_jax():
    for a, b in zip(py.make_anchors((640, 640), (8, 16, 32)), jy.make_anchors((640, 640), (8, 16, 32))):
        np.testing.assert_array_equal(a, b)


def test_rank_classifier_on_valid_crops_matches_jax():
    """Committed weights on the 67 valid crops of data/rank_matched.npz:
    logits within 1e-4 and the same argmax."""
    with np.load(os.path.join(REPO, "data", "rank_matched.npz")) as z:
        x = z["valid_x"].astype(np.float32) / 255.0
    clf = RankClassifier.from_npz(CLS_WEIGHTS, device="cpu")
    jclf = JaxRankClassifier.from_npz(CLS_WEIGHTS)
    got = clf.logits(torch.from_numpy(x)).numpy()
    ref = np.asarray(jclf.logits(jnp.asarray(x)))
    assert got.shape == (67, 13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert clf.names == jclf.names
    np.testing.assert_allclose(clf.predict_probs(torch.from_numpy(x)).sum(-1).numpy(), 1.0, atol=1e-6)
