"""PyTorch port vs the JAX package: the ultralytics ``.pt`` import.

``load_torch_checkpoint`` (stub unpickler, fp16 widening, ``ema`` over
``model``), ``import_torch_state`` (classify and detect, folded and not),
``RankClassifier.from_torch_checkpoint`` and ``random_init``, and the loaders
that take a ``.pt`` classifier. The checkpoints are written here by
``tests/torch_pt_cases.py`` (stand-in ultralytics classes, fp16 tensors)."""

import builtins
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core import weights as jax_weights  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.models.classifier import RankClassifier as JaxRankClassifier  # noqa: E402
from manual_yolo_tpu_torch.core import weights as pt_weights  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.models.classifier import RankClassifier  # noqa: E402
from manual_yolo_tpu_torch.runtime.shot import load_fused_pipeline  # noqa: E402

from torch_pt_cases import CLS_NPZ, write_from_npz, write_ultralytics_pt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_N = os.path.join(REPO, "weights", "poker_detector_n.npz")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def pt_dir(tmp_path_factory):
    """The committed rank classifier as .pt files, one per ``ema`` layout."""
    d = tmp_path_factory.mktemp("pt")
    for ema in ("same", "model_off", "none"):
        write_from_npz(str(d / f"rank_{ema}.pt"), ema=ema)
    return d


def _random_bn_params(variant, nc, seed):
    """The port's ``init_params`` with seeded, non-trivial BN statistics."""
    spec = py.build_spec(variant, "n", nc)
    params = py.init_params(torch.Generator().manual_seed(seed), spec)
    rng = np.random.default_rng(seed)

    def rec(p):
        if isinstance(p, dict):
            if "bn" in p:
                c = p["bn"]["gamma"].shape[0]
                p["bn"] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                           "beta": rng.normal(0, 0.2, c).astype(np.float32),
                           "mean": rng.normal(0, 0.2, c).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            for v in p.values():
                rec(v)
        elif isinstance(p, list):
            for v in p:
                rec(v)

    rec(params)
    return spec, params


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (_, a), (_, b) in zip(g, r):
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("ema", ["same", "model_off", "none"])
def test_load_torch_checkpoint_matches_jax(pt_dir, ema):
    """State key for key and array-equal (fp16 widened to f32), names, arch
    and train args equal to the JAX package's; the ``ema`` entry is read when
    it is not None, and its weights are the npz's."""
    path = str(pt_dir / f"rank_{ema}.pt")
    got = pt_weights.load_torch_checkpoint(path)
    ref = jax_weights.load_torch_checkpoint(path)
    assert sorted(got.state) == sorted(ref.state)
    assert len(got.state) == 158 and "model.9.linear.weight" in got.state
    for k in ref.state:
        assert got.state[k].dtype == ref.state[k].dtype == np.float32, k
        np.testing.assert_array_equal(got.state[k], ref.state[k])
    assert got.names == ref.names and len(got.names) == 13
    assert got.arch_yaml == ref.arch_yaml and got.arch_yaml["scale"] == "n"
    assert got.train_args == ref.train_args and got.train_args["task"] == "classify"
    assert (got.raw["ema"] is None) == (ema == "none")
    params, _ = load_params(CLS_NPZ)
    np.testing.assert_array_equal(got.state["model.9.linear.bias"], params[9]["linear"]["b"])
    np.testing.assert_array_equal(got.state["model.0.bn.running_var"], params[0]["bn"]["var"])


def test_load_torch_checkpoint_prefer_ema_off(pt_dir):
    """``prefer_ema=False`` reads ``model`` (perturbed by 0.25 here), as JAX."""
    path = str(pt_dir / "rank_model_off.pt")
    got = pt_weights.load_torch_checkpoint(path, prefer_ema=False)
    ref = jax_weights.load_torch_checkpoint(path, prefer_ema=False)
    ema = pt_weights.load_torch_checkpoint(path)
    for k in ref.state:
        np.testing.assert_array_equal(got.state[k], ref.state[k])
    w = "model.0.conv.weight"
    np.testing.assert_allclose(got.state[w], ema.state[w] + 0.25, atol=2e-3)


class _Reduce:
    """Pickles as a REDUCE of ``fn(*args)``."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("call", ["os.system", "builtins.exec", "builtins.eval"])
def test_reduce_off_the_allow_list_never_runs(tmp_path, package, call):
    """A pickle whose REDUCE calls os.system / exec / eval loads as an inert
    stub in both packages: the command never runs, the weights still load."""
    marker = tmp_path / "ran"
    fn, arg = {
        "os.system": (os.system, f"touch {marker}"),
        "builtins.exec": (builtins.exec, f"open({str(marker)!r}, 'w').write('x')"),
        "builtins.eval": (builtins.eval, f"open({str(marker)!r}, 'w').write('x')"),
    }[call]
    path = str(tmp_path / "evil.pt")
    write_from_npz(path, extra={"payload": _Reduce(fn, arg)})
    load = (pt_weights if package == "port" else jax_weights).load_torch_checkpoint
    ck = load(path)
    assert not marker.exists()
    stub = ck.raw["payload"]
    assert isinstance(stub, (pt_weights._Stub if package == "port" else jax_weights._Stub))
    assert type(stub).__name__ == call.split(".")[1]
    assert len(ck.state) == 158


def test_reduce_of_a_nested_load_never_runs(tmp_path):
    """A REDUCE of ``torch.storage._load_from_bytes`` wrapping a pickle that
    calls os.system: the port stubs it, so the nested pickle is never loaded
    and the command never runs. (The JAX package resolves
    ``_load_from_bytes`` and would run it, so only the port is held here.)"""
    import pickle
    import torch.storage

    marker = tmp_path / "ran"
    nested = pickle.dumps(_Reduce(os.system, f"touch {marker}"))
    path = str(tmp_path / "evil.pt")
    payload = _Reduce(torch.storage._load_from_bytes, nested)
    write_from_npz(path, extra={"payload": payload}, protocol=4)  # bytes as BINBYTES
    ck = pt_weights.load_torch_checkpoint(path)
    assert not marker.exists()
    stub = ck.raw["payload"]
    assert isinstance(stub, pt_weights._Stub) and type(stub).__name__ == "_load_from_bytes"
    assert len(ck.state) == 158


@pytest.mark.parametrize("module,name", [
    ("torch.storage", "_load_from_bytes"), ("torch.serialization", "load"),
    ("torch._tensor", "_rebuild_from_type_v2"), ("torch", "from_file"), ("pickle", "loads"),
])
def test_resolve_refuses_loaders_and_callers(module, name):
    """Nothing that unpickles its argument or calls one resolves in the port."""
    assert pt_weights._resolve_allowed(module, name) is None


@pytest.mark.parametrize("module,name", [
    ("collections", "OrderedDict"), ("builtins", "dict"), ("builtins", "exec"),
    ("builtins", "getattr"), ("posix", "system"), ("os", "system"), ("subprocess", "Popen"),
    ("numpy", "ndarray"), ("numpy._core.multiarray", "_reconstruct"), ("numpy", "load"),
    ("torch._utils", "_rebuild_tensor_v2"), ("torch._utils", "_rebuild_parameter"),
    ("torch", "HalfStorage"), ("torch", "float16"), ("torch", "load"), ("torch.nn.parameter", "Parameter"),
    ("torch.nn.modules.conv", "Conv2d"), ("argparse", "Namespace"), ("pathlib", "PosixPath"),
    ("ultralytics.nn.tasks", "ClassificationModel"),
])
def test_resolve_allowed_matches_jax(module, name):
    """The allow-list resolves the same objects (or refuses them) as JAX's."""
    assert pt_weights._resolve_allowed(module, name) is jax_weights._resolve_allowed(module, name)


def test_from_torch_checkpoint_logits_match_jax(pt_dir):
    """Classify: the .pt classifier's f32 logits within 1e-4 of the JAX
    package's, equal to the port's .npz classifier's, the same names."""
    path = str(pt_dir / "rank_model_off.pt")
    clf = RankClassifier.from_torch_checkpoint(path, device="cpu")
    jclf = JaxRankClassifier.from_torch_checkpoint(path)
    x = np.random.default_rng(0).uniform(0, 1, (5, 64, 64, 3)).astype(np.float32)
    got = clf.logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jclf.logits(jnp.asarray(x))), rtol=0, atol=1e-4)
    npz = RankClassifier.from_npz(CLS_NPZ, device="cpu")
    np.testing.assert_array_equal(got, npz.logits(torch.from_numpy(x)).numpy())
    assert clf.names == jclf.names == npz.names
    assert clf.spec == py.build_spec("classify", "n", 13)


@pytest.mark.parametrize("fold", [True, False])
def test_import_torch_state_detect_matches_jax(tmp_path, fold):
    """Detect: a small YOLOv8n (nc 4) through a .pt: the imported trees are
    array-equal to JAX's, and folded, the raw head outputs within 1e-4."""
    spec, params = _random_bn_params("detect", 4, 7)
    path = str(tmp_path / "det.pt")
    write_ultralytics_pt(path, params, spec, names={i: f"c{i}" for i in range(4)})
    state = pt_weights.load_torch_checkpoint(path).state
    assert "model.22.cv3.2.2.bias" in state and "model.22.dfl.conv.weight" in state
    got = py.import_torch_state(state, spec, fold=fold)
    ref = jy.import_torch_state(jax_weights.load_torch_checkpoint(path).state, jy.build_spec("detect", "n", 4),
                                fold=fold)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, ref))
    if not fold:
        assert "bn" in got[0]
        return
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    raw_ref = jy.forward_detect_raw(ref, spec, jnp.asarray(x))
    model = py.load_jax_params(py.build_model(spec), got).eval()
    with torch.inference_mode():
        raw = model(torch.from_numpy(x))
    for (gb, gc), (rb, rc) in zip(raw, raw_ref):
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-4, atol=1e-4)


def test_import_torch_state_classify_unfolded_matches_jax(pt_dir):
    """``fold=False`` (the trainer's warm start) keeps BN dicts equal to JAX's."""
    path = str(pt_dir / "rank_same.pt")
    spec = py.build_spec("classify", "n", 13)
    got = py.import_torch_state(pt_weights.load_torch_checkpoint(path).state, spec, fold=False)
    ref = jy.import_torch_state(jax_weights.load_torch_checkpoint(path).state,
                                jy.build_spec("classify", "n", 13), fold=False)
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, ref))
    params, _ = load_params(CLS_NPZ)
    _assert_trees_equal(got, params)


def test_missing_key_raises(tmp_path):
    """A .pt without the expected keys raises; nothing falls back."""
    spec, params = _random_bn_params("classify", 13, 3)
    path = str(tmp_path / "small.pt")
    write_ultralytics_pt(path, params, py.build_spec("classify", "n", 13))
    state = pt_weights.load_torch_checkpoint(path).state
    del state["model.9.linear.bias"]
    with pytest.raises(KeyError, match="model.9.linear.bias"):
        py.import_torch_state(state, spec)
    with pytest.raises(KeyError):
        py.import_torch_state(state, py.build_spec("detect", "n", 13))


@pytest.mark.parametrize("scale,nc", [("n", 13), ("s", 5)])
def test_random_init_shapes_match_import(tmp_path, scale, nc):
    """``random_init``'s parameters have the shapes of a .pt import of the
    same spec, and of the JAX package's ``random_init`` (folded); its values
    come from torch's generator, so only the shapes are held."""
    clf = RankClassifier.random_init(scale, nc, generator=torch.Generator().manual_seed(1),
                                     device="cpu")
    spec = py.build_spec("classify", scale, nc)
    assert clf.spec == spec and clf.names == {i: n for i, n in enumerate(
        ["10", "2", "3", "4", "5", "6", "7", "8", "9", "A", "J", "K", "Q"][:nc])}
    params = py.init_params(torch.Generator().manual_seed(2), spec)
    path = str(tmp_path / "c.pt")
    write_ultralytics_pt(path, params, spec)
    imported = py.import_torch_state(pt_weights.load_torch_checkpoint(path).state, spec)
    loaded = py.load_jax_params(py.build_model(spec), imported)
    assert {k: tuple(v.shape) for k, v in clf.model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in loaded.state_dict().items()}
    jclf = JaxRankClassifier.random_init(jax.random.PRNGKey(0), scale, nc)
    jfolded = jy.fold_params(jclf.params, jclf.spec)
    assert [np.shape(a) for _, a in _leaves(jfolded)] == [np.shape(a) for _, a in _leaves(imported)]
    again = RankClassifier.random_init(scale, nc, generator=torch.Generator().manual_seed(1),
                                       device="cpu")
    for a, b in zip(clf.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)


def test_load_fused_pipeline_takes_a_pt(pt_dir):
    """The screenshot loader takes a .pt classifier, as JAX's does: its
    classifier equals the .npz one's; without a card it needs device='cpu'."""
    pt = load_fused_pipeline(DET_N, str(pt_dir / "rank_same.pt"), compute_dtype="float32",
                             device="cpu")
    npz = load_fused_pipeline(DET_N, CLS_NPZ, compute_dtype="float32", device="cpu")
    assert pt.rank_names == npz.rank_names
    a, b = pt.cls_model.state_dict(), npz.cls_model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RankClassifier.from_torch_checkpoint(str(pt_dir / "rank_same.pt"))
