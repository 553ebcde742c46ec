"""PyTorch port vs the JAX package: the training pieces of the model.

Checkpoints written by either package and read by the other; the unfolded
tree carried into the train model and back (``load_jax_params``,
``export_params``) and folded; the train-mode forward (batch-statistics BN)
and its running statistics against ``BNCtx`` / ``apply_bn_updates``; CIoU;
the EMA. YOLOv8n at imgsz 64, nc 4 (detect) and 13 (classify)."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core import serialization as jax_ser  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.ops import boxes as jboxes  # noqa: E402
from manual_yolo_tpu.train.ema import ema_update as jax_ema_update  # noqa: E402
from manual_yolo_tpu_torch.core import serialization as pt_ser  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.ops import boxes as pboxes  # noqa: E402
from manual_yolo_tpu_torch.train.ema import ema_tensors, ema_update  # noqa: E402

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _jax_tree(variant, nc, seed):
    """JAX ``init_params`` as numpy, with seeded non-trivial BN statistics."""
    spec = jy.build_spec(variant, "n", nc)
    params = jax.tree_util.tree_map(np.asarray, jy.init_params(jax.random.PRNGKey(seed), spec))
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


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)


def _assert_trees_equal(a, b):
    (la, ta), (lb, tb) = _flat(a), _flat(b)
    assert ta == tb
    for (pa, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, pa
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(pa))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["f16", "f32"])
def test_checkpoints_cross_load_bitwise(tmp_path, writer, dtype):
    """A checkpoint either package writes loads in the other, leaves bitwise
    equal to what the writer's own reader gives, meta equal."""
    _, tree = _jax_tree("classify", 13, 0)
    tree = {"params": tree, "opt": [np.asarray(3, np.int32), (np.arange(4.0, dtype=np.float32),)]}
    meta = {"names": {0: "a"}, "epoch": 2, "spec": {"nc": 13}}
    path = str(tmp_path / "ck.npz")
    kw = {} if dtype == "f16" else {"dtype": None}
    (jax_ser if writer == "jax" else pt_ser).save_params(path, tree, meta=meta, **kw)
    got_j, meta_j = jax_ser.load_params(path, dtype=None)
    got_p, meta_p = pt_ser.load_params(path, dtype=None)
    assert meta_j == meta_p
    _assert_trees_equal(got_j, got_p)
    if dtype == "f32":
        _assert_trees_equal(got_p, tree)


@pytest.mark.parametrize("variant,nc", [("classify", 13), ("detect", 4)])
def test_load_export_round_trip_and_fold(variant, nc):
    """JAX tree -> train model -> ``export_params`` gives the same tree
    bitwise, keys in the same order; folding it equals JAX's fold within 1e-6."""
    spec, tree = _jax_tree(variant, nc, 1)
    model = py.load_jax_params(py.build_model(py.build_spec(variant, "n", nc), train=True), tree)
    back = py.export_params(model)
    _assert_trees_equal(back, tree)
    assert str(jax.tree_util.tree_structure(back)) == str(jax.tree_util.tree_structure(tree))
    ref = jax.tree_util.tree_map(np.asarray, jy.fold_params(tree, spec))
    got = py.fold_params(back, py.build_spec(variant, "n", nc))
    (lr, tr), (lg, tg) = _flat(ref), _flat(got)
    assert tr == tg
    for (p, a), (_, b) in zip(lr, lg):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=str(p))


def test_load_rejects_unfolded_tree_in_inference_model_and_missing_leaves():
    spec, tree = _jax_tree("classify", 13, 2)
    with pytest.raises(ValueError, match="BN is not folded"):
        py.load_jax_params(py.build_model(py.build_spec("classify", "n", 13)), tree)
    del tree[0]["bn"]
    tree[0]["b"] = np.zeros(16, np.float32)
    with pytest.raises(ValueError, match="not in the module|not in the checkpoint"):
        py.load_jax_params(py.build_model(py.build_spec("classify", "n", 13), train=True), tree)


def test_init_params_layout_and_distributions():
    """The port's random init has JAX's tree layout and ranges (its values
    come from a torch.Generator, so they differ from JAX's)."""
    for variant, nc in (("classify", 13), ("detect", 4)):
        jspec = jy.build_spec(variant, "n", nc)
        ref = jax.tree_util.tree_map(np.asarray, jy.init_params(jax.random.PRNGKey(0), jspec))
        got = py.init_params(torch.Generator().manual_seed(0), py.build_spec(variant, "n", nc))
        (lr, tr), (lg, tg) = _flat(ref), _flat(got)
        assert tr == tg
        for (p, a), (_, b) in zip(lr, lg):
            assert a.shape == b.shape and b.dtype == np.float32, p
            if a.ndim == 1:  # BN stats, biases: constants
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=str(p))
            else:
                bound = np.sqrt(6.0 / np.prod(a.shape[:-1])) if a.ndim == 4 else np.sqrt(1 / 1280)
                assert np.abs(b).max() <= bound and np.abs(b).max() > 0.5 * bound, p
        again = py.init_params(torch.Generator().manual_seed(0), py.build_spec(variant, "n", nc))
        _assert_trees_equal(again, got)



@pytest.mark.parametrize("variant,nc", [("classify", 13), ("detect", 4)])
def test_train_forward_and_running_stats_match_bnctx(variant, nc):
    """f32 train-mode forward against JAX with ``BNCtx`` (outputs within
    1e-4), and the running statistics after it against ``apply_bn_updates``
    (within 1e-6)."""
    spec, tree = _jax_tree(variant, nc, 3)
    x = np.random.default_rng(3).uniform(0, 1, (4, IMGSZ, IMGSZ, 3)).astype(np.float32)
    ctx = jy.BNCtx()
    fwd = jy.forward_classify if variant == "classify" else jy.forward_detect_raw
    ref = fwd(tree, spec, jnp.asarray(x), jnp.float32, bn_ctx=ctx)
    ref_stats = jax.tree_util.tree_map(np.asarray, jy.apply_bn_updates(tree, ctx.updates))

    model = py.load_jax_params(py.build_model(py.build_spec(variant, "n", nc), train=True), tree)
    model.train()
    got = model(torch.from_numpy(x))
    if variant == "classify":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    else:
        for (gb, gc), (rb, rc) in zip(got, ref):
            np.testing.assert_allclose(gb.detach().numpy(), np.asarray(rb), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(gc.detach().numpy(), np.asarray(rc), rtol=1e-4, atol=1e-4)
    (lr, _), (lg, _) = _flat(ref_stats), _flat(py.export_params(model))
    for (p, a), (_, b) in zip(lr, lg):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=str(p))


def test_train_bn_on_the_cpu_keeps_f32_accuracy_at_640():
    """The detector's stem (3 -> 16, 3x3 stride 2) in train mode on a seeded
    batch of two 640-px images, 204,800 values a channel: on the CPU the
    block's BN is the JAX ``conv_block``'s arithmetic (PyTorch's CPU kernel,
    summing its statistics in f32 in order, lay 3.8e-5 of the largest output
    from f64 here). Outputs within 1e-6 of the largest of f64's and of
    JAX's; the gradients of a seeded projection within 1e-5 of each leaf's
    largest in f64; the running statistics within 1e-6 of ``BNCtx``'s."""
    spec, tree = _jax_tree("detect", 4, 5)
    x = np.random.default_rng(5).uniform(0, 1, (2, 640, 640, 3)).astype(np.float32)
    ctx = jy.BNCtx()
    ref = np.asarray(jy.conv_block(tree[0], jnp.asarray(x), stride=2, bn_ctx=ctx, path="0"))
    r = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 16, 320, 320)))
    got = {}
    for dtype in (torch.float32, torch.float64):
        model = py.load_jax_params(py.build_model(py.build_spec("detect", "n", 4), train=True), tree)
        blk = model.layers[0].to(dtype).train()
        out = blk(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype))
        grads = torch.autograd.grad((out * r.to(dtype)).sum(), list(blk.parameters()))
        got[dtype] = (out.detach().double(), [g.double() for g in grads], blk.bn)
    out32, g32, bn = got[torch.float32]
    out64, g64, _ = got[torch.float64]
    scale = float(out64.abs().max())
    assert float((out32 - out64).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(out32.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6 * scale)
    for a, b in zip(g32, g64):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    mean, var = (np.asarray(v) for v in ctx.updates["0"])
    np.testing.assert_allclose(bn.running_mean.numpy(), mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), var, rtol=1e-6, atol=1e-6)


def test_train_forward_bf16_loosely_matches_jax_bf16():
    """bf16 train-mode classify forward against the JAX package's bf16 on the
    CPU. JAX takes the BN statistics of the bf16 conv output in bf16; the port
    upcasts that output to f32 first, so the logits agree only to bf16 level:
    within 0.05 of the logit scale (the largest |logit|)."""
    spec, tree = _jax_tree("classify", 13, 4)
    x = np.random.default_rng(4).uniform(0, 1, (8, IMGSZ, IMGSZ, 3)).astype(np.float32)
    ref = np.asarray(jy.forward_classify(tree, spec, jnp.asarray(x), jnp.bfloat16, bn_ctx=jy.BNCtx()))
    model = py.load_jax_params(py.build_model(py.build_spec("classify", "n", 13), torch.bfloat16,
                                              train=True), tree)
    got = model.train()(torch.from_numpy(x)).detach().float().numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def _box_pairs(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (5, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(0, 30, (7, 2))
    b[:, 2:] = b[:, :2] + rng.uniform(0, 30, (5, 2))
    a[0] = [10, 10, 10, 10]  # zero-size
    a[1] = [5, 5, 3, 8]  # inverted x
    b[0] = b[1]  # identical gt boxes
    a[2] = b[2]  # a perfect match
    return a, b


def test_ciou_matches_jax_including_degenerate_boxes():
    """Pairwise and elementwise CIoU against JAX within 1e-6; zero-size and
    inverted boxes included; ``xywh``/``xyxy`` conversions exact."""
    a, b = _box_pairs(5)
    ref = np.asarray(jboxes.pairwise_ciou(jnp.asarray(a), jnp.asarray(b)))
    got = pboxes.pairwise_ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    e_ref = np.asarray(jboxes.elementwise_ciou(jnp.asarray(a[:5]), jnp.asarray(b)))
    e_got = pboxes.elementwise_ciou(torch.from_numpy(a[:5]), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(e_got, e_ref, rtol=1e-6, atol=1e-6)
    batched = pboxes.pairwise_ciou(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[1].numpy(), got)
    np.testing.assert_array_equal(pboxes.xywh_to_xyxy(torch.from_numpy(a)).numpy(),
                                  np.asarray(jboxes.xywh_to_xyxy(jnp.asarray(a))))
    np.testing.assert_array_equal(pboxes.xyxy_to_xywh(torch.from_numpy(a)).numpy(),
                                  np.asarray(jboxes.xyxy_to_xywh(jnp.asarray(a))))


@pytest.mark.parametrize("step", [0, 1, 1000])
def test_ema_update_matches_jax(step):
    """EMA over parameters and BN statistics against JAX's tree map, within
    1e-6; at step 0 the average equals the weights."""
    spec, tree = _jax_tree("classify", 13, 6)
    _, tree2 = _jax_tree("classify", 13, 7)
    ref = jax.tree_util.tree_map(np.asarray, jax_ema_update(tree, tree2, jnp.asarray(step)))
    pspec = py.build_spec("classify", "n", 13)
    ema = py.load_jax_params(py.build_model(pspec, train=True), tree)
    cur = py.load_jax_params(py.build_model(pspec, train=True), tree2)
    ema_update(ema_tensors(ema), ema_tensors(cur), step)
    got = py.export_params(ema)
    (lr, _), (lg, _) = _flat(ref), _flat(got)
    for (p, a), (_, b) in zip(lr, lg):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=str(p))
    if step == 0:
        _assert_trees_equal(got, tree2)
