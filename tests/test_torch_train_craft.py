"""PyTorch port vs the JAX package: the CRAFT trainer (``train/craft.py``).

``render_scene`` and ``render_scene_real`` for one seed; train-mode BN
(outputs and running statistics) against JAX's ``BNCtx`` in f32 and bf16;
three f32 train steps from JAX's initial parameters against the JAX
trainer's step; ``cli.train_craft`` on the CPU. CRAFT at 64x64, batch 2,
unless stated."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core.serialization import load_params as jax_load_params  # noqa: E402
from manual_yolo_tpu.models import craft as jcraft  # noqa: E402
from manual_yolo_tpu.train import craft as jtc  # noqa: E402
from manual_yolo_tpu_torch.cli import train_craft as cli_train_craft  # noqa: E402
from manual_yolo_tpu_torch.models import craft as pcraft  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr  # noqa: E402
from manual_yolo_tpu_torch.train import craft as ptc  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine  # noqa: E402
from torch_train_cases import REPO  # noqa: E402

SIZE, BATCH = 64, 2
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache, and
    its torch ops on two threads (the suite runs six workers on the CPU)."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    threads = torch.get_num_threads()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _tree_close(got, ref, atol, what=""):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=0, atol=atol,
                                   err_msg=what + jax.tree_util.keystr(path))


@pytest.mark.parametrize("size", [256, 128])
def test_render_scene_matches_jax(size):
    """Image, heatmaps and line boxes of 12 scenes equal the JAX package's,
    bit for bit, and the generator ends in the same state."""
    a, b = np.random.default_rng(21), np.random.default_rng(21)
    for _ in range(12):
        ji, jh, jb = jtc.render_scene(a, size)
        pi, ph, pb = ptc.render_scene(b, size)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(ph, jh)
        assert pb == jb
    assert a.random() == b.random()


def _real_pool():
    """Field crops of the example screenshot with their texts (BGR uint8)."""
    img = imread_bgr(EXAMPLE)
    boxes = [((40, 20, 150, 44), "Game ID : 232025507"), ((300, 400, 380, 424), "12,500"),
             ((500, 300, 560, 318), "3.5K"), ((100, 200, 230, 226), "SolemnInflux"),
             ((620, 500, 700, 530), "Pot:3K")]
    return [(np.ascontiguousarray(img[y0:y1, x0:x1]), t) for (x0, y0, x1, y1), t in boxes]


def test_render_scene_real_and_pool_match_jax():
    """``render_scene_real`` on crops of the example (cv2's uint8 linear
    resize), and a mixed ``build_pool``, equal the JAX package's bit for bit."""
    pool = _real_pool()
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(10):
        ji, jh, jb = jtc.render_scene_real(a, pool, SIZE * 2)
        pi, ph, pb = ptc.render_scene_real(b, pool, SIZE * 2)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(ph, jh)
        assert pb == jb
    jcfg = jtc.CraftTrainConfig(pool_size=8, size=SIZE * 2)
    pcfg = ptc.CraftTrainConfig(pool_size=8, size=SIZE * 2)
    ja = jtc.build_pool(np.random.default_rng(6), jcfg, pool)
    pa = ptc.build_pool(np.random.default_rng(6), pcfg, pool)
    for x, y in zip(ja[:2], pa[:2]):
        np.testing.assert_array_equal(y, x)
    assert pa[2] == ja[2]


def test_line_f1_and_iou_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        pred = [tuple(np.sort(rng.integers(0, 64, 4).reshape(2, 2), axis=0).T.reshape(-1))
                for _ in range(int(rng.integers(0, 4)))]
        gt = [tuple(np.sort(rng.integers(0, 64, 4).reshape(2, 2), axis=0).T.reshape(-1))
              for _ in range(int(rng.integers(0, 4)))]
        assert ptc._line_f1(pred, gt) == jtc._line_f1(pred, gt)
        for p in pred:
            for g in gt:
                assert ptc._iou(p, g) == jtc._iou(p, g)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    x, y, _ = ptc.build_pool(rng, ptc.CraftTrainConfig(pool_size=3 * BATCH, size=SIZE))
    q = lambda a: np.clip(a * 255 + 0.5, 0, 255).astype(np.uint8).astype(np.float32) / 255  # noqa: E731
    return q(x), q(y)


@pytest.fixture(scope="module")
def params0():
    return jax.tree_util.tree_map(np.asarray, jcraft.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_bn_matches_jax(batch, params0, dtype):
    """A train-mode forward: the scores and every layer's new running mean and
    variance against JAX's ``BNCtx``. f32: scores within 1e-4 and statistics
    within 1e-5 (relative to 1 + |value|). bf16 (both sides round each conv's
    output to bf16; a rounding apart at one layer moves the next by a bf16
    step): scores within 5e-2 and statistics within 2e-2 relative."""
    x = batch[0][:BATCH]
    cdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ctx = jcraft.BNCtx()
    ref = np.asarray(jcraft.forward(params0, jnp.asarray(x), cdt, bn_ctx=ctx))
    model = pcraft.from_jax_params(params0).train()
    model.compute_dtype = getattr(torch, dtype)
    got = model(torch.from_numpy(x)).detach().numpy()
    tol_s, tol_b = (1e-4, 1e-5) if dtype == "float32" else (5e-2, 2e-2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol_s * (1 + np.abs(ref).max()))
    layers = dict(pcraft._convs(model))
    assert set(ctx.updates) == {p for p, m in layers.items() if m.bn}
    for path, (mean, var) in ctx.updates.items():
        pm, pv = layers[path].pending
        for g, r in ((pm, mean), (pv, var)):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=tol_b, atol=tol_b, err_msg=path)
    pcraft.apply_bn_updates(model)
    tree = pcraft.to_jax_params(model)
    ref_tree = jcraft.apply_bn_updates(params0, ctx.updates)
    _tree_close(tree, ref_tree, atol=tol_b * 10)


def _param_paths(model):
    """(torch parameter, its path in the JAX tree, OIHW <-> HWIO or not)."""
    for path, m in pcraft._convs(model):
        yield m.conv.weight, path + ".w", True
        if m.bn:
            yield m.gamma, path + ".bn.gamma", False
            yield m.beta, path + ".bn.beta", False
        else:
            yield m.conv.bias, path + ".b", False


def _at(tree, path):
    for k in path.split("."):
        tree = tree[int(k)] if k.isdigit() else tree[k]
    return np.asarray(tree, np.float32)


def _load_state(model, opt, params, adam):
    """Put the JAX trainer's parameters and optax Adam state into ``model`` and
    ``opt`` (torch AdamW keeps the same moments and step count)."""
    fresh = pcraft.from_jax_params(params)
    model.load_state_dict(fresh.state_dict())
    for p, path, conv in _param_paths(model):
        mu, nu = _at(adam.mu, path), _at(adam.nu, path)
        if conv:
            mu, nu = mu.transpose(3, 2, 0, 1), nu.transpose(3, 2, 0, 1)
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": torch.from_numpy(np.array(mu, order="C")),
                        "exp_avg_sq": torch.from_numpy(np.array(nu, order="C"))}


def test_three_train_steps_match_jax(batch, params0):
    """Three f32 ``craft_step``s against the JAX trainer's step (MSE, clip 5,
    optax.adamw over the warmup-cosine schedule, BN statistics written after
    the update), each from the state JAX reached (its parameters, running
    statistics and Adam moments loaded into the port), starting from JAX's
    initial parameters.

    Per step: the loss within 1e-5 relative; the running statistics within
    1e-5 (relative to 1 + |value|); every parameter within 2 x that step's
    learning rate and 1e-6, and at most 2% of each leaf's elements more
    than 5% of it apart (measured: 1.6% at most, one of vgg.0's 64 betas).
    AdamW's update is about lr * sign(g) where |g| is small, so an
    element whose gradient the two sides round apart, or that a max-pool
    near-tie routes elsewhere (the scenes' flat backgrounds tie 2x2
    windows), moves by up to that; run freely, such elements feed the next
    step's batch statistics and the two runs drift apart within a few
    steps (in 3 free steps, 77% of vgg.10's weights end more than 1e-6
    apart, all within 2 x the summed learning rates)."""
    x, y = batch
    steps, lr = 300, 5e-4
    warm = min(200, steps // 5)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(lr * 0.05, lr, warm, steps, lr * 0.05)))
    sched = warmup_cosine(lr * 0.05, lr, warm, steps, lr * 0.05)

    @jax.jit
    def jstep(params, opt_state, xb, yb):
        def loss_fn(p):
            ctx = jcraft.BNCtx()
            scores = jcraft.forward(p, xb, jnp.float32, bn_ctx=ctx)
            return jnp.mean((scores - yb) ** 2), ctx.updates

        (loss, bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return jcraft.apply_bn_updates(params, bn), opt_state, loss

    model = pcraft.from_jax_params(params0)
    params = list(model.parameters())
    opt = adamw(params, ptc.WEIGHT_DECAY)
    jp, js = params0, tx.init(params0)
    for k in range(3):
        if k:
            _load_state(model, opt, jp, js[1][0])
        sl = slice(k * BATCH, (k + 1) * BATCH)
        jp, js, jl = jstep(jp, js, jnp.asarray(x[sl]), jnp.asarray(y[sl]))
        loss = ptc.craft_step(model, opt, params, torch.from_numpy(x[sl]),
                              torch.from_numpy(y[sl]), sched(k))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        got = pcraft.to_jax_params(model)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves(got)):
            name, a = jax.tree_util.keystr(path), np.asarray(a)
            if name.endswith("['mean']") or name.endswith("['var']"):
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=f"{k} {name}")
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=2 * sched(k) + 1e-6,
                                           err_msg=f"{k} {name}")
                assert (np.abs(b - a) > 0.05 * sched(k)).mean() <= 0.02, (k, name)


def test_init_params_layout(params0):
    got = pcraft.init_params(torch.Generator().manual_seed(0))
    ref_leaves = jax.tree_util.tree_leaves_with_path(params0)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for (path, a), b in zip(ref_leaves, got_leaves):
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        if "['w']" in name:
            assert 0.9 <= np.abs(b).max() / np.abs(a).max() <= 1.01, name
        else:
            np.testing.assert_array_equal(b, a)


def test_train_craft_cli_end_to_end(tmp_path, capsys):
    """``cli.train_craft`` at 64x64 for 4 steps in bf16 on the CPU: the JAX
    CLI's JSON, a checkpoint in the JAX layout with its meta, running
    statistics moved from their init, and the checkpoint drives the port's
    ``read_region``."""
    out = tmp_path / "craft.npz"
    assert cli_train_craft.main([
        "--out", str(out), "--steps", "4", "--batch", "2", "--size", str(SIZE),
        "--pool-size", "6", "--eval-every", "2", "--device", "cpu",
    ]) == 0
    printed = capsys.readouterr().out
    assert set(json.loads(printed[printed.rindex("{"):])) == {"best_line_f1", "wall_s"}
    params, meta = jax_load_params(str(out))
    assert set(meta) == {"size", "line_f1", "step"} and meta["size"] == SIZE
    assert not np.allclose(params["vgg"][0]["bn"]["mean"], 0)
    assert not np.allclose(params["vgg"][0]["bn"]["var"], 1)
    from manual_yolo_tpu_torch.runtime.ocr import OCREngine

    engine = OCREngine.from_npz(os.path.join(REPO, "weights", "crnn_real_a.npz"),
                                text_detector=str(out), device="cpu")
    img = imread_bgr(EXAMPLE)
    res = engine.read_region(img[100:180, 80:300], "villian1")
    assert isinstance(res, (list, tuple, dict))
