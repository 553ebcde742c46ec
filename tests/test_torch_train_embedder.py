"""PyTorch port vs the JAX package: the re-id embedder trainer.

Instance windows and tracker views (byte for byte and value for value at a
seed), the 3x3 blur against cv2, the NT-Xent loss and the verification AUC,
two f32 train steps against the JAX trainer's step with its projection head
carried over, and ``cli.train_embedder``'s checkpoint in both packages'
``AppearanceEmbedder``s. yolov8n-cls warm-started from the rank classifier,
imgsz 64."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core.serialization import load_params as jax_load_params  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.runtime.embedder import AppearanceEmbedder as JaxEmbedder  # noqa: E402
from manual_yolo_tpu.train import data as jdata  # noqa: E402
from manual_yolo_tpu.train import embedder as jemb  # noqa: E402
from manual_yolo_tpu_torch.cli import train_embedder as cli_train_embedder  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.ops.image import gaussian_blur3_u8  # noqa: E402
from manual_yolo_tpu_torch.runtime.embedder import AppearanceEmbedder  # noqa: E402
from manual_yolo_tpu_torch.train import data as pdata  # noqa: E402
from manual_yolo_tpu_torch.train import embedder as pemb  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import write_png  # noqa: E402
from torch_train_cases import REPO  # noqa: E402

CLS_WEIGHTS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
LR, WD, TEMP = 5e-4, 1e-4, 0.1


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def reid_dataset(root, n_train=3, n_valid=2, seed=0):
    """A YOLO dataset of PNG frames (96x160, random pixels with coloured
    panels), six boxes a frame of three classes, one of them below the
    8-px ``min_box`` and one clipped at the border."""
    rng = np.random.default_rng(seed)
    boxes = [(0, 10, 12, 40, 30), (1, 60, 8, 110, 36), (2, 20, 50, 70, 88),
             (0, 90, 55, 150, 90), (1, 140, 2, 159, 20), (2, 3, 3, 8, 9)]
    for split, n in (("train", n_train), ("valid", n_valid)):
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 255, (96, 160, 3), np.uint8)
            rows = []
            for c, x1, y1, x2, y2 in boxes:
                img[y1:y2, x1:x2] = rng.integers(0, 255, 3, np.uint8)
                img[(y1 + y2) // 2, x1:x2] = 255
                rows.append(f"{c} {(x1 + x2) / 320:.6f} {(y1 + y2) / 192:.6f} "
                            f"{(x2 - x1) / 160:.6f} {(y2 - y1) / 96:.6f}")
            write_png(os.path.join(root, split, "images", f"f{i}.png"), img)
            with open(os.path.join(root, split, "labels", f"f{i}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write("names: ['a', 'b', 'c']\nnc: 3\n")
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return reid_dataset(str(tmp_path_factory.mktemp("reid")))


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 7, 3), (9, 1), (5, 6), (31, 17, 3), (64, 64, 3)])
def test_gaussian_blur3_u8_matches_cv2(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(gaussian_blur3_u8(img), cv2.GaussianBlur(img, (3, 3), 0))


def test_instances_and_views_equal_jax(dataset):
    """The same windows and classes from both packages' loaders; the same
    views, value for value, from the same seed (and the same generator
    state after)."""
    for split in ("train", "valid"):
        w, c = pemb.extract_instances(pdata.load_yolo_split(dataset, split), 8, 0.25, 64)
        jw, jc = jemb.extract_instances(jdata.load_yolo_split(dataset, split), 8, 0.25, 64)
        assert w.dtype == jw.dtype == np.uint8 and w.shape == jw.shape == (len(jc), 128, 128, 3)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(c, jc)
    assert len(c) == 2 * 5  # the 5-px box is skipped
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):  # enough draws to cover the blur and the noise branches
        v, jv = pemb.sample_views(r1, w, 64), jemb.sample_views(r2, jw, 64)
        assert v.dtype == jv.dtype == np.float32
        np.testing.assert_array_equal(v, jv)
    assert r1.random() == r2.random()


def test_nt_xent_and_auc_match_jax():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((12, 16)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    got = float(pemb.nt_xent_loss(torch.from_numpy(z), TEMP))
    ref = float(jemb.nt_xent_loss(jnp.asarray(z), TEMP))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    windows = rng.integers(0, 255, (20, 128, 128, 3), np.uint8)
    classes = rng.integers(0, 3, 20).astype(np.int32)
    proj = rng.standard_normal((64 * 64 * 3, 8)).astype(np.float32)

    def embed(v):
        e = v.reshape(len(v), -1) @ proj
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    got = pemb.verification_auc(embed, windows, classes, 64, np.random.default_rng(5), n_neg=300)
    ref = jemb.verification_auc(embed, windows, classes, 64, np.random.default_rng(5), n_neg=300)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)


def _jax_steps(params, proj, views, sched, n):
    """The JAX trainer's ``train_step`` (``manual_yolo_tpu/train/embedder.py``)
    ``n`` times on ``views``."""
    spec = jy.build_spec("classify", "n", 13)
    tx = optax.adamw(sched, weight_decay=WD)
    state = (jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, proj))
    opt_state = tx.init(state)

    @jax.jit
    def train_step(state, opt_state, views):
        def loss_fn(st):
            p, pr = st
            ctx = jy.BNCtx()
            pooled = jemb._pooled_features(p, spec, views, jnp.float32, bn_ctx=ctx)
            return jemb.nt_xent_loss(jemb._project(pr, pooled), TEMP), ctx.updates

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(state)
        updates, opt_state = tx.update(grads, opt_state, state)
        p, pr = optax.apply_updates(state, updates)
        return (jy.apply_bn_updates(p, upd), pr), opt_state, loss

    losses = []
    for v in views[:n]:
        state, opt_state, loss = train_step(state, opt_state, jnp.asarray(v))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state)


def test_two_train_steps_match_jax(dataset):
    """Two f32 steps from the rank classifier's weights with JAX's projection
    head: losses within 1e-4 relative; every weight, BN statistic and head
    weight within 3e-4 (a tenth of what two AdamW steps at 5e-4 can move a
    weight whose gradient is at rounding level), the median leaf within
    1e-5 (the rule of ``tests/test_torch_train_det.py``'s steps). The unused classify head and
    its BN statistics decay in both."""
    w, _ = pemb.extract_instances(pdata.load_yolo_split(dataset, "train"), 8, 0.25, 64)
    rng = np.random.default_rng(0)
    views = []
    for _ in range(2):
        va, vb = pemb.sample_views(rng, w[:6], 64), pemb.sample_views(rng, w[:6], 64)
        v = np.empty((12, 64, 64, 3), np.float32)
        v[0::2], v[1::2] = va, vb
        views.append(v)
    params, _ = load_params(CLS_WEIGHTS)
    proj = jax.tree_util.tree_map(np.asarray, jemb._init_proj(jax.random.PRNGKey(1), 256, 128))
    jsched = optax.warmup_cosine_decay_schedule(LR * 0.05, LR, 1, 4, LR * 0.02)
    jlosses, (jparams, jproj) = _jax_steps(params, proj, views, jsched, 2)

    spec = py.build_spec("classify", "n", 13)
    model = py.load_jax_params(py.build_model(spec, train=True), params).train()
    head = pemb.ProjectionHead(proj)
    opt = adamw(list(model.parameters()) + list(head.parameters()), WD)
    sched = warmup_cosine(LR * 0.05, LR, 1, 4, LR * 0.02)
    for s, v in enumerate(views):
        loss = float(pemb.embed_step(model, head, opt, torch.from_numpy(v), sched(s), TEMP, WD))
        np.testing.assert_allclose(loss, jlosses[s], rtol=1e-4)
    got = py.export_params(model)
    gl, jl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jparams)
    assert len(gl) == len(jl)
    gaps = [np.abs(a - b).max() for a, b in zip(gl, jl)]
    assert max(gaps) <= 3e-4 and np.median(gaps) <= 1e-5, (max(gaps), np.median(gaps))
    for k in ("w1", "b1", "w2"):
        np.testing.assert_allclose(getattr(head, k).detach().numpy(), jproj[k], rtol=0, atol=3e-4)
    # the classify head took no gradient and decayed twice
    init = jax.tree_util.tree_leaves(params[-1])
    moved = [np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(got[-1]), init)]
    assert max(moved) > 0


def test_cli_checkpoint_loads_and_embeds_in_both_packages(dataset, tmp_path, capsys):
    """``cli.train_embedder`` on the CPU for one epoch: the checkpoint holds
    the JAX trainer's meta, loads in both ``load_params`` (equal trees) and
    embeds equally in both ``AppearanceEmbedder``s (within 1e-5)."""
    out = tmp_path / "reid.npz"
    assert cli_train_embedder.main([
        "--data", dataset, "--out", str(out), "--epochs", "1", "--batch", "4",
        "--init-npz", CLS_WEIGHTS, "--device", "cpu",
    ]) == 0
    printed = capsys.readouterr().out
    metrics = eval(printed.strip().splitlines()[-1])
    assert {"auc_all", "auc_same_class", "pre_auc_all", "pre_auc_same_class"} <= set(metrics)
    params, meta = load_params(str(out))
    jparams, jmeta = jax_load_params(str(out))
    assert meta == jmeta
    assert meta["type"] == "reid_embedder" and meta["objective"] == "nt_xent"
    assert meta["imgsz"] == 64 and meta["spec"] == {"variant": "classify", "scale": "n", "nc": 13}
    assert set(meta["metrics"]) == set(meta["pre_train"]) >= {"auc_all", "auc_same_class"}
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    crops = [np.random.default_rng(i).integers(0, 255, (20 + 7 * i, 30 + 5 * i, 3), np.uint8)
             for i in range(5)]
    got = AppearanceEmbedder.from_npz(str(out), device="cpu")(crops)
    ref = JaxEmbedder.from_npz(str(out))(crops)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
