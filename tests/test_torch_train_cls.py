"""PyTorch port vs the JAX package: the rank-classifier trainer.

The learning-rate schedule; the weight-decay split; three train steps
against a JAX/optax step; ``train_classifier`` (through ``cli.train_cls``)
end to end on a small PNG folder dataset on the CPU; the matched dataset.
yolov8n-cls, 13 classes, imgsz 64, f32."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core.serialization import load_params as jax_load_params  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.train import classifier as jcls  # noqa: E402
from manual_yolo_tpu.train.matched_crops import load_matched_dataset as jax_load_matched  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.models.classifier import RankClassifier  # noqa: E402
from manual_yolo_tpu_torch.train import classifier as pcls  # noqa: E402
from manual_yolo_tpu_torch.train.matched_crops import load_matched_dataset, parse_crop_name  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine  # noqa: E402
from torch_train_cases import MATCHED, REPO, rank_folder_dataset  # noqa: E402

CLS_WEIGHTS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
LR, WD = 1e-3, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.mark.parametrize("spe,epochs", [(24, 50), (4, 2), (1, 12)])
def test_learning_rate_matches_optax(spe, epochs):
    """The trainers' schedule for the first 50 updates against
    ``optax.warmup_cosine_decay_schedule`` within 1e-6 relative (f32
    arithmetic on both sides; the cosine's last bit can differ)."""
    total = spe * epochs
    warmup = min(int(3.0 * spe), max(total // 3, 1))
    ref = optax.warmup_cosine_decay_schedule(LR * 0.01, LR, warmup, total, LR * 0.01)
    got = warmup_cosine(LR * 0.01, LR, warmup, total, LR * 0.01)
    for k in range(min(50, total + 2)):
        np.testing.assert_allclose(got(k), float(ref(k)), rtol=1e-6)


def _torch_name(path) -> str:
    """A JAX tree path -> the port's parameter (or buffer) name."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    head, leaf = [str(k) for k in keys[:-1]], keys[-1]
    if leaf == "w":
        name = head + (["weight"] if head[-1] == "linear" else ["conv", "weight"])
    elif leaf == "b":
        name = head + ["bias"]
    else:
        name = head[:-1] + ["bn", {"gamma": "weight", "beta": "bias", "mean": "running_mean",
                                    "var": "running_var"}[leaf]]
    return "layers." + ".".join(name)


def test_decay_groups_match_partition_decay():
    """The decayed parameters are ``_partition_decay``'s "decay" leaves, leaf
    for leaf; every other parameter is in the undecayed group."""
    spec = jy.build_spec("classify", "n", 13)
    params = jy.init_params(jax.random.PRNGKey(0), spec)
    labels = jax.tree_util.tree_flatten_with_path(jcls._partition_decay(params))[0]
    want = {_torch_name(p) for p, l in labels if l == "decay"}
    model = py.build_model(py.build_spec("classify", "n", 13), train=True)
    names = {id(p): n for n, p in model.named_parameters()}
    decay, no_decay = pcls.decay_groups(model, WD)
    assert decay["weight_decay"] == WD and no_decay["weight_decay"] == 0.0
    assert {names[id(p)] for p in decay["params"]} == want
    assert len(decay["params"]) + len(no_decay["params"]) == len(names)
    assert all(n.endswith("weight") and ".bn." not in n for n in want)


@pytest.fixture(scope="module")
def crops():
    z = np.load(MATCHED)
    x = z["train_x"][:16].astype(np.float32) / 255.0
    return x, z["train_y"][:16].astype(np.int32)


def test_three_classifier_steps_match_jax(crops):
    """Three train steps from the committed checkpoint on the same crops
    (batch 16) against the JAX trainer's ``train_step`` and
    ``multi_transform`` of two AdamWs: losses within 1e-4 relative (the
    checkpoint is confident, loss 0.27, so the f32 logits' 1e-5-level gaps
    show in the cross-entropy), weights within 2e-4 (three steps at lr 1e-3
    move a weight by up to 3e-3) and BN statistics within 5e-5."""
    x, y = crops
    params, _ = jax_load_params(CLS_WEIGHTS)
    spec = jy.build_spec("classify", "n", 13)
    sched = optax.warmup_cosine_decay_schedule(LR * 0.01, LR, 2, 10, LR * 0.01)
    tx = optax.multi_transform({"decay": optax.adamw(sched, weight_decay=WD),
                                "no_decay": optax.adamw(sched, weight_decay=0.0)},
                               jcls._partition_decay(params))

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            ctx = jy.BNCtx()
            logits = jy.forward_classify(p, spec, x, jnp.float32, bn_ctx=ctx)
            return jnp.mean(optax.softmax_cross_entropy(logits, jax.nn.one_hot(y, 13))), ctx.updates

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jy.apply_bn_updates(optax.apply_updates(params, updates), upd), opt_state, loss

    model = py.load_jax_params(py.build_model(py.build_spec("classify", "n", 13), train=True),
                               params).train()
    opt = adamw(pcls.decay_groups(model, WD), WD)
    lr = warmup_cosine(LR * 0.01, LR, 2, 10, LR * 0.01)
    p, s = params, tx.init(params)
    for k in range(3):
        p, s, loss = step(p, s, jnp.asarray(x), jnp.asarray(y))
        got = pcls.classify_step(model, opt, torch.from_numpy(x), torch.from_numpy(y), lr(k))
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-4)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, p))[0]
    out = jax.tree_util.tree_leaves(py.export_params(model))
    for (path, r), g in zip(ref, out):
        tol = 5e-5 if getattr(path[-1], "key", None) in ("mean", "var") else 2e-4
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=str(path))


def test_warm_start_reads_the_matched_valid_split():
    """The committed checkpoint in the train model, BN on its running
    statistics (the trainer's ``evaluate``), reads 64 of the 67 matched valid
    crops: the checkpoint's own ``top1_matched``."""
    params, meta = load_params(CLS_WEIGHTS)
    model = py.load_jax_params(py.build_model(py.build_spec("classify", "n", 13), train=True), params)
    data, _ = load_matched_dataset(MATCHED)
    top1, top5 = pcls.evaluate(model, *data["valid"], torch.device("cpu"))
    assert round(top1 * 67) == 64 and top1 == pytest.approx(meta["top1_matched"], abs=1e-4)
    assert top5 >= top1


def test_cli_train_cls_end_to_end_on_cpu(tmp_path, capsys):
    """``cli.train_cls --device cpu`` on a 13-class PNG folder dataset, warm
    started: the JAX CLI's JSON keys, the checkpoint's meta keys, the
    artifacts beside it; the checkpoint loads in ``RankClassifier``; a .pt
    warm start and ``--build-matched`` raise ``NotImplementedError``."""
    from manual_yolo_tpu_torch.cli import train_cls

    root, names = rank_folder_dataset(str(tmp_path / "ds"), per_class=(3, 1))
    out = str(tmp_path / "run" / "best.npz")
    argv = ["--data", root, "--out", out, "--epochs", "2", "--batch", "8", "--device", "cpu"]
    assert train_cls.main(argv + ["--init-from-npz", CLS_WEIGHTS]) == 0
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.index("{"):])
    assert set(res) == {"best_top1", "best_epoch", "wall_s"}
    params, meta = load_params(out)
    assert set(meta) == {"names", "spec", "top1", "top5", "epoch"}
    assert meta["names"] == {str(i): n for i, n in enumerate(names)}
    assert meta["spec"] == {"variant": "classify", "scale": "n", "nc": 13}
    for f in ("args.json", "results.csv", "confusion_matrix.csv"):
        assert os.path.exists(tmp_path / "run" / f), f
    with open(tmp_path / "run" / "results.csv") as f:
        assert f.readline().strip() == "epoch,train_loss,top1,top5,top1_matched"
    cm = np.loadtxt(tmp_path / "run" / "confusion_matrix.csv", delimiter=",", skiprows=1)
    assert cm.shape == (13, 13) and cm.sum() == 13
    clf = RankClassifier.from_npz(out, device="cpu")
    assert clf.logits(torch.zeros(2, 64, 64, 3)).shape == (2, 13)
    jparams, _ = jax_load_params(out)
    assert len(jax.tree_util.tree_leaves(jparams)) == len(jax.tree_util.tree_leaves(params))
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        train_cls.main(argv + ["--init-from", "x.pt"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cls.main(argv + ["--build-matched", root])


def test_matched_dataset_matches_jax(tmp_path):
    """``load_matched_dataset`` on ``data/rank_matched.npz`` equals JAX's;
    ``save_matched_dataset`` round-trips; crop names parse as in JAX."""
    from manual_yolo_tpu.train.matched_crops import parse_crop_name as jax_parse
    from manual_yolo_tpu_torch.train.matched_crops import save_matched_dataset

    got, names = load_matched_dataset(MATCHED)
    ref, ref_names = jax_load_matched(MATCHED)
    assert names == ref_names and len(names) == 13 and set(got) == set(ref) == {"train", "valid"}
    for k in got:
        for a, b in zip(got[k], ref[k]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(got["train"][0]) == 1536 and len(got["valid"][0]) == 67
    z = np.load(MATCHED)
    path = str(tmp_path / "m.npz")
    save_matched_dataset(path, valid=(z["valid_x"], z["valid_y"], names))
    back, back_names = load_matched_dataset(path)
    assert back_names == names
    np.testing.assert_array_equal(back["valid"][0], got["valid"][0])
    for name in ("img_01_a_rank_3.jpg", "x_y_10_rank_0.png", "nope.jpg", "a_b_rank_x.jpg"):
        assert parse_crop_name(name) == jax_parse(name)
