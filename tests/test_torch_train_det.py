"""PyTorch port vs the JAX package: the detector's training path.

TAL assignment; ``detection_loss`` with its gradients; three train steps
(clip, AdamW, BN update, EMA) against a JAX/optax step; the optimizer state
in the JAX trainer's leaf layout; ``evaluate_detector``'s mAP; resume; the
``train_det`` and ``eval_det`` CLIs on the CPU. YOLOv8n, nc 4, imgsz 64,
f32, unless stated."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.core import serialization as jax_ser  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jy  # noqa: E402
from manual_yolo_tpu.train import data as jdata  # noqa: E402
from manual_yolo_tpu.train import detector as jdet  # noqa: E402
from manual_yolo_tpu.train.ema import ema_update as jax_ema_update  # noqa: E402
from manual_yolo_tpu.train.loss import assign_one as jax_assign_one  # noqa: E402
from manual_yolo_tpu.train.loss import detection_loss as jax_detection_loss  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as py  # noqa: E402
from manual_yolo_tpu_torch.ops.nms import nms_batch  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr  # noqa: E402
from manual_yolo_tpu_torch.train import data as pdata  # noqa: E402
from manual_yolo_tpu_torch.train import detector as pdet  # noqa: E402
from manual_yolo_tpu_torch.train.loss import assign_one, detection_loss  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine  # noqa: E402
from torch_train_cases import REPO, detect_batch, yolo_dataset  # noqa: E402

NC, IMGSZ = 4, 64
LR, WD = 1e-3, 5e-4
WARMUP, TOTAL = 2, 10
DET_N = os.path.join(REPO, "weights", "poker_detector_n.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
EVAL_SZ = 320


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grad_tree(model):
    """The port's gradients as a JAX-layout tree (BN statistics: zero)."""
    twin = pdet._moment_model(model, torch.optim.SGD(model.parameters(), lr=0.0), None)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            q.copy_(p.grad)
    return py.export_params(twin)


@pytest.fixture(scope="module")
def jax_steps():
    """Three JAX/optax detector train steps (the JAX trainer's ``train_step``
    and optimizer chain) from seeded params on one seeded uint8 batch, with
    the first step's loss, aux and gradients."""
    spec = jy.build_spec("detect", "n", NC)
    params = jy.init_params(jax.random.PRNGKey(0), spec)
    sched = optax.warmup_cosine_decay_schedule(LR * 0.01, LR, WARMUP, TOTAL, LR * 0.01)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched, weight_decay=WD))
    x, t, m = detect_batch(2, IMGSZ, 6, NC)

    @jax.jit
    def step_fn(params, ema, opt_state, step, x, t, m):
        def loss_fn(p):
            ctx = jy.BNCtx()
            loss, aux = jax_detection_loss(p, spec, x, t, m, jnp.float32, bn_ctx=ctx)
            return loss, (aux, ctx.updates)

        (loss, (aux, upd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jy.apply_bn_updates(optax.apply_updates(params, updates), upd)
        ema = jax_ema_update(ema, params, step)
        return params, ema, opt_state, loss, aux, grads

    init = _np(params)
    p, ema, opt_state = params, params, tx.init(params)
    out = []
    for s in range(3):
        p, ema, opt_state, loss, aux, grads = step_fn(p, ema, opt_state, jnp.asarray(s, jnp.int32),
                                                      jnp.asarray(x), jnp.asarray(t), jnp.asarray(m))
        out.append({"loss": float(loss), "aux": _np(aux), "grads": _np(grads)})
    return {"init": init, "batch": (x, t, m), "steps": out, "params": _np(p), "ema": _np(ema),
            "opt": [np.asarray(l) for l in jax.tree_util.tree_leaves(opt_state)]}


def _model(tree):
    return py.load_jax_params(py.build_model(py.build_spec("detect", "n", NC), train=True), tree).train()


def _leaves_close(got, ref, rtol, atol, what):
    (lg, tg), (lr, tr) = jax.tree_util.tree_flatten_with_path(got), jax.tree_util.tree_flatten_with_path(ref)
    assert tg == tr
    for (path, a), (_, b) in zip(lg, lr):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} {path}")


def _anchor_grid(n=8, stride=8.0):
    xs = (np.arange(n) + 0.5) * stride
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "no_gt", "shared_anchor"])
def test_assign_one_matches_jax(case):
    """The same foreground mask and target boxes; target scores within 1e-5.
    ``no_gt``: a frame without valid gt; ``shared_anchor``: two gts whose
    boxes cover the same anchors (the highest-overlap gt keeps them)."""
    rng = np.random.default_rng({"random": 0, "no_gt": 1, "shared_anchor": 2}[case])
    anchor = _anchor_grid()
    A, M, nc = len(anchor), 5, 6
    scores = rng.uniform(0.01, 0.99, (A, nc)).astype(np.float32)
    xy = rng.uniform(0, 40, (A, 2))
    pred = np.concatenate([xy, xy + rng.uniform(5, 30, (A, 2))], -1).astype(np.float32)
    gxy = rng.uniform(0, 35, (M, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(10, 30, (M, 2))], -1).astype(np.float32)
    cls = rng.integers(0, nc, M).astype(np.int32)
    mask = np.array([True, True, True, False, True])
    if case == "no_gt":
        mask[:] = False
    if case == "shared_anchor":
        gt[1] = gt[0] + np.array([1, 1, 2, 2], np.float32)
        pred[:] = gt[0]
    ref = jax_assign_one(*(jnp.asarray(a) for a in (scores, pred, anchor, cls, gt, mask)), nc)
    got = assign_one(*(torch.from_numpy(a) for a in (scores, pred, anchor, cls, gt, mask)), nc)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_boxes.numpy(), np.asarray(ref.target_boxes))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores), atol=1e-5)
    if case == "no_gt":
        assert not got.fg_mask.any() and float(got.target_scores.sum()) == 0.0
    else:
        assert got.fg_mask.any()


def test_detection_loss_and_gradients_match_jax(jax_steps):
    """Total and aux within 1e-5 relative; every gradient within 1e-4 of the
    largest absolute gradient. The batch is uint8 (divided by 255 inside);
    the same batch in f32 gives the same loss."""
    x, t, m = jax_steps["batch"]
    ref = jax_steps["steps"][0]
    model = _model(jax_steps["init"])
    loss, aux = detection_loss(model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(m))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(aux[k].detach()), float(ref["aux"][k]), rtol=1e-5, atol=1e-7)
    assert int(aux["num_fg"]) == int(ref["aux"]["num_fg"]) > 0
    scale = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(ref["grads"]))
    _leaves_close(_grad_tree(model), ref["grads"], 0, 1e-4 * scale, "grad")
    model2 = _model(jax_steps["init"])
    loss_f32, _ = detection_loss(model2, torch.from_numpy(x.astype(np.float32) / 255.0),
                                 torch.from_numpy(t), torch.from_numpy(m))
    np.testing.assert_allclose(float(loss_f32), float(loss.detach()), rtol=1e-6)


def test_three_train_steps_match_jax(jax_steps):
    """``detect_step`` three times from JAX's params on its batch: losses
    within 1e-4 relative (the first within 1e-6); params, EMA and BN
    statistics within 3e-4, a tenth of the 3 * lr = 3e-3 that three AdamW
    steps can move a weight (AdamW normalises each gradient, so one at
    rounding level moves its weight by up to lr, whatever its sign), with the
    median leaf within 1e-5; the optimizer state in the JAX trainer's leaf
    layout, counts equal, moments within 1e-3 of the largest (the gradients
    of steps 2 and 3 are taken at the parameters above)."""
    x, t, m = (torch.from_numpy(a) for a in jax_steps["batch"])
    model = _model(jax_steps["init"])
    ema = _model(jax_steps["init"]).eval()
    opt = adamw(model.parameters(), WD)
    sched = warmup_cosine(LR * 0.01, LR, WARMUP, TOTAL, LR * 0.01)
    for s in range(3):
        loss, _ = pdet.detect_step(model, ema, opt, x, t, m, s, sched(s))
        np.testing.assert_allclose(float(loss), jax_steps["steps"][s]["loss"],
                                   rtol=1e-6 if s == 0 else 1e-4)
    for got, ref in ((py.export_params(model), jax_steps["params"]),
                     (py.export_params(ema), jax_steps["ema"])):
        _leaves_close(got, ref, 0, 3e-4, "params")
        gaps = [np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(got),
                                                     jax.tree_util.tree_leaves(ref))]
        assert np.median(gaps) <= 1e-5
    got = pdet.opt_leaves(model, opt)
    ref = jax_steps["opt"]
    assert len(got) == len(ref)
    assert int(got[0]) == int(ref[0]) == 3 and int(got[-1]) == int(ref[-1]) == 3
    n = (len(ref) - 2) // 2
    for part in (slice(1, 1 + n), slice(1 + n, 1 + 2 * n)):
        scale = max(np.abs(r).max() for r in ref[part])
        for a, b in zip(got[part], ref[part]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * scale)


def test_opt_leaves_load_back(jax_steps):
    """``load_opt_leaves`` restores what ``opt_leaves`` wrote: the next step
    of the restored optimizer equals the original's."""
    x, t, m = (torch.from_numpy(a) for a in jax_steps["batch"])
    model = _model(jax_steps["init"])
    ema = _model(jax_steps["init"]).eval()
    opt = adamw(model.parameters(), WD)
    pdet.detect_step(model, ema, opt, x, t, m, 0, 1e-4)
    leaves = pdet.opt_leaves(model, opt)
    model2 = _model(py.export_params(model))
    ema2 = _model(py.export_params(ema)).eval()
    opt2 = adamw(model2.parameters(), WD)
    pdet.load_opt_leaves(model2, opt2, leaves)
    for mod, e, o in ((model, ema, opt), (model2, ema2, opt2)):
        pdet.detect_step(mod, e, o, x, t, m, 1, 2e-4)
    _leaves_close(py.export_params(model2), py.export_params(model), 0, 0, "params")


def _eval_samples():
    """Three frames (the example and two shifted copies); their gt boxes are
    the port's own f32 detections at conf 0.25 of YOLOv8n at imgsz 320."""
    frame = imread_bgr(IMAGE)
    frames = [frame, np.roll(frame, (7, -5), (0, 1)), np.roll(frame, (-4, 9), (0, 1))]
    params, meta = load_params(DET_N)
    spec = py.build_spec("detect", "n", int(meta["spec"]["nc"]))
    model = py.load_jax_params(py.build_model(spec), py.fold_params(params, spec)).eval()
    imgs = pdata.make_eval_batch([pdata.DetectSample(f, np.zeros((0, 4), np.float32),
                                                     np.zeros(0, np.int32)) for f in frames], EVAL_SZ)[0]
    h, w = frame.shape[:2]
    r = min(EVAL_SZ / h, EVAL_SZ / w)
    off = np.array([(EVAL_SZ - round(w * r)) // 2, (EVAL_SZ - round(h * r)) // 2] * 2, np.float32)
    with torch.no_grad():
        det = nms_batch(*py.decode_boxes(model(torch.from_numpy(imgs)), (EVAL_SZ, EVAL_SZ), spec.strides))
    samples = []
    for i, f in enumerate(frames):
        c = int(det.count[i])
        samples.append(pdata.DetectSample(f, (det.boxes[i, :c].numpy() - off) / r,
                                          det.classes[i, :c].numpy().astype(np.int32)))
    return params, spec, samples


def test_evaluate_detector_matches_jax():
    """The same folded params and samples through both packages'
    ``evaluate_detector`` (batch 8, the last padded): mAP within 1e-3."""
    params, spec, samples = _eval_samples()
    assert sum(len(s.boxes) for s in samples) > 20
    got = pdet.evaluate_detector(py.fold_params(params, spec), spec, samples, EVAL_SZ, device="cpu")
    jspec = jy.build_spec("detect", "n", spec.nc)
    jsamples = [jdata.DetectSample(s.image, s.boxes, s.classes) for s in samples]
    ref = jdet.evaluate_detector(jy.fold_params(params, jspec), jspec, jsamples, EVAL_SZ)
    assert got["map50"] > 0.3
    for k in ("map50", "map50_95"):
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got, ref)


def test_detector_trainer_resume(tmp_path):
    """Interrupt a run after 2 epochs, resume to 4: the resumed run starts at
    epoch 3 with optimizer state and best-metric bookkeeping intact, and the
    JAX package reads ``last_n.npz`` with its optimizer leaves in the JAX
    trainer's layout (counterpart of tests/test_train.py's resume test)."""
    yolo_dataset(str(tmp_path))
    out = tmp_path / "runs" / "best.npz"
    base = dict(data_root=str(tmp_path), out_path=str(out), batch=2, imgsz=64, max_boxes=4,
                steps_per_epoch=2, eval_every=1, patience=50, compute_dtype="float32",
                close_mosaic=0, device="cpu")
    pdet.train_detector(pdet.DetTrainConfig(epochs=2, **base), log=lambda s: None)
    last = tmp_path / "runs" / "last_n.npz"
    assert last.exists()
    logs = []
    pdet.train_detector(pdet.DetTrainConfig(epochs=4, resume=True, **base), log=logs.append)
    joined = "\n".join(str(l) for l in logs)
    assert "resumed from" in joined and "epoch 2, step 4" in joined
    assert "epoch 3/4" in joined and "epoch 1/4" not in joined
    ckpt, meta = jax_ser.load_params(str(last), dtype=None)
    assert meta["epoch"] == 4 and meta["step"] == 8
    jspec = jy.build_spec("detect", "n", 2)
    sched = optax.warmup_cosine_decay_schedule(1e-5, 1e-3, 4, 8, 1e-5)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched, weight_decay=WD))
    ref = jax.tree_util.tree_leaves(tx.init(jy.init_params(jax.random.PRNGKey(0), jspec)))
    assert [np.shape(a) for a in ckpt["opt"]] == [np.shape(a) for a in ref]
    assert int(ckpt["opt"][0]) == int(ckpt["opt"][-1]) == 8


def test_train_det_and_eval_det_clis_on_cpu(tmp_path, capsys):
    """``cli.train_det`` and ``cli.eval_det`` with ``--device cpu`` print the
    JAX CLIs' JSON keys; without it, on a host with no card, they raise."""
    from manual_yolo_tpu_torch.cli import eval_det, train_det

    data = yolo_dataset(str(tmp_path / "ds"))
    out = str(tmp_path / "run" / "best.npz")
    common = ["--data", data, "--imgsz", "64"]
    assert train_det.main(common + ["--out", out, "--epochs", "2", "--batch", "2",
                                    "--steps-per-epoch", "1", "--eval-every", "1",
                                    "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.index("{"):])
    assert set(res) == {"best_map50", "best_epoch", "wall_s"} and res["best_epoch"] in (1, 2)
    assert os.path.exists(out)
    assert eval_det.main(common + ["--weights", out, "--split", "valid", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    res = json.loads(printed[printed.index("{"):])
    assert set(res) == {"split", "n_images", "checkpoint_meta", "map50", "map50_95"}
    assert res["n_images"] == 2 and set(res["checkpoint_meta"]) == {"map50", "map50_95", "epoch"}
    if torch.cuda.is_available():
        return
    for call in (lambda: eval_det.main(common + ["--weights", out, "--split", "valid"]),
                 lambda: train_det.main(common + ["--out", out, "--epochs", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
