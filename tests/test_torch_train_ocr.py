"""PyTorch port vs the JAX package: the CRNN trainer (``train/ocr.py``).

The samplers and renders for one seed (every ``kinds`` gate, with and
without a suffix); cv2's INTER_AREA and the gray JPEG round trip; the CTC
loss and its gradient against ``optax.ctc_loss``; three train steps from
JAX's initial parameters against a JAX/optax step (the LSTM bias trained
once); the checkpoint in the JAX ``OCREngine``; ``cli.train_ocr`` on the
CPU. CRNN hidden 32, width 128, f32, unless stated."""

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
from manual_yolo_tpu.models import crnn as jcrnn  # noqa: E402
from manual_yolo_tpu.runtime.ocr import OCREngine as JaxOCREngine  # noqa: E402
from manual_yolo_tpu.train import ocr as jocr  # noqa: E402
from manual_yolo_tpu_torch.cli import train_ocr as cli_train_ocr  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.models import crnn as pcrnn  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_area  # noqa: E402
from manual_yolo_tpu_torch.runtime import truetype  # noqa: E402
from manual_yolo_tpu_torch.runtime.ocr import OCREngine  # noqa: E402
from manual_yolo_tpu_torch.train import ocr as pocr  # noqa: E402
from manual_yolo_tpu_torch.train.optim import adamw, warmup_cosine  # noqa: E402
from torch_train_cases import REPO  # noqa: E402

HIDDEN, WIDTH, BATCH = 32, 128, 6
CRNN_REAL = os.path.join(REPO, "weights", "crnn_real_a.npz")


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


def test_samplers_match():
    """2,000 draws of every sampler give the JAX package's strings, and leave
    the generator in the same state."""
    for fn in ("random_amount", "random_name", "random_game_id", "random_card"):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        assert [getattr(jocr, fn)(a) for _ in range(2000)] == \
            [getattr(pocr, fn)(b) for _ in range(2000)], fn
        assert a.random() == b.random()
    for kinds in (None, frozenset({"name"}), frozenset({"numeric", "card"})):
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        assert [jocr.random_sample(a, kinds) for _ in range(2000)] == \
            [pocr.random_sample(b, kinds) for _ in range(2000)]


def test_area_resize_matches_cv2():
    """``cv_resize_area`` against ``cv2.resize(INTER_AREA)`` on the render's
    shapes: bit for bit where both axes shrink (the general path and the
    integer block means, f32 and f64); within 1e-6 where an axis grows
    (cv2's linear path with area weights, summed in another order), one
    axis shrinking or not."""
    rng = np.random.default_rng(0)
    grow = 0
    for t in range(500):
        h, w = int(rng.integers(14, 50)), int(rng.integers(12, 300))
        sh = int(rng.integers(12, 26))
        sw = max(8, int(w * sh / h))
        if t % 8 == 0 and h >= 24:
            sh, w = h // 2, w + w % 2
            sw = w // 2
        if t % 5 == 1:  # one axis each way, or one kept
            h, w, sh, sw = int(rng.integers(6, 30)), int(rng.integers(4, 12)), int(rng.integers(4, 30)), 12
        img = rng.random((h, w)).astype(np.float64 if t % 3 == 0 else np.float32)
        ref = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_AREA)
        got = cv_resize_area(img, (sh, sw))
        assert got.dtype == ref.dtype
        if sh > h or sw > w:
            grow += 1
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
    assert grow > 100


def test_gray_jpeg_round_trip_matches_cv2():
    rng = np.random.default_rng(1)
    for q in (35, 60, 89):
        arr = np.clip(rng.random((int(rng.integers(20, 40)), int(rng.integers(30, 200)))), 0, 1)
        ok, enc = cv2.imencode(".jpg", (arr * 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, q])
        ref = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
        np.testing.assert_array_equal(pocr.jpeg_round_trip_gray(arr, q), ref)


@pytest.mark.parametrize("kinds,img_h", [("", 32), ("numeric", 32), ("name,game_id", 64),
                                         ("card", 32), ("generic", 32)])
def test_build_pool_matches_jax(kinds, img_h):
    """``build_pool`` of 60 samples: texts, labels and paddings equal; the
    images within 1e-5 on at least 59 of 60 and within 0.01 on all.

    The glyphs are exact (tests/test_torch_truetype.py), and so are cv2's
    f32 linear and cubic resizes (``cv_resize``) but for a few cubic border
    pixels (1.2e-7): where such a pixel sits on a uint8 step before the JPEG
    round trip, its JPEG block changes (1 sample in 60 here, by 0.004)."""
    jc = jocr.OCRTrainConfig(width=WIDTH, img_h=img_h, kinds=kinds)
    pc = pocr.OCRTrainConfig(width=WIDTH, img_h=img_h, kinds=kinds)
    ja = jocr.build_pool(np.random.default_rng(11), jc, 60)
    pa = pocr.build_pool(np.random.default_rng(11), pc, 60)
    assert ja[3] == pa[3]
    np.testing.assert_array_equal(ja[1], pa[1])
    np.testing.assert_array_equal(ja[2], pa[2])
    diff = np.abs(ja[0] - pa[0]).reshape(60, -1).max(axis=1)
    assert (diff <= 1e-5).sum() >= 59, diff
    assert diff.max() <= 0.01, diff.max()
    # with a suffix: the chip and the suffix's glyphs
    if kinds in ("", "numeric"):
        for seed in range(6):
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            a = jocr.render_text(ra, "12.5K", WIDTH, "3,400", img_h)
            b = pocr.render_text(rb, "12.5K", WIDTH, "3,400", img_h)
            assert np.abs(a - b).max() <= 0.05
            assert ra.random() == rb.random()


def test_ctc_loss_matches_optax():
    """Per-sample loss against ``optax.ctc_loss`` (zero logit paddings)
    within 1e-5 relative, its gradient w.r.t. the logits within 1e-4 of the
    largest (f32 log-sum-exps in another order; optax keeps a -1e5 floor
    where torch keeps -inf)."""
    rng = np.random.default_rng(2)
    n, t, c, lmax = 5, 32, pcrnn.NUM_CLASSES, 12
    logits = rng.normal(size=(n, t, c)).astype(np.float32) * 3
    labels = rng.integers(1, c, (n, lmax)).astype(np.int32)
    lens = np.array([12, 1, 7, 3, 10])
    lab_pad = (np.arange(lmax)[None] >= lens[:, None]).astype(np.float32)
    labels[lab_pad > 0] = 0
    labels[0, 4] = labels[0, 3]  # a doubled character
    ref_fn = lambda z: optax.ctc_loss(z, jnp.zeros((n, t)), labels, lab_pad)  # noqa: E731
    ref = np.asarray(ref_fn(logits))
    ref_g = np.asarray(jax.grad(lambda z: jnp.mean(ref_fn(z)))(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = pocr.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(lab_pad))
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=0, atol=1e-4 * np.abs(ref_g).max())


def test_to_jax_params_round_trip():
    """``to_jax_params`` inverts ``from_jax_params`` in both bias layouts, and
    ``for_training`` leaves one trainable bias per LSTM cell."""
    p0 = jax.tree_util.tree_map(np.asarray, jcrnn.init_params(jax.random.PRNGKey(5), HIDDEN))
    p0["lstm_fw1"]["b"] = np.random.default_rng(5).normal(size=4 * HIDDEN).astype(np.float32)
    model = pcrnn.from_jax_params(p0)
    for tree in (pcrnn.to_jax_params(model), pcrnn.to_jax_params(pcrnn.for_training(model))):
        for a, b in zip(jax.tree_util.tree_leaves(p0), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(f"lstm.bias_hh{s}" for s in ("_l0", "_l0_reverse",
                                                                   "_l1", "_l1_reverse"))


def test_init_params_distributions():
    """``init_params`` from a ``torch.Generator``: the JAX tree's shapes,
    bounds and constants, both directions of a layer alike."""
    ref = jcrnn.init_params(jax.random.PRNGKey(0), HIDDEN)
    got = pcrnn.init_params(torch.Generator().manual_seed(0), HIDDEN)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_leaves = jax.tree_util.tree_leaves(got)
    for (path, a), b in zip(ref_leaves, got_leaves):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32, path
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['g']"):
            np.testing.assert_array_equal(b, a)
        else:
            bound = np.abs(a).max()
            assert np.abs(b).max() <= bound * 1.01 and np.abs(b).max() >= bound * 0.9, name
    np.testing.assert_array_equal(got["lstm_fw1"]["wi"], got["lstm_bw1"]["wi"])


def _jax_step(tx):
    @jax.jit
    def step(params, opt_state, imgs, labels, lab_pad):
        def loss_fn(p):
            logits = jcrnn.forward(p, imgs[..., None], jnp.float32)
            per = optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), labels, lab_pad)
            return jnp.mean(per)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return step


def test_three_train_steps_match_jax():
    """Three ``ocr_step``s from JAX's initial parameters against the JAX
    trainer's step (CTC mean, clip 5, optax.adamw over the warmup-cosine
    schedule) on the same pool batches.

    The loss within 1e-5 relative at every step. The first gradient within
    1e-4 of each leaf's largest for the LSTMs, the projection and the last
    two convs, and within 1e-2 for c1-c4: the renders' flat backgrounds give
    2x2 max-pool windows whose values tie or nearly tie (15% of c1's
    windows tie exactly), and convs summed in another order pick another
    winner at a near-tie, moving the gradient there. The parameters after
    every step within 2 x the learning rates summed so far and 1e-6 (AdamW's
    first updates are about lr * sign(g), so a gradient element near 0 that
    the two sides round apart moves by up to that; the weights' own f32
    rounding), and the LSTM biases and the
    projection within 1e-5: a bias trained twice (``bias_ih`` and
    ``bias_hh`` both) would move them by the learning rate."""
    cfg = pocr.OCRTrainConfig(width=WIDTH, hidden=HIDDEN, batch=BATCH, steps=300)
    imgs, labels, lab_pad, _ = pocr.build_pool(np.random.default_rng(0), cfg, 3 * BATCH)
    imgs = (np.clip(imgs[..., 0] * 255 + 0.5, 0, 255).astype(np.uint8)).astype(np.float32) / 255
    p0 = jax.tree_util.tree_map(np.asarray, jcrnn.init_params(jax.random.PRNGKey(0), HIDDEN))
    warm = min(300, cfg.steps // 5)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(cfg.lr * 0.05, cfg.lr, warm, cfg.steps, cfg.lr * 0.02)))
    sched = warmup_cosine(cfg.lr * 0.05, cfg.lr, warm, cfg.steps, cfg.lr * 0.02)
    jstep = _jax_step(tx)
    model = pcrnn.for_training(pcrnn.from_jax_params(p0).train())
    params = [p for p in model.parameters() if p.requires_grad]
    opt = adamw(params, pocr.WEIGHT_DECAY)
    jp, js = p0, tx.init(p0)
    lr_sum = 0.0
    for k in range(3):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        if k == 0:  # the first gradient, before any update
            x = torch.from_numpy(imgs[sl])
            loss0 = pocr.ctc_loss(model(x[..., None]), torch.from_numpy(labels[sl]),
                                  torch.from_numpy(lab_pad[sl])).mean()
            grads = torch.autograd.grad(loss0, params)
        jp, js, jl, jg = jstep(jp, js, jnp.asarray(imgs[sl]), jnp.asarray(labels[sl]),
                               jnp.asarray(lab_pad[sl]))
        loss = pocr.ocr_step(model, opt, params, torch.from_numpy(imgs[sl]),
                             torch.from_numpy(labels[sl]), torch.from_numpy(lab_pad[sl]), sched(k))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        if k == 0:
            named = dict(zip([n for n, p in model.named_parameters() if p.requires_grad], grads))
            got_g = pcrnn.to_jax_params(_with_grads(model, named))
            for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                                    jax.tree_util.tree_leaves(got_g)):
                a, name = np.asarray(a), jax.tree_util.keystr(path)
                rel = 1e-2 if name[:4] in ("['c1", "['c2", "['c3", "['c4") else 1e-4
                np.testing.assert_allclose(b, a, rtol=0, atol=rel * np.abs(a).max(), err_msg=name)
        lr_sum += sched(k)
        got = pcrnn.to_jax_params(model)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves(got)):
            name = jax.tree_util.keystr(path)
            tight = name.endswith("['b']") and "lstm" in name or name.startswith("['proj']")
            np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                       atol=1e-5 if tight else 2 * lr_sum + 1e-6,
                                       err_msg=f"{k} {name}")


def _with_grads(model, named):
    """A copy of ``model`` whose trainable parameters hold ``named`` grads
    (frozen biases zero), for reading them in the JAX layout."""
    clone = pcrnn.CRNN(model.lstm.hidden_size)
    state = {n: (named[n] if n in named else torch.zeros_like(p))
             for n, p in model.state_dict().items()}
    for n in state:
        if "bias_hh" in n:
            hidden = model.lstm.hidden_size
            state[n] = torch.from_numpy(pcrnn._forget_offset(hidden))
    clone.load_state_dict(state)
    return clone


def _field_renders():
    """12 field texts drawn light on a flat dark background (30/255), as the
    engine tests read them; ``names`` their field kinds."""
    texts = ["12,500", "3.5K", "Pot: 740", "$1,250", "0.75M", "48BB",
             "SolemnInflux", "grid44123", "d.fire", "Chrome_7", "IronDream", "acrobat52"]
    crops = []
    for i, t in enumerate(texts):
        font = truetype.truetype(pocr.FONTS[i % 6], 20)
        x0, y0, x1, y1 = font.getbbox(t)
        img = np.full((y1 - y0 + 10, x1 - x0 + 12, 3), 30, np.uint8)
        truetype.draw_text(img, (6 - x0, 5 - y0), t, font, (235, 235, 235))
        crops.append(img)
    return texts, crops, ["villian1_stack"] * 6 + ["villian1_name"] * 6


def test_preprocess_and_variants_match_jax_on_flat_renders():
    """The recognizer canvases (``preprocess_gray`` through the engines'
    ``_pre_batch``) and the four variants against the JAX engine's compiled
    program (``_variants``, jitted and vmapped as the engine runs it) on
    renders whose flat background sits on the k/255 grid, where CLAHE's
    truncating quantiser turns a last-bit difference into another bin:
    canvases equal on "Pot: 740" and on all but a few pixels of the others
    (cv2's cubic border path, see ``cv_resize``); CLAHE, Otsu and the raw
    canvas equal on every render; the rotation at JAX's deskew angle equal
    too, and the port's angle within 1e-7 rad of it (f64 moments on the
    device against XLA's f32 sums). The deskewed variant's CLAHE is not
    held: XLA fuses the rotation into each of CLAHE's uses and rounds it
    there with other fused multiply-adds (ROADMAP.md Queue 3 item 4)."""
    from manual_yolo_tpu.ops import image as jimg
    from manual_yolo_tpu_torch.ops import image as pimg

    texts, crops, names = _field_renders()
    port, jeng = OCREngine.from_npz(CRNN_REAL, device="cpu"), JaxOCREngine.from_npz(CRNN_REAL)
    jvar = jax.jit(jax.vmap(jeng._variants))
    for t, c, name in zip(texts, crops, names):
        kind = "numeric" if "stack" in name else "name"
        g = port._to_gray(c)
        got = np.asarray(port._pre_batch(port._groups_for(kind)[0], [g], kind))
        ref = np.array(jeng._pre_batch(jeng._groups_for(kind)[0], [jeng._to_gray(c)], kind))
        ref = ref.reshape(got.shape)
        assert (got != ref).sum() <= (0 if t == "Pot: 740" else 8), t
        assert np.abs(got - ref).max() <= 1.2e-7, t
        pv = port._variants(torch.from_numpy(ref)).numpy()[0]
        jv = np.asarray(jvar(jnp.asarray(ref)))[0, ..., 0]
        np.testing.assert_array_equal(pv[:3], jv[:3], err_msg=t)
        ang = np.array(jax.jit(jax.vmap(jimg.estimate_skew_angle))(jnp.asarray(ref)))
        np.testing.assert_allclose(pimg.estimate_skew_angle(torch.from_numpy(ref)).numpy(), ang,
                                   rtol=0, atol=1e-7, err_msg=t)
        rot = pimg.rotate_bilinear(torch.from_numpy(ref), torch.from_numpy(ang)).numpy()
        np.testing.assert_array_equal(
            rot, jax.jit(jax.vmap(jimg.rotate_bilinear))(jnp.asarray(ref), jnp.asarray(ang)), err_msg=t)


def test_train_ocr_cli_checkpoint_reads_like_jax(tmp_path, capsys):
    """``cli.train_ocr`` fine-tunes the shipped 32-px member for 2 steps on the
    CPU; its checkpoint carries the JAX trainer's meta, loads in the port's
    and the JAX package's ``load_params`` (equal to ``to_jax_params`` to f16
    rounding), and the JAX ``OCREngine`` reads the same texts from it as the
    port's on 12 clean renders of field texts."""
    out = tmp_path / "crnn.npz"
    assert cli_train_ocr.main([
        "--out", str(out), "--steps", "2", "--batch", "4", "--pool-size", "8",
        "--eval-every", "2", "--lr", "1e-5", "--init-from", CRNN_REAL, "--device", "cpu",
    ]) == 0
    printed = capsys.readouterr().out
    assert set(json.loads(printed[printed.rindex("{"):])) == {"best_exact", "wall_s"}
    params, meta = load_params(str(out))
    jparams, jmeta = jax_load_params(str(out))
    assert meta == jmeta
    assert {"hidden", "width", "img_h", "exact_match", "step"} <= set(meta)
    assert (meta["hidden"], meta["width"], meta["img_h"], meta["step"]) == (256, 256, 32, 2)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    texts, crops, names = _field_renders()
    port, jax_engine = OCREngine.from_npz(str(out), device="cpu"), JaxOCREngine.from_npz(str(out))
    # the engines' default reads, prefix-beam refinement on: the resized
    # canvases are cv2's bits, so CLAHE quantises the flat k/255 backgrounds
    # of these renders into the same bins in both packages
    assert port.beam and jax_engine.beam
    got, ref = port.read_fields_conf(crops, names), jax_engine.read_fields_conf(crops, names)
    assert [p for p, _ in got] == [r for r, _ in ref]
    assert sum(p == t for (p, _), t in zip(got, texts)) >= 6
    np.testing.assert_allclose([c for _, c in got], [c for _, c in ref], rtol=0, atol=1e-3)
