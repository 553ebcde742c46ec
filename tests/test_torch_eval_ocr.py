"""PyTorch port vs the JAX package: the OCR evaluation CLIs
(``cli/eval_ocr.py``, ``cli/eval_craft.py``) on a stand-in labelled set.

The reference's labelled set (``data/ocr_real/labels.json`` over the YOLO
dataset's JPEGs) is not in the repository, so the test writes one with
``chip_smoke.write_ocr_eval_set``: the example screenshot as a JPEG
(``encode_jpeg``) under test/, valid/ and two train/ stems on both sides of
the md5 holdout, YOLO labels of the CPU f32 detections, a data.yaml and a
labels.json in the reference's schema, with a "test2" item. On it the
port's ``load_real_crops``, ``evaluate_real``, ``gate_sweep``,
``load_labeled_images``, ``build_regions``, ``craft_boxes``, ``evaluate``
and both CLIs give the JAX package's results (OCR confidences within 1e-3,
as tests/test_torch_ocr_engine.py holds the engines)."""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("cv2")
pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from manual_yolo_tpu.cli import eval_craft as jec  # noqa: E402
from manual_yolo_tpu.cli import eval_ocr as jeo  # noqa: E402
from manual_yolo_tpu.models import craft as jcraft  # noqa: E402
from manual_yolo_tpu.runtime.ocr import OCREngine as JaxOCREngine  # noqa: E402
from manual_yolo_tpu_torch.cli import eval_craft as pec  # noqa: E402
from manual_yolo_tpu_torch.cli import eval_ocr as peo  # noqa: E402
from manual_yolo_tpu_torch.models import craft as pcraft  # noqa: E402
from manual_yolo_tpu_torch.runtime.ocr import OCREngine  # noqa: E402
from torch_train_cases import REPO  # noqa: E402

CRAFT = os.path.join(REPO, "weights", "craft_real.npz")
CRNN_B = os.path.join(REPO, "weights", "crnn_real_b.npz")
SPLITS = ("test", "test2")
CONF_TOL = 1e-3


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


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ocr_eval"))
    labels = chip_smoke.write_ocr_eval_set(root)
    mp = pytest.MonkeyPatch()
    mp.setattr(jeo, "TEST2", chip_smoke.IMAGE)
    mp.setattr(peo, "TEST2", chip_smoke.IMAGE)
    mp.setattr(jec, "DATASET_ROOT", root)
    mp.setattr(jeo, "load_real_crops", functools.partial(jeo.load_real_crops, dataset_root=root))
    yield root, labels
    mp.undo()


def test_standin_set_schema(standin):
    root, labels = standin
    with open(labels) as f:
        items = json.load(f)["items"]
    srcs = {it["src"] for it in items}
    assert {"test/ex_test", "valid/ex_valid", "test2"} <= srcs
    train = [s.split("/", 1)[1] for s in srcs if s.startswith("train/")]
    assert sorted(peo._train_holdout(s) for s in train) == [False, True]
    assert len(items) > 40


@pytest.mark.parametrize("splits", [None, ("test", "test2"), ("train_fit",), ("train_holdout",),
                                    ("valid", "train_holdout")])
def test_load_real_crops_matches_jax(standin, splits):
    root, labels = standin
    got = list(peo.load_real_crops(labels, root, splits=splits))
    ref = list(jeo.load_real_crops(labels, splits=splits))
    assert len(got) == len(ref) > 0
    for (gc, gn, gt), (rc, rn, rt) in zip(got, ref):
        assert (gn, gt) == (rn, rt)
        np.testing.assert_array_equal(gc, rc)


def test_evaluate_real_and_gate_sweep_match_jax(standin):
    """With one recognizer (``crnn_real_b.npz``; the engines themselves are
    held against each other by tests/test_torch_ocr_engine.py)."""
    root, labels = standin
    got = peo.evaluate_real(OCREngine.from_npz(CRNN_B, device="cpu"), labels, 0.35,
                            splits=SPLITS, dataset_root=root)
    ref = jeo.evaluate_real(JaxOCREngine.from_npz(CRNN_B), labels, 0.35, splits=SPLITS)
    rows, ref_rows = got.pop("rows"), ref.pop("rows")
    assert len(rows) == len(ref_rows) > 10
    for a, b in zip(rows, ref_rows):
        assert {k: v for k, v in a.items() if k != "conf"} == \
            {k: v for k, v in b.items() if k != "conf"}
        assert abs(a["conf"] - b["conf"]) <= CONF_TOL
    assert got == ref
    assert peo.gate_sweep(rows) == jeo.gate_sweep(ref_rows)


def test_labeled_images_and_regions_match_jax(standin):
    root, _ = standin
    for splits in (("test",), ("train", "valid")):
        got = pec.load_labeled_images(splits, root)
        ref = jec.load_labeled_images(splits)
        assert got == ref and got
    for _, fields in got:
        assert pec.build_regions(fields, 1920, 1200) == jec.build_regions(fields, 1920, 1200)


def test_craft_boxes_and_evaluate_match_jax(standin):
    """``craft_boxes`` on the example's regions of two canvas sides, then ``evaluate`` on
    the test split, against the JAX package."""
    root, _ = standin
    img = chip_smoke.imread_bgr(os.path.join(root, "test", "images", "ex_test.jpg"))
    (_, fields), = pec.load_labeled_images(("test",), root)
    regions = pec.build_regions(fields, img.shape[1], img.shape[0])
    model = pcraft.load_npz(CRAFT)
    jparams = jcraft.load_npz(CRAFT)
    fwd = jax.jit(lambda p, x: jcraft.forward(p, x, jnp.float32))
    sides = set()
    for (x1, y1, x2, y2), _ in regions:
        crop = img[y1:y2, x1:x2]
        side = (int(np.clip(max(crop.shape[:2]), 64, 512)) + 31) // 32 * 32
        if side in sides or len(sides) == 2:
            continue
        sides.add(side)
        assert pec.craft_boxes(model, crop) == jec.craft_boxes(fwd, jparams, crop)
    got = pec.evaluate(CRAFT, splits=("test",), device="cpu", dataset_root=root)
    ref = jec.evaluate(CRAFT, splits=("test",))
    assert got == ref and got["regions"] >= 5


def test_eval_clis_run(standin, capsys):
    root, labels = standin
    assert peo.main(["--labels", labels, "--dataset-root", root, "--splits", "test",
                     "--sweep-gates", "--device", "cpu",
                     "--weights", os.path.join(REPO, "weights", "crnn_real_a.npz")]) == 0
    out = capsys.readouterr().out
    res = json.loads(out)
    assert {"exact_match", "n", "per_kind", "llm_escalation", "gate_sweep"} <= set(res)
    assert pec.main(["--weights", CRAFT, "--splits", "test", "--dataset-root", root,
                     "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["regions"] >= 5 and 0 <= res["f1"] <= 1
