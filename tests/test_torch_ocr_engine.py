"""The port's OCR engine, CRAFT text detector and single-screenshot OCR pass
against the JAX package, on the CPU, with the committed full-width weights:
the default three-member recognizer ensemble (crnn_real_a, crnn_real_b,
crnn_h64) and craft_real."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.models import craft as jax_craft  # noqa: E402
from manual_yolo_tpu.runtime import ocr as jax_ocr  # noqa: E402
from manual_yolo_tpu.runtime import shot as jax_shot  # noqa: E402
from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.game import taxonomy  # noqa: E402
from manual_yolo_tpu_torch.models import craft as pt_craft  # noqa: E402
from manual_yolo_tpu_torch.runtime import ocr as pt_ocr  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "weights", "poker_detector.npz")
CLS = os.path.join(REPO, "weights", "rank_classifier_matched.npz")
CRAFT = os.path.join(REPO, "weights", "craft_real.npz")
IMAGE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
# the detector finds no game_id on the annotated example: the box its
# annotation draws around "Game ID : 232025507"
GAME_ID_BOX = [850, 25, 1008, 52]
# villains' panels, a name over a stack: two text lines for read_region
PANELS = {"villain5": [1143, 545, 1258, 598], "villain1": [330, 545, 445, 598]}
# a tall crop whose single-line card read fails validation: read_fields_conf
# falls back to CRAFT on it
TALL_BOX = [1143, 545, 1258, 598]
CONF_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache, and
    torch to 2 threads: the suite runs 6 workers on a shared CPU."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    threads = torch.get_num_threads()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def engines():
    """(port engine on the CPU, JAX engine): the default ensemble and CRAFT."""
    pt = pt_ocr.default_ocr_engine(device="cpu")
    jx = jax_ocr.default_ocr_engine()
    # one batch bucket, as the JAX engine's streaming callers pin it: its
    # recognizer then compiles to one program per group and entry point,
    # whatever the kind or the number of crops
    jx.MIN_BUCKET = 8
    assert len(pt._groups) == len(jx._groups) == 2 and pt.craft is not None
    return pt, jx


@pytest.fixture(scope="module")
def frame():
    return pt_shot.imread_bgr(IMAGE)


def _crop(frame, box):
    return pt_shot._safe_crop(frame, box)


@pytest.fixture(scope="module")
def fields(frame):
    """Every OCR-class crop of the example (boxes of the port's f32 pipeline at
    the default conf 0.25) and the game id box: (crops, class names)."""
    pipe = pt_shot.load_fused_pipeline(DET, CLS, conf=0.25, compute_dtype="float32", device="cpu")
    dets = [d for d in pipe.process_frame(frame) if d["class_name"] in taxonomy.OCR_CLASSES]
    crops = [_crop(frame, d["bbox"]) for d in dets] + [_crop(frame, GAME_ID_BOX)]
    return crops, [d["class_name"] for d in dets] + ["game_id"]


def test_read_fields_conf_matches_jax_on_every_field(engines, fields):
    """Identical texts, confidences within 1e-4, no caught error; names,
    stacks, bets, the pot, ranks and the game id are all among the reads."""
    pt, jx = engines
    crops, names = fields
    got, ref = pt.read_fields_conf(crops, names), jx.read_fields_conf(crops, names)
    assert len(names) >= 15
    for name, (t, c), (rt, rc) in zip(names, got, ref):
        assert t == rt, (name, t, rt)
        assert abs(c - rc) <= CONF_TOL, (name, c, rc)
    assert pt.errors == 0
    kinds = {pt_ocr.field_kind(n) for n, (t, _) in zip(names, got) if t}
    assert {"name", "numeric", "card", "game_id"} <= kinds
    assert dict(zip(names, [t for t, _ in got]))["game_id"] == "232025507"


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_read_batch_candidates_match_jax(engines, fields, beam):
    """Every candidate of every name crop (both geometry groups, both masks,
    four variants; with the beam, the rescored pool first), in order."""
    pt, jx = engines
    crops, names = fields
    grays = [pt._to_gray(c) for c, n in zip(crops, names) if pt_ocr.field_kind(n) == "name"]
    got = pt.read_batch_candidates(grays, "name", beam=beam)
    ref = jx.read_batch_candidates(grays, "name", beam=beam)
    for g, r in zip(got, ref):
        assert [t for t, _ in g] == [t for t, _ in r]
        np.testing.assert_allclose([c for _, c in g], [c for _, c in r], rtol=0, atol=CONF_TOL)


def test_read_batch_and_read_field_match_jax(engines, fields):
    pt, jx = engines
    crops, names = fields
    numeric = [(c, n) for c, n in zip(crops, names) if pt_ocr.field_kind(n) == "numeric"]
    grays = [pt._to_gray(c) for c, _ in numeric]
    for (t, c), (rt, rc) in zip(pt.read_batch(grays, "numeric"), jx.read_batch(grays, "numeric")):
        assert t == rt and abs(c - rc) <= CONF_TOL
    crop, name = numeric[0]
    assert pt(crop, name) == jx(crop, name) and pt(crop, name)
    assert pt.read_field(np.zeros((0, 5, 3), np.uint8), name) is None


def test_craft_fallback_matches_jax(engines, frame, monkeypatch):
    """A tall crop whose single-line read fails validation takes the CRAFT
    read_region retry, in both packages, with the same outcome."""
    pt, jx = engines
    calls = []
    real = pt.read_region
    monkeypatch.setattr(pt, "read_region", lambda *a, **k: calls.append(1) or real(*a, **k))
    crops, names = [_crop(frame, TALL_BOX)], ["card1_rank"]
    assert pt.read_fields_conf(crops, names) == jx.read_fields_conf(crops, names)
    assert len(calls) == 1


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_read_region_matches_jax(engines, frame, panel):
    """CRAFT lines of a two-line panel: identical boxes and texts,
    confidences within 1e-4."""
    pt, jx = engines
    crop = _crop(frame, PANELS[panel])
    got, ref = pt.read_region(crop), jx.read_region(crop)
    assert len(got) == 2
    assert [(b, t) for b, t, _ in got] == [(tuple(b), t) for b, t, _ in ref]
    np.testing.assert_allclose([c for *_, c in got], [c for *_, c in ref], rtol=0, atol=CONF_TOL)


def test_read_region_without_text_detector_matches_jax(engines, frame, monkeypatch):
    pt, jx = engines
    monkeypatch.setattr(pt, "craft", None)
    monkeypatch.setattr(jx, "_craft_fwd", None)
    crop = _crop(frame, PANELS["villain1"])
    (box, text, conf), = pt.read_region(crop, min_confidence=0.0)
    (rbox, rtext, rconf), = jx.read_region(crop, min_confidence=0.0)
    assert (box, text) == (tuple(rbox), rtext) and abs(conf - rconf) <= CONF_TOL


def test_read_fields_conf_counts_caught_errors(engines, fields, monkeypatch, capsys):
    """A failing kind stays unread, as in the JAX package, and is counted."""
    pt, _ = engines
    crops, names = fields
    real = pt._run

    def broken(group, batch, kind, logp):
        if kind == "name":
            raise RuntimeError("injected")
        return real(group, batch, kind, logp)

    monkeypatch.setattr(pt, "_run", broken)
    before = pt.errors
    got = pt.read_fields_conf(crops, names)
    assert pt.errors == before + 1
    assert "kind=name" in capsys.readouterr().err
    for name, (t, _) in zip(names, got):
        if pt_ocr.field_kind(name) == "name":
            assert t is None
    assert any(t for (t, _), n in zip(got, names) if pt_ocr.field_kind(n) == "numeric")
    pt.errors = before


# --- models/craft.py ------------------------------------------------------------


@pytest.fixture(scope="module")
def crafts():
    params, _ = load_params(CRAFT)
    return pt_craft.from_jax_params(params), jax_craft.load_npz(CRAFT)


@pytest.mark.parametrize("hw", [(64, 64), (96, 160)], ids=["64x64", "96x160"])
def test_craft_scores_match_jax(crafts, frame, hw):
    """Region/affinity scores on a canvas cut from the example: within 1e-4."""
    pt, jx = crafts
    h, w = hw
    canvas = np.ascontiguousarray(frame[540:540 + h, 1140:1140 + w, ::-1]).astype(np.float32) / 255
    with torch.inference_mode():
        got = pt(torch.from_numpy(canvas[None])).numpy()
    ref = np.asarray(jax.jit(jax_craft.forward)(jx, jnp.asarray(canvas[None])))
    assert got.shape == ref.shape == (1, h // 2, w // 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_craft_rejects_sides_not_multiple_of_32(crafts):
    with pytest.raises(ValueError, match="multiples of 32"):
        crafts[0](torch.zeros(1, 48, 64, 3))


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 7)])
def test_exact_2x_upsampling_matches_jax_resize(hw):
    """CRAFT's skips are exact 2x: there F.interpolate(bilinear,
    align_corners=False) equals jax.image.resize, edge pixels included."""
    h, w = hw
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(np.float32)
    got = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          size=(2 * h, 2 * w), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3), "bilinear"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _score_maps():
    """(h, w, 2) region/affinity maps: touching, diagonal-only and stacked
    components, and a two-line blob that the band split cuts."""
    region = np.zeros((24, 40), np.float32)
    link = np.zeros_like(region)
    region[2:5, 2:6] = 0.9  # two blocks touching edge to edge: one component
    region[2:5, 6:9] = 0.8
    region[7, 12] = 0.95  # diagonal-only neighbours: separate components
    region[8, 13] = 0.95
    region[9, 14] = 0.5
    region[12:14, 2:10] = 0.6  # below text_threshold: dropped
    link[15:17, 20:30] = 0.9  # linked only: never reaches text_threshold
    region[3:8, 25:38] = 0.95  # two lines joined by a weak bridge
    region[8:10, 25:38] = 0.45
    region[10:15, 25:38] = 0.9
    return np.stack([region, link], -1)


@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
def test_text_regions_from_scores_matches_jax(crafts, frame, split):
    """Boxes identical to the JAX package's (cv2 components), on a synthetic
    map and on CRAFT's scores of a panel."""
    pt, _ = crafts
    canvas = np.zeros((128, 128, 3), np.float32)
    canvas[:53, :115] = frame[545:598, 1143:1258, ::-1] / 255.0
    with torch.inference_mode():
        panel = pt(torch.from_numpy(canvas[None])).numpy()[0]
    for scores in (_score_maps(), panel):
        got = pt_craft.text_regions_from_scores(scores, split_lines=split)
        assert got == jax_craft.text_regions_from_scores(scores, split_lines=split)
        assert got


@pytest.mark.parametrize("seed", range(4))
def test_connected_components_match_cv2(seed):
    """4-connected labels numbered in raster order of their first pixel, as
    cv2.connectedComponents numbers them."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(40, 57)) < 0.45 + 0.05 * seed).astype(np.uint8)
    n, labels = pt_craft.connected_components(binary)
    rn, rlabels = cv2.connectedComponents(binary, connectivity=4)
    assert n == rn
    np.testing.assert_array_equal(labels, rlabels)


# --- runtime/shot.py -------------------------------------------------------------


@pytest.fixture(scope="module")
def pipelines():
    kw = dict(imgsz=640, conf=0.5, iou=0.7, compute_dtype="float32")
    return (pt_shot.load_fused_pipeline(DET, CLS, device="cpu", **kw),
            jax_shot.load_fused_pipeline(DET, CLS, **kw))


def test_process_screenshot_with_ocr_matches_jax(engines, pipelines, tmp_path):
    """The default OCR pass (f32 detector, conf 0.5): the same result JSON as
    the JAX package's, but for its time field; names, stacks and a bet are
    filled."""
    (pe, je), (pp, jp) = engines, pipelines
    res_pt = pt_shot.process_screenshot(pp, IMAGE, str(tmp_path / "pt.json"), output_image=None,
                                        ocr=pe, use_llm_fallback=False)
    res_jx = jax_shot.process_screenshot(jp, IMAGE, str(tmp_path / "jx.json"), output_image=None,
                                         ocr=je, use_llm_fallback=False)
    assert json.loads((tmp_path / "pt.json").read_text()) == res_pt
    res_pt.pop("time"), res_jx.pop("time")
    assert res_pt == res_jx
    villains = res_pt["villains"]
    assert sum(bool(v["name"]) for v in villains) >= 3
    assert any(v["stack"] for v in villains) and any(v["bet"] for v in villains)


class _ReadFieldsOnly:
    def read_fields(self, crops, names):
        return [f"{n}:{c.shape[0]}x{c.shape[1]}" for c, n in zip(crops, names)]


@pytest.mark.parametrize("kind", ["read_fields", "callable"])
def test_process_screenshot_ocr_protocols_match_jax(pipelines, tmp_path, kind):
    """An OCR object with only read_fields, or a plain callable, fills the
    same fields in both packages."""
    pp, jp = pipelines
    ocr = _ReadFieldsOnly() if kind == "read_fields" else (
        lambda crop, name: f"{name}:{crop.shape[0]}x{crop.shape[1]}")
    res_pt = pt_shot.process_screenshot(pp, IMAGE, str(tmp_path / "pt.json"), output_image=None,
                                        ocr=ocr, use_llm_fallback=False)
    res_jx = jax_shot.process_screenshot(jp, IMAGE, str(tmp_path / "jx.json"), output_image=None,
                                         ocr=ocr, use_llm_fallback=False)
    res_pt.pop("time"), res_jx.pop("time")
    assert res_pt == res_jx and res_pt["villains"][0]["name"].startswith("villian1_name:")


def test_llm_should_escalate_matches_jax():
    cases = [
        {"class_name": "villian1_name", "ocr_text": ""},
        {"class_name": "villian1_name", "ocr_text": "bob", "ocr_conf": 0.5},
        {"class_name": "villian1_name", "ocr_text": "bob", "ocr_conf": 0.99},
        {"class_name": "total_pot", "ocr_text": "3K", "ocr_conf": -1.0},
        {"class_name": "card1_rank", "ocr_text": "A"},
        {"class_name": "game_id", "ocr_text": "232025507", "ocr_conf": 0.96},
    ]
    for d in cases:
        assert pt_shot.llm_should_escalate(d) == jax_shot.llm_should_escalate(d), d


def test_load_fused_pipeline_rejects_unknown_dtype():
    with pytest.raises(ValueError, match=r"\['bfloat16', 'float32'\].*'float16'"):
        pt_shot.load_fused_pipeline(DET, CLS, compute_dtype="float16", device="cpu")


def test_ocr_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_ocr.default_ocr_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        pt_ocr.OCREngine.from_npz("weights/crnn_real_a.npz")
    assert pt_ocr.default_ocr_engine("weights/no_such_member.npz", device="cpu") is None
