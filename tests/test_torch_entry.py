"""The port's one-call frame program (``manual_yolo_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.entry()`` ``fn``, on the CPU;
the port's ``flops_per_image`` against JAX's; ``reset_stage_stats``.

Both programs run on the JAX package's loaded ``poker_detector_n`` and
``rank_classifier_matched`` parameters (the port's models carry them
across) and on the example scaled to the deployment's 1200x1920 frame, as
the serving fleet builds its tables; both detect and classify in bf16. On
the CPU the JAX ``nms`` takes its plain XLA path and the port's
``nms_keep`` its plain twin.

Tolerance, the golden one (``tests/test_golden_e2e.py:61-68``): the same
count and class list, boxes within 5 px, scores within 0.03 (the serving
tick's bf16 margin, ``tests/torch_serve_cases.py``), the same eight rank
rows in the same order. Logits within LOGIT_TOL of JAX's with the same
argmax on the same crops (the port's classifier on crops of the JAX
program's own boxes), every row. The program's own logits: the same argmax
on every row but card1_rank's. The two detectors' bf16 forwards round
otherwise (PERF.md §6) and move the rows' boxes by tenths of a pixel, a
crop a little over; on this frame the classifier reads card1_rank as 9 or
as 4 a fifth of a pixel apart
(``test_card1_rank_read_flips_within_a_fifth_of_a_pixel``), so its read is
held on the same crop only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from manual_yolo_tpu.core.serialization import load_params as jax_load_params  # noqa: E402
from manual_yolo_tpu.models import yolov8 as jax_yolov8  # noqa: E402
from manual_yolo_tpu.ops.pallas_nms import pallas_nms_keep  # noqa: E402
from manual_yolo_tpu.runtime.pipeline import crop_resize_center as jax_crop  # noqa: E402
from manual_yolo_tpu_torch import entry as pt_entry  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8 as pt_yolov8  # noqa: E402
from manual_yolo_tpu_torch.ops import nms as pt_nms  # noqa: E402
from manual_yolo_tpu_torch.ops.image import cv_resize_u8  # noqa: E402
from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep_plain  # noqa: E402
from manual_yolo_tpu_torch.runtime import serving as pt_serving  # noqa: E402
from manual_yolo_tpu_torch.runtime.pipeline import crop_resize_center  # noqa: E402
from torch_loop_cases import CLS, DET_N, example  # noqa: E402

BOX_TOL_PX, SCORE_TOL = 5, 0.03
# bf16 logits, the same crops through both classifiers: four bf16 ulps at
# the logits' scale (0.0625 between 8 and 16); measured 0.13 on the
# example's eight rows, whose logits spread over 11-17
LOGIT_TOL = 0.25
CARD1_RANK = 6


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _frame() -> np.ndarray:
    return cv_resize_u8(example(), pt_entry.SRC_HW)


@pytest.fixture(scope="module")
def programs():
    """Both programs' outputs on the example frame (numpy), the port's keep
    calls, and the pieces the checks reuse."""
    det_params, _ = jax_load_params(DET_N)
    cls_params, _ = jax_load_params(CLS)
    frame = _frame()
    jax_fn, _ = graft.entry()
    ref = jax.jit(jax_fn)(jax_yolov8.fold_params(det_params, pt_entry.DET_SPEC),
                          jax_yolov8.fold_params(cls_params, pt_entry.CLS_SPEC), frame)
    ref = [np.array(o) for o in ref]

    cpu = torch.device("cpu")
    det_model, cls_model = pt_entry.build_models(jax.device_get(det_params),
                                                 jax.device_get(cls_params), cpu)
    calls = []

    def recording(boxes, valid, iou_thres):
        kept = nms_keep_plain(boxes, valid, iou_thres)
        calls.append((boxes.clone(), valid.clone(), iou_thres, kept))
        return kept

    inner = pt_nms.nms_keep
    pt_nms.nms_keep = recording
    try:
        got = pt_entry.make_fn(cpu)(det_model, cls_model, frame)
    finally:
        pt_nms.nms_keep = inner
    got = [o.float().numpy() if o.is_floating_point() else o.numpy() for o in got]
    return {"ref": ref, "got": got, "calls": calls, "frame": frame, "cls_model": cls_model}


def _rank_rows(out) -> np.ndarray:
    """The program's eight classified detections: the rank-class scores in
    descending order, the lower index first on ties, as top_k takes them."""
    rscore = np.where(np.isin(out[2], pt_entry.RANK_IDS), out[1], 0.0)
    return np.argsort(-rscore, kind="stable")[: pt_entry.MAX_RANK]


def test_entry_returns_jax_shapes(programs):
    ref, got = programs["ref"], programs["got"]
    assert [o.shape for o in got] == [o.shape for o in ref] == [(300, 4), (300,), (300,), (), (8, 13)]
    assert got[2].dtype == ref[2].dtype == np.int32 and got[3].dtype == np.int32


def test_entry_detections_match_jax(programs):
    """The same count and class list; each JAX detection paired with the
    nearest port detection of its class: boxes within 5 px, scores within
    0.03; the padding slots empty on both sides."""
    ref, got = programs["ref"], programs["got"]
    n = int(ref[3])
    assert int(got[3]) == n >= 20
    assert sorted(got[2][:n].tolist()) == sorted(ref[2][:n].tolist())
    left = list(range(n))
    for i in range(n):
        same = [j for j in left if got[2][j] == ref[2][i]]
        j = min(same, key=lambda j: np.abs(got[0][j] - ref[0][i]).max())
        assert np.abs(got[0][j] - ref[0][i]).max() <= BOX_TOL_PX, (i, got[0][j], ref[0][i])
        assert abs(got[1][j] - ref[1][i]) <= SCORE_TOL, (i, got[1][j], ref[1][i])
        left.remove(j)
    assert (got[2][n:] == -1).all() and (got[1][n:] == 0).all() and (ref[2][n:] == -1).all()


def test_entry_rank_rows_and_logits_match_jax(programs):
    """The same eight rows in the same order, boxes within 5 px; on the same
    crops (cut from the JAX program's boxes) the port's classifier gives
    JAX's logits within LOGIT_TOL and its argmax on every row; the
    program's own logits give JAX's argmax on every row but card1_rank's."""
    ref, got = programs["ref"], programs["got"]
    ri, gi = _rank_rows(ref), _rank_rows(got)
    assert (got[2][gi] == ref[2][ri]).all()
    assert (np.isin(ref[2][ri], pt_entry.RANK_IDS)).sum() >= 4
    moved = np.abs(got[0][gi] - ref[0][ri]).max(axis=1)
    assert moved.max() <= BOX_TOL_PX

    rgb = programs["frame"][..., ::-1]
    jax_crops = np.stack([np.asarray(jax_crop(jnp.asarray(rgb), jnp.asarray(b), 64, 6.0) / 255.0)
                          for b in ref[0][ri]])
    port_crops = crop_resize_center(torch.from_numpy(rgb.copy()), torch.from_numpy(ref[0][ri]),
                                    64, 6.0) / 255.0
    np.testing.assert_array_equal(port_crops.numpy(), jax_crops)
    with torch.inference_mode():
        same_crops = programs["cls_model"](port_crops).float().numpy()
    assert np.abs(same_crops - ref[4]).max() <= LOGIT_TOL
    assert (same_crops.argmax(1) == ref[4].argmax(1)).all()

    flips = ref[2][ri] == CARD1_RANK
    assert flips.sum() == 1
    assert (got[4][~flips].argmax(1) == ref[4][~flips].argmax(1)).all()


def test_entry_keep_mask_is_one_call_equal_to_plain_and_pallas(programs):
    """One keep-mask call per program call; its mask is nms_keep_plain's and
    the JAX package's Pallas kernel's (interpret mode) on its candidates."""
    calls = programs["calls"]
    assert len(calls) == 1
    boxes, valid, thres, kept = calls[0]
    assert boxes.shape == (1, 512, 4) and thres == 0.7 and int(valid.sum()) > 30
    assert torch.equal(kept, nms_keep_plain(boxes, valid, thres))
    pallas = pallas_nms_keep(jnp.asarray(boxes[0].numpy()), jnp.asarray(valid[0].numpy()), thres,
                             interpret=True)
    np.testing.assert_array_equal(kept[0].numpy(), np.asarray(pallas))
    assert int(kept.sum()) == int(programs["got"][3])


def test_card1_rank_read_flips_within_a_fifth_of_a_pixel(programs):
    """Why rows whose box moved are held on the same crop: card1_rank's box
    from the JAX program, moved down by 0.1 px, still reads 9; moved by
    0.2 px it reads 4, in f32 as in bf16."""
    ref = programs["ref"]
    row = _rank_rows(ref)[0]
    assert ref[2][row] == CARD1_RANK
    cls_params, _ = jax_load_params(CLS)
    f32 = pt_entry.build_models(jax.device_get(jax_load_params(DET_N)[0]), jax.device_get(cls_params),
                                torch.device("cpu"), torch.float32)[1]
    rgb = torch.from_numpy(programs["frame"][..., ::-1].copy())
    reads = {}
    for dy in (0.0, 0.1, 0.2):
        box = torch.from_numpy(ref[0][row]).clone()
        box[1] += dy
        crop = crop_resize_center(rgb, box[None], 64, 6.0) / 255.0
        with torch.inference_mode():
            reads[dy] = (int(f32(crop).argmax()), int(programs["cls_model"](crop).argmax()))
    assert reads == {0.0: (9, 9), 0.1: (9, 9), 0.2: (4, 4)}


def test_entry_runs_from_its_example_args():
    """``entry(device="cpu")``: the committed checkpoints in bf16 and a seeded
    frame; without a card the default device raises."""
    fn, (det_model, cls_model, frame) = pt_entry.entry(device="cpu")
    assert frame.shape == (1200, 1920, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, pt_entry.entry(device="cpu")[1][2])
    assert det_model.compute_dtype == cls_model.compute_dtype == torch.bfloat16
    out = fn(det_model, cls_model, frame)
    assert [tuple(o.shape) for o in out] == [(300, 4), (300,), (300,), (), (8, 13)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pt_entry.entry()


@pytest.mark.parametrize("variant,scale,nc,imgsz", [
    ("detect", "n", 64, 320), ("detect", "n", 64, 640), ("detect", "n", 64, 1280),
    ("detect", "s", 64, 320), ("detect", "s", 64, 640), ("detect", "s", 64, 1280),
    ("classify", "n", 13, 64),
])
def test_flops_per_image_equals_jax(variant, scale, nc, imgsz):
    got = pt_yolov8.flops_per_image(pt_yolov8.build_spec(variant, scale, nc), imgsz)
    ref = jax_yolov8.flops_per_image(jax_yolov8.build_spec(variant, scale, nc), imgsz)
    assert type(got) is int and got == ref


def test_reset_stage_stats_empties_stage_stats():
    """As the JAX package's BatchStream: between a warm-up and a timed window."""
    with pt_serving.load_batch_stream(DET_N, CLS, batch=1, imgsz=192, conf=0.5,
                                      compute_dtype=torch.float32, device="cpu") as s:
        s.submit_batch([_frame()])
        s.collect_batch()
        assert s.stage_stats and s.stage_summary()
        s.reset_stage_stats()
        assert not s.stage_stats and s.stage_summary() == {}
