"""The NMS kernel's chunked scan, emulated on the CPU, against the greedy keep
mask of the port's plain twin and of the JAX package's Pallas kernel.

``csrc/nms_keep.cu`` runs only on a card; this file holds the same algorithm
in numpy so that an error in its chunk logic shows here: ballots as bit
operations on Python ints, 32 lanes a chunk, the kept boxes dealt to the
warps round robin, the cross-chunk test, the columns inside the chunk and the
serial column resolve, all in f32 in the kernel's operation order, with the
kernel's rule for which pairs skip the division. The cases are those the card
runs in tests/test_torch_gpu.py (tests/torch_nms_cases.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from manual_yolo_tpu.ops.pallas_nms import pallas_nms_keep  # noqa: E402
from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep_plain  # noqa: E402
from test_pallas_nms import _greedy_keep_numpy  # noqa: E402
from torch_nms_cases import NMS_CASES, nms_case  # noqa: E402

F32 = np.float32
LANES = np.arange(32)
KERNEL_WARPS = 16  # csrc/nms_keep.cu's kThreads = 512


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _ballot(pred) -> int:
    return sum(1 << int(lane) for lane in np.flatnonzero(pred))


def _area(box):
    return np.maximum(box[:, 2] - box[:, 0], F32(0)) * np.maximum(box[:, 3] - box[:, 1], F32(0))


def _inter_denom(bj, aj, bi, ai):
    """[j, i]: the IoU's numerator and denominator in the kernel's order,
    inter and area_j + area_i - inter + 1e-7."""
    ix1 = np.maximum(bj[:, None, 0], bi[None, :, 0])
    iy1 = np.maximum(bj[:, None, 1], bi[None, :, 1])
    ix2 = np.minimum(bj[:, None, 2], bi[None, :, 2])
    iy2 = np.minimum(bj[:, None, 3], bi[None, :, 3])
    inter = np.maximum(ix2 - ix1, F32(0)) * np.maximum(iy2 - iy1, F32(0))
    return inter, aj[:, None] + ai[None, :] - inter + F32(1e-7)


def _overlaps(bj, aj, bi, ai, thres):
    """[j, i]: IoU of earlier box j against candidate i above thres, as the
    kernel decides it: a pair with inter <= (0.99 * thres) * denom is below
    the threshold without a division, every other pair takes the division."""
    inter, denom = _inter_denom(bj, aj, bi, ai)
    near_scale = F32(0.99) * thres if thres >= F32(1e-6) else F32(-np.inf)
    return (inter > near_scale * denom) & (inter / denom > thres)


def emulate_kernel(boxes, valid, thres, warps=KERNEL_WARPS):
    """One CTA of ``nms_keep_kernel`` on one frame: (K, 4) f32, (K,) bool -> (K,) bool."""
    k = len(boxes)
    thres = F32(thres)
    box = boxes.astype(F32)
    area = _area(box)

    # stage: one valid word per 32 candidates, and the last valid one
    words = (k + 31) // 32
    valid_bits, last_valid = [], -1
    for w in range(words):
        j = w * 32 + LANES
        bits = _ballot((j < k) & valid[np.minimum(j, k - 1)])
        valid_bits.append(bits)
        if bits:
            last_valid = max(last_valid, w * 32 + bits.bit_length() - 1)
    n = last_valid + 1
    chunks = (n + 31) // 32
    keep = np.zeros(k, bool)  # the tail past the chunks stays zero

    lists = np.zeros((warps, -(-k // warps)), np.int64)  # each warp's kept list
    kept = 0
    for c in range(chunks):
        c0 = c * 32
        i = c0 + LANES
        live = i < n
        bi, ai = box[np.minimum(i, k - 1)], area[np.minimum(i, k - 1)]
        # (a) each warp: its kept boxes against the chunk, then its columns
        hit_words = []
        for w in range(warps):
            owned = (kept - w + warps - 1) // warps if kept > w else 0
            js = lists[w, :owned]
            hit = _overlaps(box[js], area[js], bi, ai, thres).any(axis=0)
            hit_words.append(_ballot(live & hit))
        over = _overlaps(bi, ai, bi, ai, thres)  # [lj, lane], lanes past n are masked
        col_words = [_ballot(live & (lj < LANES) & over[lj]) for lj in range(32)]
        # (b) warp 0: the serial resolve, warp-uniform, then the lists
        pre = 0
        for word in hit_words:
            pre |= word
        alive = valid_bits[c] & ~pre & 0xFFFFFFFF
        for lj in range(32):
            if alive >> lj & 1:
                alive &= ~col_words[lj]
        for lane in range(32):
            if alive >> lane & 1:
                keep[c0 + lane] = True
                ordinal = kept + bin(alive & ((1 << lane) - 1)).count("1")
                lists[ordinal % warps, ordinal // warps] = c0 + lane
        kept += bin(alive).count("1")
    return keep


@pytest.mark.parametrize("case", NMS_CASES)
def test_chunked_scan_matches_plain_and_pallas(case):
    """Bit-exact against nms_keep_plain on every frame, and against the Pallas
    kernel (interpret mode) where valid is a prefix, the Pallas kernel's
    contract (it scans sum(valid) candidates); with holes, against the numpy
    greedy oracle instead."""
    boxes, valid, thres = nms_case(case)
    plain = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thres).numpy()
    for b in range(len(boxes)):
        got = emulate_kernel(boxes[b], valid[b], thres)
        np.testing.assert_array_equal(got, plain[b])
        n_valid = int(valid[b].sum())
        if valid[b, :n_valid].all():
            ref = pallas_nms_keep(jnp.asarray(boxes[b]), jnp.asarray(valid[b]), thres, interpret=True)
        else:
            ref = _greedy_keep_numpy(boxes[b], valid[b], thres)
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_chunked_scan_does_not_depend_on_the_warp_count():
    """The kept boxes are dealt to the warps round robin: 3 warps, which split
    no chunk evenly, give the kernel's mask (a check of the list bookkeeping)."""
    boxes, valid, thres = nms_case("full_chain")
    np.testing.assert_array_equal(
        emulate_kernel(boxes[0], valid[0], thres, warps=3),
        emulate_kernel(boxes[0], valid[0], thres),
    )


def _iou(box):
    """[j, i] f32 IoU of every pair of one frame, in the kernel's order."""
    inter, denom = _inter_denom(box, _area(box), box, _area(box))
    return inter / denom


def _later(m):
    return np.triu(m, 1)  # pairs j < i


CASE_HOLDS = {
    "full_chain": lambda b, v, t: v.all() and v.shape == (1, 512),
    "mixed_b16": lambda b, v, t: v.sum(1).tolist() == [0, 1, 31, 32, 33, 43, 63, 64,
                                                       100, 200, 300, 400, 480, 500, 511, 512],
    "identical": lambda b, v, t: _later(_iou(b[0]) == F32(1)).sum() > 100,
    "zero_area": lambda b, v, t: (_area(b[0]) == 0).sum() > 50,
    "iou_ties": lambda b, v, t: _later(_iou(b[0]) == F32(t)).any(),
    "iou_ulp": lambda b, v, t: _iou(b[0])[0, 1] == np.nextafter(F32(t), F32(1)),
    "non_prefix": lambda b, v, t: all(not r[:r.sum()].all() for r in v),
    **{f"n{n}": (lambda b, v, t, n=n: v.shape == (1, 128) and v.sum() == n == v[0, :n].sum())
       for n in (31, 32, 33, 63)},
}


@pytest.mark.parametrize("case", sorted(CASE_HOLDS))
def test_case_holds_what_it_is_named_for(case):
    """A tie, a last-bit quotient, a hole in valid: a case that lost what it
    is named for would pass the card's test without testing it."""
    boxes, valid, thres = nms_case(case)
    assert boxes.dtype == np.float32 and valid.dtype == bool
    assert CASE_HOLDS[case](boxes, valid, thres)
