"""Named keep-mask cases shared by the NMS kernel's tests: the card runs them
through the CUDA kernel (tests/test_torch_gpu.py), the CPU through a numpy
emulation of its chunked scan (tests/test_torch_nms_kernel.py).

Boxes are (B, K, 4) f32 with class offsets applied, as the main path hands
them to the kernel; ``valid`` is (B, K) bool.
"""

import numpy as np

from manual_yolo_tpu_torch.ops import nms as pt_nms


def _candidates(rng, b, k):
    xy = rng.uniform(0, 400, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    cls = rng.integers(0, 3, (b, k, 1)) * pt_nms.MAX_WH
    boxes = (np.concatenate([xy, xy + wh], -1) + cls).astype(np.float32)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    return boxes, valid


def _clustered(rng, b, k, n_valid):
    """Few centers, so boxes overlap and suppress; a valid prefix per frame."""
    centers = rng.uniform(50, 600, (8, 2))[rng.integers(0, 8, (b, k))]
    xy = centers + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 90, (b, k, 2))
    cls = rng.integers(0, 4, (b, k, 1)) * pt_nms.MAX_WH
    boxes = (np.concatenate([xy, xy + wh], -1) + cls).astype(np.float32)
    return boxes, np.arange(k)[None, :] < np.asarray(n_valid)[:, None]


def _identical(rng):
    """Groups of bit-identical boxes (IoU 1 within a group)."""
    base = _candidates(rng, 1, 24)[0][0]
    boxes = base[rng.integers(0, 24, 256)][None]
    return boxes, np.arange(256)[None, :] < 200


def _zero_area(rng):
    """Boxes with zero width or height (their IoU is 0) among ordinary ones."""
    boxes, _ = _clustered(rng, 1, 256, [256])
    flat = rng.random(256) < 0.4
    boxes[0, flat, 2] = boxes[0, flat, 0]
    line = rng.random(256) < 0.2
    boxes[0, line, 3] = boxes[0, line, 1]
    return boxes, np.ones((1, 256), bool)


def _iou_ties(rng):
    """Dyadic boxes: a 4 x h box against a 4 x 4 box at the same corner has an
    IoU of exactly h / 4 in f32 (the 1e-7 is lost to rounding), so h = 2 ties
    with t = 0.5, and a tie must not suppress."""
    k = 320
    origin = rng.integers(0, 200, (40, 2)).astype(np.float32) * 8
    heights = np.array([4, 2, 3, 1], np.float32)[rng.integers(0, 4, k)]
    xy = origin[rng.integers(0, 40, k)]
    boxes = np.concatenate([xy, xy + np.stack([np.full(k, 4, np.float32), heights], -1)], -1)
    cls = rng.integers(0, 2, (k, 1)).astype(np.float32) * np.float32(pt_nms.MAX_WH)
    return (boxes + cls)[None].astype(np.float32), np.ones((1, k), bool)


def _iou_ulp(rng):
    """A threshold one f32 step below the IoU of box 0 and a later box i, so
    that whether box 0 suppresses i rests on the quotient's last bit."""
    boxes, valid = _clustered(rng, 1, 128, [128])
    b = boxes[0]
    b[1] = b[0] + np.float32([3, 2, 1, 4])  # box 1 overlaps box 0, IoU near 0.8
    area = np.maximum(b[:, 2] - b[:, 0], np.float32(0)) * np.maximum(b[:, 3] - b[:, 1], np.float32(0))
    inter = (np.maximum(np.minimum(b[0, 2], b[:, 2]) - np.maximum(b[0, 0], b[:, 0]), np.float32(0))
             * np.maximum(np.minimum(b[0, 3], b[:, 3]) - np.maximum(b[0, 1], b[:, 1]), np.float32(0)))
    iou = inter / (area[0] + area - inter + np.float32(1e-7))
    return boxes, valid, float(np.nextafter(iou[1], np.float32(0)))


def _non_prefix(rng):
    """A valid mask with holes: the scan is still the full greedy one over K."""
    boxes, _ = _clustered(rng, 2, 512, [512, 512])
    return boxes, rng.random((2, 512)) < 0.6


def nms_case(name):
    """(boxes (B, K, 4) f32, valid (B, K) bool, iou threshold) of a named case.

    The seed comes from the name, so a case is the same in every file."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if "-" in name:  # "B-K": random boxes, a random valid prefix per frame
        b, k = map(int, name.split("-"))
        boxes, valid = _candidates(np.random.default_rng(b * k), b, k)
    elif name == "full_chain":  # all 512 valid and clustered: the longest chain
        boxes, valid = _clustered(rng, 1, 512, [512])
    elif name == "mixed_b16":
        boxes, valid = _clustered(rng, 16, 512, [0, 1, 31, 32, 33, 43, 63, 64,
                                                 100, 200, 300, 400, 480, 500, 511, 512])
    elif name == "identical":
        boxes, valid = _identical(rng)
    elif name == "zero_area":
        boxes, valid = _zero_area(rng)
    elif name == "iou_ties":
        return (*_iou_ties(rng), 0.5)
    elif name == "iou_ulp":
        return _iou_ulp(rng)
    elif name == "non_prefix":
        boxes, valid = _non_prefix(rng)
    elif name[0] == "n" and name[1:].isdigit():  # a valid prefix of n at K=128
        boxes, valid = _clustered(rng, 1, 128, [int(name[1:])])
    else:
        raise KeyError(name)
    return boxes, valid, 0.7


NMS_CASES = ["1-512", "4-512", "2-37", "1-2048", "full_chain", "mixed_b16",
             "n31", "n32", "n33", "n63", "identical", "zero_area", "iou_ties", "iou_ulp", "non_prefix"]
