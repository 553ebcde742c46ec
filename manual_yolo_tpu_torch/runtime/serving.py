"""Serving: the streaming engine and the multi-table batch stream.

Counterpart of ``manual_yolo_tpu/runtime/serving.py``: ``StreamingEngine``
(one frame at a time, split detect/classify queues) and ``BatchStream`` (B
table streams per tick: one upload, one detector forward over B canvases,
one NMS keep-mask launch for all B frames, one packed readback).

Both letterbox on the host into uint8 canvases (the odd-integer decimation
of ``csrc/host.cpp`` where the downscale is exactly s:1 with s odd, else its
``resize_u8``; both are cv2's INTER_LINEAR byte for byte), flip BGR to RGB
on the device, and classify the rank crops, cut from the full-resolution
frame on the host (``resize_u8`` again), in f32.

``BatchStream`` keeps the JAX package's tick logic and its lossless delta
codec, mode for mode and byte for byte: ``raw`` / ``raw_active`` (the whole
canvas, or its content rows with the 114 bars written on the device),
``skip`` (nothing goes up; with the memo of unchanged ticks), ``slots`` (few
tables changed: only their rows go up), and for a dense change ``segs``
(per-segment coding, always with the fused predictive classify), ``tribit``
(3-bit residuals, per-row biases) or ``nibble`` (4-bit residuals, per-slot
biases; over the whole canvas after a geometry change). The encoders are
``csrc/host.cpp``'s (``runtime/native.py``); the decoders are plain torch
ops on uint8 tensors here (``_segs_decoder``, ``nibble_decode``,
``tribit_decode``), run by the dispatcher against the resident planes. The
packed u8 readback decides the results' integers.

The pipeline is PyTorch's own: a dispatcher thread owns a CUDA stream, on
which it uploads from pinned staging buffers (``non_blocking``), runs the
detector and the NMS, and copies the packed results into pinned memory,
recording an event per batch; a finisher thread waits on that event,
assembles the detections, cuts and classifies the rank crops (on a stream
of its own; on a fused tick only those the prediction missed), and hands
the batch to ``collect_batch``. The payload buffers are pinned and rotate
with the staging buffers, and neither is written again before its upload's
event has completed.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.game.text import VALID_CARD_RANKS, normalize_rank_text
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.models.classifier import load_classifier_tree
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops.letterbox import letterbox_params
from manual_yolo_tpu_torch.runtime import native

PAD = 114
CROP = 64


def _build_models(det_params, det_spec, cls_params, cls_spec, compute_dtype, device):
    """(detector in ``compute_dtype``, classifier in f32) on ``device``, from
    the JAX package's folded parameter trees."""
    det = yolov8.load_jax_params(yolov8.build_model(det_spec, compute_dtype or torch.bfloat16),
                                 det_params)
    cls = yolov8.load_jax_params(yolov8.build_model(cls_spec, torch.float32), cls_params)
    return det.to(device).eval(), cls.to(device).eval()


def _stream_ctx(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def letterbox_u8_into(dst: np.ndarray, frame: np.ndarray, imgsz: int):
    """Resize ``frame`` (H, W, 3) uint8 into its letterbox region of the
    (imgsz, imgsz, 3) canvas ``dst``; the padding is left as it is. Returns
    (ratio, (top, left), (new_h, new_w))."""
    h, w = frame.shape[:2]
    r, nh, nw, top, left = letterbox_params((h, w), (imgsz, imgsz))
    if nw == imgsz:
        # an odd-integer downscale (1920x1200 -> a 640 canvas is exactly 3:1):
        # cv2's INTER_LINEAR samples one source pixel, so the strided gather
        # is byte-exact
        s = round(1 / r) if r > 0 else 0
        if not (s >= 3 and h == nh * s and w == nw * s
                and native.decimate_u8_into(frame, dst[top:top + nh], s)):
            dst[top:top + nh] = native.resize_u8(frame, (nh, nw))
    else:
        dst[top:top + nh, left:left + nw] = native.resize_u8(frame, (nh, nw))
    return r, (top, left), (nh, nw)


def rank_text(prob_row: np.ndarray, class_name: str, rank_names: Dict[int, str]) -> str:
    """The rank text of one classified crop, or "" below the confidence gate
    (0.20 for the turn and river, 0.40 otherwise)."""
    t = int(np.argmax(prob_row))
    thr = 0.20 if ("turn" in class_name or "river" in class_name) else 0.40
    if float(prob_row[t]) < thr:
        return ""
    pred = rank_names.get(t, "")
    cleaned = normalize_rank_text(pred)
    return cleaned if cleaned in VALID_CARD_RANKS else pred.upper()


class StreamingEngine:
    """Frame-at-a-time pipeline with split detect/classify queues.

    ``submit`` letterboxes a frame and enqueues its detection; when more than
    ``detect_depth`` frames wait, the oldest is read back, its rank crops are
    cut and their classification is enqueued. ``poll`` returns the oldest
    finished frame once more than ``classify_depth`` wait (None before), so
    results come back in submit order."""

    def __init__(
        self,
        det_params,
        det_spec,
        cls_params,
        cls_spec,
        names: Dict[int, str],
        rank_names: Dict[int, str],
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        max_rank: int = 8,
        crop_pad: int = 6,
        compute_dtype: Optional[torch.dtype] = None,
        detect_depth: int = 6,
        classify_depth: int = 4,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.det_model, self.cls_model = _build_models(
            det_params, det_spec, cls_params, cls_spec, compute_dtype, self.device)
        self.names = names
        self.rank_names = dict(rank_names)
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.max_rank = max_rank
        self.crop_pad = crop_pad
        self.detect_depth = detect_depth
        self.classify_depth = classify_depth
        self._rank_ids = {i for i, n in names.items() if n in taxonomy.RANK_CLASSES}
        # the upload copies a pageable canvas before it returns, so the pool
        # only keeps each canvas's geometry memory, as the JAX package's does
        self._canvases = [np.full((imgsz, imgsz, 3), PAD, np.uint8)
                          for _ in range(detect_depth + 3)]
        self._canvas_i = 0
        # the geometry each canvas was last written with: another one leaves
        # stale pixels in the new padding
        self._canvas_geom: List = [None] * len(self._canvases)
        self._q1: Deque[Tuple] = collections.deque()  # (frame, ratio, (top, left), detections)
        self._q2: Deque[Tuple] = collections.deque()  # ((boxes, scores, classes), det_idx, probs)

    @torch.inference_mode()
    def _detect(self, canvas_bgr: np.ndarray) -> nms_ops.Detections:
        x = torch.from_numpy(canvas_bgr).to(self.device).flip(-1).float()[None] / 255.0
        raw = self.det_model(x)
        boxes, scores = yolov8.decode_boxes(raw, (self.imgsz, self.imgsz),
                                            self.det_model.spec.strides)
        return nms_ops.nms(boxes[0], scores[0], conf_thres=self.conf, iou_thres=self.iou,
                           pre_nms=512, max_det=self.max_det)

    @torch.inference_mode()
    def _classify(self, crops_bgr: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(crops_bgr).to(self.device).flip(-1).float() / 255.0
        return torch.softmax(self.cls_model(x), dim=-1)

    def _letterbox_host(self, frame: np.ndarray):
        self._canvas_i = (self._canvas_i + 1) % len(self._canvases)
        canvas = self._canvases[self._canvas_i]
        h, w = frame.shape[:2]
        _, nh, nw, top, left = letterbox_params((h, w), (self.imgsz, self.imgsz))
        if self._canvas_geom[self._canvas_i] != (nh, nw, top, left):
            canvas[:] = PAD
            self._canvas_geom[self._canvas_i] = (nh, nw, top, left)
        r, pad, _ = letterbox_u8_into(canvas, frame, self.imgsz)
        return canvas, r, pad

    def _gather_rank_crops(self, frame, boxes, classes, scores):
        """64x64 BGR crops of the rank-class detections (score order), cut
        from the full-resolution frame: pad 6, short side scaled to 64,
        center crop."""
        crops = np.zeros((self.max_rank, CROP, CROP, 3), np.uint8)
        det_idx: List[int] = []
        p = self.crop_pad
        for i in range(len(scores)):
            if len(det_idx) >= self.max_rank:
                break
            if int(classes[i]) not in self._rank_ids:
                continue
            x1, y1, x2, y2 = boxes[i]
            c = BatchStream._gather_crop_u8(
                frame, (max(0, int(y1) - p), max(0, int(x1) - p), int(y2) + p, int(x2) + p))
            if c is None:
                continue
            crops[len(det_idx)] = c
            det_idx.append(i)
        return crops, det_idx

    def submit(self, frame_bgr: np.ndarray) -> None:
        canvas, r, pad = self._letterbox_host(frame_bgr)
        self._q1.append((frame_bgr, r, pad, self._detect(canvas)))
        if len(self._q1) > self.detect_depth:
            self._advance_q1()

    def _advance_q1(self) -> None:
        frame, r, (top, left), det = self._q1.popleft()
        det = nms_ops.Detections(*(t.cpu().numpy() for t in det))
        n = int(det.count)
        h, w = frame.shape[:2]
        boxes = (det.boxes[:n] - np.array([left, top, left, top], np.float32)) / r
        np.clip(boxes, 0, [w, h, w, h], out=boxes)
        scores = det.scores[:n]
        classes = det.classes[:n]
        crops, det_idx = self._gather_rank_crops(frame, boxes, classes, scores)
        probs = self._classify(crops) if det_idx else None
        self._q2.append(((boxes, scores, classes), det_idx, probs))

    def _finish_q2(self) -> List[Dict]:
        (boxes, scores, classes), det_idx, probs = self._q2.popleft()
        out = [
            {
                "class_id": int(classes[i]),
                "class_name": self.names.get(int(classes[i]), "?"),
                "bbox": [int(v) for v in boxes[i]],
                "conf": round(float(scores[i]), 3),
                "ocr_text": "",
            }
            for i in range(len(scores))
        ]
        if probs is not None:
            probs = probs.cpu().numpy()[: len(det_idx)]
            for slot, di in enumerate(det_idx):
                out[di]["ocr_text"] = rank_text(probs[slot], out[di]["class_name"],
                                                self.rank_names)
        return out

    def poll(self) -> Optional[List[Dict]]:
        if len(self._q2) > self.classify_depth:
            return self._finish_q2()
        return None

    def drain(self) -> List[List[Dict]]:
        out = []
        while self._q1:
            self._advance_q1()
        while self._q2:
            out.append(self._finish_q2())
        return out

    def process(self, frame_bgr: np.ndarray) -> Optional[List[Dict]]:
        """submit + poll in one call (the steady-state streaming API)."""
        self.submit(frame_bgr)
        return self.poll()


# ---------------------------------------------------------------------------
# The delta codec's device decoders: plain torch ops on uint8 tensors, every
# addition mod 256, so that each rebuilds the encoded plane bit for bit. None
# of them reads a value back to the host: each segment's payload position
# comes from cumulative sums over the class array on the device. Every gather
# index is clamped into range first; a lane whose index was clamped is masked
# to zero afterwards, as the JAX package's out-of-range gathers are.

U8 = torch.uint8


def _bit_planes(x: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) uint8 -> (N, n): bit k of x[j] at [j, k]."""
    return (x[:, None] >> torch.arange(n, dtype=U8, device=x.device)) & 1


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` along the first axis, indices clamped into range."""
    return src[idx.clamp(0, src.shape[0] - 1)]


def _unpack3(b3: torch.Tensor) -> torch.Tensor:
    """(N, 3) uint8 -> (N, 8): eight 3-bit values per 3 bytes, little-endian."""
    c0, c1, c2 = b3[:, 0], b3[:, 1], b3[:, 2]
    return torch.stack([
        c0 & 7, (c0 >> 3) & 7, (c0 >> 6) | ((c1 & 1) << 2), (c1 >> 1) & 7, (c1 >> 4) & 7,
        (c1 >> 7) | ((c2 & 3) << 1), (c2 >> 2) & 7, c2 >> 5,
    ], dim=-1)


def _segs_decoder(nslots, H, W, top, nh, segw, Np, pad_value=PAD):
    """The decoder of a per-segment delta payload over rows [top, top+nh) of
    ``nslots`` (H, W, 3) planes, whose bits block is ``Np`` bytes (the mirror
    of ``native.seg_encode`` and ``BatchStream._assemble_segs_payload``).
    The returned function maps (payload u8, previous plane u8, flat) to the
    current plane, flat (nslots*H*W*3,); rows outside [top, top+nh) are
    ``pad_value`` (the letterbox bars of a canvas).

    Payload layout: [1-bit block | pad to q2 | 2-bit block | pad to q3 |
    3-bit block | pad to qr | raw block | L bytes (classes 8/9) | L bytes
    (class 10) | pad to 3 | 3-byte sub-masks (8/9) | sub-masks (10) | nibble
    exceptions | byte exceptions | bias exceptions (3 per segment) | zero pad
    to Np | slot bias defaults (nslots*3) | default-bias flags (bit i of byte
    j: segment 8j+i) | classes, 4 bits each]. Class boundaries are found on
    the device, so one decoder serves every mix of classes."""
    segb = segw * 3
    q1, q2, q3, qr = segb // 8, segb // 4, segb * 3 // 8, segb
    nsegrow = W // segw
    nseg = nslots * nh * nsegrow
    segs_per_slot = nh * nsegrow
    nfl, ncl = (nseg + 7) // 8, (nseg + 1) // 2
    nsb = segb // 24  # 24-byte sub-blocks of a segment (two-level masks)

    def decode(payload: torch.Tensor, prev_flat: torch.Tensor) -> torch.Tensor:
        dev = payload.device
        bits = payload[:Np]
        o = Np
        slot_bias = payload[o:o + nslots * 3].reshape(nslots, 3)
        o += nslots * 3
        flag = _bit_planes(payload[o:o + nfl], 8).reshape(-1)[:nseg].bool()
        o += nfl
        clsp = payload[o:o + ncl]
        cls = torch.stack([clsp & 0xF, clsp >> 4], dim=-1).reshape(-1)[:nseg]
        is1, is2, is3, isr = cls == 1, cls == 2, cls == 3, cls == 4
        is5 = cls == 5  # clamp-shift: cur = clamp(prev + sext(bias))
        # shift-residual: cur = clamp(prev + j) + e, payload in the 2-bit
        # (class 6) or 3-bit (class 7) block
        is6, is7 = cls == 6, cls == 7
        # sparse exceptions: a deviation mask per segment, values in shared
        # nibble (classes 8/9) or byte (class 10) streams across segments
        is8, is9, is10 = cls == 8, cls == 9, cls == 10
        ismask4 = is8 | is9
        is2b, is3b = is2 | is6, is3 | is7
        # each segment's rank within its block is its row there (the host
        # appends per block in scan order)
        r1 = torch.cumsum(is1, 0) - 1
        r2 = torch.cumsum(is2b, 0) - 1
        r3 = torch.cumsum(is3b, 0) - 1
        rr = torch.cumsum(isr, 0) - 1
        rm4 = torch.cumsum(ismask4, 0) - 1
        rm8 = torch.cumsum(is10, 0) - 1
        isx = ~flag
        rx = torch.cumsum(isx, 0) - 1
        k1, k2, k3, kr = is1.sum(), is2b.sum(), is3b.sum(), isr.sum()
        k4m, k10m = ismask4.sum(), is10.sum()
        b2p = (q1 * k1 + q2 - 1) // q2 * q2
        b3p = (b2p + q2 * k2 + q3 - 1) // q3 * q3
        brp = (b3p + q3 * k3 + qr - 1) // qr * qr
        l4p = brp + qr * kr  # the L bytes of the two-level masks
        l8p = l4p + k4m
        s4p = (l8p + k10m + 2) // 3 * 3  # sub-mask rows start on a multiple of 3
        # the whole bits block unpacked under each packing; block alignment
        # puts every segment's values on one whole row
        dbits = _bit_planes(bits, 8).reshape(-1)
        d1 = dbits.reshape(-1, segb)
        d24 = dbits.reshape(-1, 24)  # sub-mask rows (3-byte bitmasks)
        d2 = torch.stack([bits & 3, (bits >> 2) & 3, (bits >> 4) & 3, bits >> 6],
                         dim=-1).reshape(-1, segb)
        d3 = _unpack3(bits.reshape(-1, 3)).reshape(-1, segb)
        draw = bits.reshape(-1, segb)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        g1 = _take(d1, torch.where(is1, r1, zero))
        g2 = _take(d2, torch.where(is2b, b2p // q2 + r2, zero))
        g3 = _take(d3, torch.where(is3b, b3p // q3 + r3, zero))
        gr = _take(draw, torch.where(isr, brp // qr + rr, zero))
        # the sparse classes: each segment's L byte, its dirty sub-blocks'
        # mask rows (an exclusive cumsum of L popcounts in segment order),
        # the clean sub-blocks zero, then each segment's offset in its value
        # stream from the exclusive cumsum of the mask popcounts
        L4 = _take(bits, torch.where(ismask4, l4p + rm4, zero)) * ismask4
        L8 = _take(bits, torch.where(is10, l8p + rm8, zero)) * is10
        lb4 = _bit_planes(L4, nsb)  # (nseg, nsb)
        lb8 = _bit_planes(L8, nsb)
        pd4, pd8 = lb4.sum(1), lb8.sum(1)
        s8p = s4p + 3 * pd4.sum()
        nibp = s8p + 3 * pd8.sum()
        base4 = (torch.cumsum(pd4, 0) - pd4)[:, None] + (torch.cumsum(lb4, 1) - lb4)
        base8 = (torch.cumsum(pd8, 0) - pd8)[:, None] + (torch.cumsum(lb8, 1) - lb8)
        m4b = (_take(d24, torch.where(lb4.bool(), s4p // 3 + base4, zero))
               * lb4[..., None]).reshape(nseg, segb)
        m8b = (_take(d24, torch.where(lb8.bool(), s8p // 3 + base8, zero))
               * lb8[..., None]).reshape(nseg, segb)
        pc4, pc8 = m4b.sum(1), m8b.sum(1)
        idx4 = (torch.cumsum(pc4, 0) - pc4)[:, None] + (torch.cumsum(m4b, 1) - m4b)
        nibbyte = _take(bits, nibp + idx4 // 2)
        v4 = torch.where((idx4 & 1).bool(), nibbyte >> 4, nibbyte & 0xF)
        r4v = (v4 - 8) * m4b  # the signed nibble mod 256; 0 off the mask
        bytp = nibp + (pc4.sum() + 1) // 2
        idx8 = (torch.cumsum(pc8, 0) - pc8)[:, None] + (torch.cumsum(m8b, 1) - m8b)
        r8v = _take(bits, bytp + idx8) * m8b
        bep = bytp + pc8.sum()  # the bias exceptions
        # each segment's bias: its slot's default, or its ranked exception
        seg_slot = torch.arange(nseg, device=dev) // segs_per_slot
        bias_def = slot_bias[seg_slot]  # (nseg, 3)
        xbase = bep + 3 * torch.where(isx, rx, zero)
        bias_exc = torch.stack([_take(bits, xbase + ch) for ch in range(3)], dim=-1)
        bias = torch.where(flag[:, None], bias_def, bias_exc)
        prev = prev_flat.reshape(nslots, H, W, 3)
        pact = prev[:, top:top + nh].reshape(nseg, segb)
        biasx = bias[:, None, :].expand(nseg, segw, 3).reshape(nseg, segb)
        delta = torch.where(is1[:, None], g1,
                            torch.where(is2[:, None], g2 - 2,
                                        torch.where(is3[:, None], g3 - 4, 0))) + biasx
        # class 5 saturates instead of wrapping: the bias byte is the signed
        # shift (a bit reinterpretation, not a value cast)
        shifted = (pact.short() + biasx.view(torch.int8).short()).clamp(0, 255).to(U8)
        # classes 6/7: bias byte ((j + 64) & 0x7F) | m << 7, a saturating
        # shift by j plus a one-sided residual e = v - m*lim, added mod 256
        j67 = (biasx & 0x7F).short() - 64
        m67 = biasx >> 7
        shifted67 = (pact.short() + j67).clamp(0, 255).to(U8)
        new6 = shifted67 + g2 + m67 * 253
        new7 = shifted67 + g3 + m67 * 249
        # sparse classes: a constant base (8, 10) or the clamp-shift base (9,
        # whose bias byte follows class 5's convention), plus the values
        new8 = pact + biasx + r4v
        new9 = shifted + r4v
        new10 = pact + biasx + r8v
        newseg = pact + delta
        for mask, val in ((is10, new10), (is9, new9), (is8, new8), (is7, new7), (is6, new6),
                          (is5, shifted), (isr, gr)):
            newseg = torch.where(mask[:, None], val, newseg)
        act = newseg.reshape(nslots, nh, W, 3)
        if nh == H:
            return act.reshape(-1)
        canv = torch.full((nslots, H, W, 3), pad_value, dtype=U8, device=dev)
        canv[:, top:top + nh] = act
        return canv.reshape(-1)

    return decode


def nibble_decode(payload: torch.Tensor, prev_flat: torch.Tensor, B: int, H: int, W: int,
                  top: int, nh: int) -> torch.Tensor:
    """Rows [top, top+nh) of B (H, W, 3) planes from a nibble payload
    (``native.nibble_encode``): [B*nh*W*3/2 bytes, v[2i] | v[2i+1] << 4 |
    B*3 biases]; plane = prev + (v - 8) + bias, mod 256. The other rows keep
    ``prev``. ``top=0, nh=H`` is the whole canvas."""
    n_act = B * nh * W * 3
    nib = payload[:n_act // 2]
    bias = payload[n_act // 2:n_act // 2 + B * 3].reshape(B, 1, 1, 3)
    v = torch.stack([nib & 0xF, nib >> 4], dim=-1).reshape(B, nh, W, 3)
    out = prev_flat.reshape(B, H, W, 3).clone()
    out[:, top:top + nh] += (v - 8) + bias
    return out.reshape(-1)


def tribit_decode(payload: torch.Tensor, prev_flat: torch.Tensor, B: int, H: int, W: int,
                  top: int, nh: int) -> torch.Tensor:
    """Rows [top, top+nh) of B (H, W, 3) planes from a tribit payload
    (``native.tribit_encode``): [B*nh*W*3*3/8 bytes of 3-bit values | B*nh*3
    per-row biases]; plane = prev + (v - 4) + bias, mod 256."""
    n_act = B * nh * W * 3
    nb = n_act * 3 // 8
    v = _unpack3(payload[:nb].reshape(-1, 3)).reshape(B, nh, W, 3)
    bias = payload[nb:nb + B * nh * 3].reshape(B, nh, 1, 3)
    out = prev_flat.reshape(B, H, W, 3).clone()
    out[:, top:top + nh] += (v - 4) + bias
    return out.reshape(-1)


def _copy_results(out):
    """A copy of a batch's results (list[list[dict]]) that callers may mutate."""
    return [[dict(d, bbox=list(d["bbox"])) for d in dets] for dets in out]


def _pinned(n: int, pin: bool) -> torch.Tensor:
    return torch.zeros((n,), dtype=U8, pin_memory=pin)


class BatchStream:
    """Batched pipeline: B table streams per tick through one detector forward,
    one NMS keep-mask launch and one readback.

    ``delta=True`` codes each tick against the previous one, losslessly: the
    device rebuilds the canvases bit for bit, so the detections are those of
    ``delta=False``. The modes, in the order they are tried:

      * **skip**: every slot's canvas is byte-identical to the previous
        tick's: nothing goes up and the detector runs on the resident device
        canvas; when every frame is the same array content as before, the
        previous results are returned again (``memo_hits``);
      * **slots**: at most B/4 slots changed and the letterbox geometry is
        the previous tick's: only those slots' content rows go up into the
        resident canvas;
      * **segs**: a dense change at the previous tick's geometry: every
        40-px segment of a content row takes the byte-cheapest of const,
        1/2/3-bit, clamp-shift, shift and residual, sparse-exception and raw
        coding (``native.seg_encode``), the device decodes it against the
        resident canvas (``_segs_decoder``). Such a tick always runs the
        fused predictive classify: the rank crops are cut on the submit
        thread at the last finished tick's rects, coded against the last
        predicted crop plane (crop-plane segs, or raw), and ride in the same
        upload; the dispatcher decodes both planes, detects, and classifies
        the predicted crops, and one u8 readback carries the detections and
        the rank probabilities. The finisher classifies again only the
        detections whose rect the prediction missed (``fused_hits``,
        ``fused_misses``, ``fallback_batches``);
      * **tribit**: a dense change whose segs payload would be larger than
        3-bit residuals with per-row biases (3/8 of the content bytes), or
        does not pay: taken when every (slot, row, channel) delta spans at
        most 7;
      * **nibble**: 4-bit residuals with per-slot biases (half the bytes)
        when every slot-channel delta spans at most 15; over the whole canvas
        when the letterbox geometry changed;
      * **raw**: anything else. When every slot shares one full-width
        letterbox geometry only the content rows go up (``raw_active``) and
        the 114 bars are written on the device; else the whole canvas.

    The rank crops of a tick that is not fused are coded against the last
    classified crop plane on the finisher thread: skip (byte-identical: the
    last probabilities again), segs (one segment per crop row), else raw
    (``crop_mode_counts``).

    Aliasing contract: a submitted frame must not be mutated in place
    afterwards (the stream keeps references for the delta test and the crop
    gather); submitting the same array again says "unchanged".
    """

    N_PIPE = 6  # staging buffers; at most N_PIPE - 3 batches wait undispatched

    def __init__(
        self,
        det_params,
        det_spec,
        cls_params,
        cls_spec,
        names: Dict[int, str],
        rank_names: Dict[int, str],
        batch: int = 32,
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        max_rank: int = 8,
        crop_pad: int = 6,
        compute_dtype: Optional[torch.dtype] = None,
        delta: bool = True,
        readback_det: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self.det_model, self.cls_model = _build_models(
            det_params, det_spec, cls_params, cls_spec, compute_dtype, self.device)
        self.B = batch
        self.names = names
        self.rank_names = dict(rank_names)
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        # only the top readback_det NMS slots of a frame are read back; the
        # full max_det plane when a frame has more. <= 254 so the u8 count
        # byte (capped at readback_det + 1) says "exceeded" unambiguously
        self.readback_det = min(readback_det or 64, max_det, 254)
        self.readback_overflows = 0
        self.max_rank = max_rank
        self.crop_pad = crop_pad
        self.delta = delta
        self._pin = cuda
        self._rank_ids = {i for i, n in names.items() if n in taxonomy.RANK_CLASSES}
        # pinned on the card, so that the uploads run without a host copy
        self._staging_t = [
            torch.full((batch, imgsz, imgsz, 3), PAD, dtype=U8, pin_memory=cuda)
            for _ in range(self.N_PIPE)
        ]
        self._staging = [t.numpy() for t in self._staging_t]
        # {"uploaded": threading.Event, "h2d": CUDA event} of the batch whose
        # upload last read each staging buffer, and the payload buffers of
        # the same index
        self._staging_sync: List[Optional[Dict]] = [None] * self.N_PIPE
        self._staging_i = 0
        # nibble and tribit payloads (the nibble of the whole canvas is the
        # largest), pinned and rotating with the staging buffers
        n_px = batch * imgsz * imgsz * 3
        self._n_nib, self._n_bias = n_px // 2, batch * 3
        self._nibbuf_t = [_pinned(self._n_nib + self._n_bias, cuda) for _ in range(self.N_PIPE)]
        self._nibbuf = [t.numpy() for t in self._nibbuf_t]
        # segs buffers per content height, made at a geometry's first segs tick
        self._segs_bufs: Dict[int, Dict] = {}
        # the canvas segment width: 40 px is the cheapest on jittered table
        # streams; at most 64 (the sparse masks' L byte covers 8 sub-blocks)
        self._segw = next((w for w in (40, 32, 48, 64, 16, 24, 8) if imgsz % w == 0), None)
        self._prev_staging: Optional[np.ndarray] = None
        self._prev_frames: List[Optional[np.ndarray]] = [None] * batch
        self._prev_metas: List = [None] * batch
        self._slot_geom: Dict = {}
        # letterbox geometry of the resident canvas's last upload: the
        # content-rows uploads and decodes rely on its bars already being 114
        self._prev_geom: Optional[Tuple[int, int]] = None
        self._slots_max = max(1, batch // 4)
        self.memo_hits = 0
        self.mode_counts = {"raw": 0, "nibble": 0, "tribit": 0, "slots": 0, "segs": 0, "skip": 0}
        self.crop_mode_counts = {"raw": 0, "segs": 0, "skip": 0, "fused_segs": 0, "fused_raw": 0}
        self.fused_hits = 0
        self.fused_misses = 0
        self.fallback_batches = 0
        self._nd_flat = batch * self.readback_det * 12
        ns = batch * max_rank
        # the resident planes, written and read only on the dispatcher thread:
        # the canvas, and the predicted crop plane of the fused ticks (zeros
        # until the first one)
        self._dev_canvas = torch.full((batch, imgsz, imgsz, 3), PAD, dtype=U8, device=self.device)
        self._dev_pred_crops = torch.zeros((ns, CROP, CROP, 3), dtype=U8, device=self.device)
        # the fused ticks' predicted crop plane on the host (submit thread
        # only), its segs buffers, and the (top, nh, canvas bucket, crop
        # bucket) of each fused tick (prewarm_buckets reads them)
        self._pred_prev_crops: Optional[np.ndarray] = None
        self._pred_segs_bufs: Optional[Dict] = None
        self._fused_buckets: Dict[Tuple[int, int, int, int], None] = {}
        # crop-rect hysteresis (finisher thread only): class id -> recent rects
        self._rect_cache: Dict[int, List[Tuple[int, int, int, int]]] = {}
        # the predicted (class id, rect) pairs of each slot, published by the
        # finisher for the submit thread (a list swap), and their ages
        self._pred_rects: List[List[Tuple[int, Tuple[int, int, int, int]]]] = [
            [] for _ in range(batch)]
        self._pred_ages: List[Dict] = [{} for _ in range(batch)]
        # the last classified crop plane of the ticks that are not fused, on
        # the host and on the card, its u8 probabilities, and its segs
        # buffers (finisher only)
        self._prev_crops: Optional[np.ndarray] = None
        self._dev_prev_crops: Optional[torch.Tensor] = None
        self._last_cls_probs: Optional[np.ndarray] = None
        self._crop_segs_bufs: Optional[Dict] = None
        self._crop_pay_i = -1
        self._last_out = None
        # set by the pipeline threads when a batch fails after the submit
        # thread advanced its delta references: the next submit goes up raw
        self._delta_broken = False
        self._closed = False
        self._pending: Deque[Dict] = collections.deque()
        # per-stage wall times in seconds, one entry per batch, bounded so a
        # forever-serve run does not grow them; read with stage_summary().
        # payload_mb, canvas_mb and crops_mb are the bytes each tick uploads
        # (0 for skip), canvas_seg_counts each segs encode's segment counts
        self.stage_stats: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=4096))
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._cls_stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            # the resident planes and the models were written on the default
            # stream; the pipeline's streams read them
            for st in (self._stream, self._cls_stream):
                st.wait_stream(torch.cuda.current_stream(self.device))
        self._dispatch_q: "queue.Queue" = queue.Queue(maxsize=self.N_PIPE - 3)
        self._finish_q: "queue.Queue" = queue.Queue()
        self._dispatch_thread = threading.Thread(target=self._dispatcher, daemon=True)
        self._finish_thread = threading.Thread(target=self._finisher, daemon=True)
        self._dispatch_thread.start()
        self._finish_thread.start()

    # -- submit thread ---------------------------------------------------------

    def _letterbox_into(self, dst: np.ndarray, frame: np.ndarray, key=None):
        h, w = frame.shape[:2]
        _, nh, nw, _, _ = letterbox_params((h, w), (self.imgsz, self.imgsz))
        # the staging buffers are 114 once and each resize writes only its
        # content region: if this slot last held another geometry, clear it
        if key is not None:
            if self._slot_geom.get(key, (nh, nw)) != (nh, nw):
                dst[:] = PAD
            self._slot_geom[key] = (nh, nw)
        return letterbox_u8_into(dst, frame, self.imgsz)

    def _batch_geom(self, metas) -> Optional[Tuple[int, int]]:
        """(top, nh) when every slot letterboxed to the same full-width
        geometry (the content-rows upload applies); None otherwise."""
        g0 = metas[0][2] if metas and metas[0] is not None else None
        if g0 is None or g0[1] != self.imgsz:
            return None
        for m in metas:
            if m is None or m[2] != g0 or m[1][1] != 0:
                return None
        return (metas[0][1][0], g0[0])

    def _wait_staging(self, i: int) -> None:
        """Block until the upload that last read staging buffer ``i`` (and
        the payload buffers of that index) is done."""
        sync = self._staging_sync[i]
        if sync is not None:
            sync["uploaded"].wait()
            if sync["h2d"] is not None:
                sync["h2d"].synchronize()

    @staticmethod
    def _make_segs_bufs(segw: int, nseg: int, raw_bytes: int, n_pay: int, room: int = 0,
                        pin: bool = False) -> Dict:
        """Host buffers for segs coding of one plane geometry: the encoder's
        per-class outputs, and ``n_pay`` payload buffers (``pay``, numpy views
        of the tensors ``pay_t``, pinned with ``pin``) that rotate with the
        staging buffers, each with ``room`` bytes more for what rides after
        the payload in the same upload."""
        segb = segw * 3
        q1, q2, q3, qr = segb // 8, segb // 4, segb * 3 // 8, segb
        lcm = int(np.lcm.reduce([q1, q2, q3, qr]))
        # the bits block's size steps: a multiple of lcm(q1..qr), so that
        # every decoded view is whole rows, about raw/8 and at most
        # 1024*lcm. These sizes are the wire layout the decoder reads.
        step = lcm * max(1, min(1024, raw_bytes // (8 * lcm)))
        trailer = 3 * nseg + (nseg + 7) // 8 + (nseg + 1) // 2 + 3 * nseg
        cap = ((raw_bytes // 2 + step - 1) // step) * step + trailer
        pay_t = [_pinned(cap + room, pin) for _ in range(n_pay)]
        return {
            "p1": np.zeros(nseg * q1, np.uint8),
            "p2": np.zeros(nseg * q2, np.uint8),
            "p3": np.zeros(nseg * q3, np.uint8),
            "raw": np.zeros(nseg * qr, np.uint8),
            # the sparse classes (8/9/10): an L byte per segment, a 3-byte
            # mask per dirty 24-byte sub-block (at most q1 bytes a segment)
            # and the nibble and byte value streams
            "m4": np.zeros(nseg, np.uint8),
            "m8": np.zeros(nseg, np.uint8),
            "s4": np.zeros(nseg * q1, np.uint8),
            "s8": np.zeros(nseg * q1, np.uint8),
            "nib": np.zeros(nseg * segb, np.uint8),
            "byte": np.zeros(nseg * segb, np.uint8),
            "bias": np.zeros(nseg * 3, np.uint8),
            "cls": np.zeros(nseg, np.uint8),
            "pay_t": pay_t,
            "pay": [t.numpy() for t in pay_t],
            "step": step,
        }

    @staticmethod
    def _assemble_segs_payload(bufs, pay_i, counts, qs, nseg, nslots, raw_bytes):
        """Lay out [p1 | p2 | p3 | raw | L4 bytes | L8 bytes | pad to 3 | s4
        sub-masks | s8 sub-masks | nibble exceptions | byte exceptions | bias
        exceptions | zero pad | slot bias defaults | flags | classes] in
        ``bufs["pay"][pay_i]``, each block aligned so that the decoder's rows
        land on it. The per-segment biases go as a default per slot and
        channel (the modal one, a photometric shift), a flag bit per segment
        and a triple per segment that differs. Returns (payload view,
        bits-block size), or None when it is no smaller than half the raw
        bytes."""
        q1, q2, q3, qr = qs
        k1, k2, k3, kr, k4m, k10m, nz4, nz8, d4, d8 = counts
        sps = nseg // nslots  # segments per slot
        bias = bufs["bias"][: nseg * 3].reshape(nslots, sps, 3)
        slot_idx = np.arange(nslots, dtype=np.int64)[:, None] * 256
        defaults = np.empty((nslots, 3), np.uint8)
        for ch in range(3):
            cnt = np.bincount((slot_idx + bias[:, :, ch]).reshape(-1),
                              minlength=nslots * 256).reshape(nslots, 256)
            defaults[:, ch] = cnt.argmax(axis=1).astype(np.uint8)
        flags = (bias == defaults[:, None, :]).all(axis=2).reshape(-1)
        exc = bias.reshape(-1, 3)[~flags]
        ke = exc.shape[0]
        nfl = (nseg + 7) // 8
        ncl = (nseg + 1) // 2
        b2p = ((q1 * k1 + q2 - 1) // q2) * q2
        b3p = ((b2p + q2 * k2 + q3 - 1) // q3) * q3
        brp = ((b3p + q3 * k3 + qr - 1) // qr) * qr
        l4p = brp + qr * kr
        l8p = l4p + k4m
        s4p = ((l8p + k10m + 2) // 3) * 3
        s8p = s4p + 3 * d4
        nibp = s8p + 3 * d8
        nibb = (nz4 + 1) // 2
        bytp = nibp + nibb
        bep = bytp + nz8
        used = bep + 3 * ke
        step = bufs["step"]
        np_bucket = max(step, ((used + step - 1) // step) * step)
        total = np_bucket + nslots * 3 + nfl + ncl
        if total >= raw_bytes // 2:  # nibble or raw would be no larger
            return None
        pay = bufs["pay"][pay_i]
        pay[: q1 * k1] = bufs["p1"][: q1 * k1]
        pay[q1 * k1:b2p] = 0
        pay[b2p:b2p + q2 * k2] = bufs["p2"][: q2 * k2]
        pay[b2p + q2 * k2:b3p] = 0
        pay[b3p:b3p + q3 * k3] = bufs["p3"][: q3 * k3]
        pay[b3p + q3 * k3:brp] = 0
        pay[brp:l4p] = bufs["raw"][: qr * kr]
        pay[l4p:l8p] = bufs["m4"][:k4m]
        pay[l8p:l8p + k10m] = bufs["m8"][:k10m]
        pay[l8p + k10m:s4p] = 0
        pay[s4p:s8p] = bufs["s4"][: 3 * d4]
        pay[s8p:nibp] = bufs["s8"][: 3 * d8]
        pay[nibp:bytp] = bufs["nib"][:nibb]
        pay[bytp:bep] = bufs["byte"][:nz8]
        pay[bep:used] = exc.reshape(-1)
        pay[used:np_bucket] = 0
        o = np_bucket
        pay[o:o + nslots * 3] = defaults.reshape(-1)
        o += nslots * 3
        pay[o:o + nfl] = np.packbits(flags, bitorder="little")
        o += nfl
        cls = bufs["cls"][:nseg]
        if nseg % 2:
            cls = np.append(cls, np.uint8(0))
        pay[o:o + ncl] = cls[0::2] | cls[1::2] << 4
        return pay[:total], np_bucket

    def _encode_crop_plane_segs(self, crops, prev, bufs, pay_i):
        """Segs coding of a (B*max_rank, 64, 64, 3) crop plane against
        ``prev``, one segment per crop row. (payload view, bits-block size),
        or None: the plane goes raw."""
        ns, ch, cw, _ = crops.shape
        segb = cw * 3
        counts = native.seg_encode(
            crops, prev, 0, ch, cw, bufs["p1"], bufs["p2"], bufs["p3"], bufs["raw"], bufs["m4"],
            bufs["m8"], bufs["s4"], bufs["s8"], bufs["nib"], bufs["byte"], bufs["bias"],
            bufs["cls"])
        if counts is None:
            return None
        return self._assemble_segs_payload(bufs, pay_i, counts,
                                           (segb // 8, segb // 4, segb * 3 // 8, segb),
                                           ns * ch, ns, crops.size)

    def _crop_bufs(self) -> Dict:
        return self._make_segs_bufs(CROP, self.B * self.max_rank * CROP,
                                    self.B * self.max_rank * CROP * CROP * 3, self.N_PIPE,
                                    pin=self._pin)

    def _encode_crop_segs(self, crops: np.ndarray):
        """The finisher's crop-plane coding (ticks that are not fused):
        (pinned payload tensor, bits-block size), or None."""
        if self._crop_segs_bufs is None:
            self._crop_segs_bufs = self._crop_bufs()
        self._crop_pay_i = (self._crop_pay_i + 1) % self.N_PIPE
        enc = self._encode_crop_plane_segs(crops, self._prev_crops, self._crop_segs_bufs,
                                           self._crop_pay_i)
        if enc is None:
            return None
        return self._crop_segs_bufs["pay_t"][self._crop_pay_i][:enc[0].size], enc[1]

    def _build_fused_payload(self, frames, canvas_payload: np.ndarray, nh: int):
        """The submit thread's half of a fused tick: cut the crops from the
        current frames at the last finished tick's rects, code them against
        the last predicted plane, and lay them after the canvas payload in
        its pinned buffer. Returns (payload tensor, crop bits-block size or
        -1 for a raw crop plane, the predicted pairs)."""
        pred = [list(p) for p in self._pred_rects]  # the finisher swaps the list
        ns = self.B * self.max_rank
        crops = np.zeros((ns, CROP, CROP, 3), np.uint8)
        for bi in range(self.B):
            for j, (_cid, rect) in enumerate(pred[bi][: self.max_rank]):
                c = self._gather_crop_u8(frames[bi], rect)
                if c is not None:
                    crops[bi * self.max_rank + j] = c
        i = self._staging_i % self.N_PIPE
        npk, kpay = -1, None
        if self._pred_prev_crops is not None:
            if self._pred_segs_bufs is None:
                self._pred_segs_bufs = self._crop_bufs()
            enc = self._encode_crop_plane_segs(crops, self._pred_prev_crops,
                                               self._pred_segs_bufs, i)
            if enc is not None:
                kpay, npk = enc
        if kpay is None:
            kpay = crops.reshape(-1)
        self._pred_prev_crops = crops
        n_c = canvas_payload.size
        self._segs_bufs[nh]["pay"][i][n_c:n_c + kpay.size] = kpay
        self.stage_stats["canvas_mb"].append(n_c / 1e6)
        self.stage_stats["crops_mb"].append(kpay.size / 1e6)
        return self._segs_bufs[nh]["pay_t"][i][:n_c + kpay.size], npk, pred

    def _encode_segs(self, staging: np.ndarray, top: int, nh: int):
        """Segs coding of the content rows: (payload view, bits-block size),
        or None when it does not pay (or no segment width divides imgsz)."""
        segw = self._segw
        if segw is None:
            return None
        segb = segw * 3
        nseg = self.B * nh * (self.imgsz // segw)
        raw_act = self.B * nh * self.imgsz * 3
        bufs = self._segs_bufs.get(nh)
        if bufs is None:
            # room for the raw crop plane that rides after the canvas payload
            bufs = self._make_segs_bufs(segw, nseg, raw_act, self.N_PIPE,
                                        room=self.B * self.max_rank * CROP * CROP * 3,
                                        pin=self._pin)
            self._segs_bufs[nh] = bufs
        counts = native.seg_encode(
            staging, self._prev_staging, top, nh, segw, bufs["p1"], bufs["p2"], bufs["p3"],
            bufs["raw"], bufs["m4"], bufs["m8"], bufs["s4"], bufs["s8"], bufs["nib"],
            bufs["byte"], bufs["bias"], bufs["cls"])
        if counts is None:
            return None
        # (nseg, k1, k2, k3, k_raw, k_mask4, k_mask8, nz_nib, nz_byte,
        # dirty4, dirty8): what the link bytes went to
        self.stage_stats["canvas_seg_counts"].append((nseg,) + tuple(counts))
        return self._assemble_segs_payload(bufs, self._staging_i % self.N_PIPE, counts,
                                           (segb // 8, segb // 4, segb * 3 // 8, segb), nseg,
                                           self.B, raw_act)

    def _encode_tribit(self, staging: np.ndarray, top: int, nh: int) -> Optional[np.ndarray]:
        """3-bit residuals with per-row biases over the content rows (3/8 of
        their bytes), or None when a row's span is over 7."""
        nb = self.B * nh * self.imgsz * 3 * 3 // 8
        n_bias = self.B * nh * 3
        payload = self._nibbuf[self._staging_i]
        if nb + n_bias > payload.size:
            return None
        if not native.tribit_encode(staging, self._prev_staging, top, nh, payload[:nb],
                                    payload[nb:nb + n_bias]):
            return None
        return payload[:nb + n_bias]

    def _encode_nibble(self, staging: np.ndarray, top: int = 0,
                       nh: Optional[int] = None) -> Optional[np.ndarray]:
        """4-bit residuals with a bias per slot and channel over rows [top,
        top+nh) (the whole canvas by default), or None when a slot-channel's
        delta span is over 15."""
        nh = self.imgsz if nh is None else nh
        n_nib = self.B * nh * self.imgsz * 3 // 2
        payload = self._nibbuf[self._staging_i]
        if not native.nibble_encode(staging, self._prev_staging, top, nh, payload[:n_nib],
                                    payload[n_nib:n_nib + self._n_bias]):
            return None
        return payload[:n_nib + self._n_bias]

    def submit_batch(self, frames: List[np.ndarray]) -> None:
        """Stage one tick of exactly B frames and queue it for dispatch; returns
        once it is staged (blocking while N_PIPE - 3 batches wait)."""
        if len(frames) != self.B:
            raise ValueError(f"submit_batch takes {self.B} frames, got {len(frames)}")
        if self._closed:
            raise RuntimeError("submit_batch on a closed BatchStream")
        if self._delta_broken:
            # a batch failed after the host references advanced: the resident
            # planes are stale, so this tick goes up raw
            self._delta_broken = False
            self._prev_staging = None
            self._prev_geom = None
            self._prev_frames = [None] * self.B
            self._pred_prev_crops = None
        ts0 = time.perf_counter()
        self._staging_i = (self._staging_i + 1) % self.N_PIPE
        self._wait_staging(self._staging_i)
        staging = self._staging[self._staging_i]
        metas = []
        changed = [True] * self.B
        all_unchanged = self.delta and self._prev_staging is not None
        for i, f in enumerate(frames):
            pf = self._prev_frames[i] if self.delta else None
            if pf is not None and self._prev_staging is not None and native.arrays_equal(pf, f):
                # an unchanged table: copy its slot rather than letterbox again
                if staging is not self._prev_staging:
                    staging[i] = self._prev_staging[i]
                self._slot_geom[(self._staging_i, i)] = "copied"
                metas.append(self._prev_metas[i])
                changed[i] = False
            else:
                metas.append(self._letterbox_into(staging[i], f, (self._staging_i, i)))
                all_unchanged = False
            if self.delta:
                self._prev_frames[i] = f
        geom = self._batch_geom(metas)
        ts1 = time.perf_counter()
        self.stage_stats["submit_letterbox"].append(ts1 - ts0)
        mode, payload, seg_bucket, rows = "raw", None, None, None
        if self.delta and self._prev_staging is not None:
            if all_unchanged or native.arrays_equal(staging, self._prev_staging):
                mode = "skip"
            elif geom is not None and self._prev_geom == geom:
                # the content-rows decodes leave the bars as they are: the
                # previous tick must have had this geometry
                if 0 < sum(changed) <= self._slots_max:
                    mode = "slots"
                else:
                    # a dense change: segs first; tribit when its payload is
                    # smaller and it fits; then tribit, then nibble
                    seg_res = self._encode_segs(staging, *geom)
                    tribit_bytes = self.B * geom[1] * (self.imgsz * 3 * 3 // 8 + 3)
                    if seg_res is not None and len(seg_res[0]) > tribit_bytes:
                        tri = self._encode_tribit(staging, *geom)
                        if tri is not None:
                            seg_res, payload, mode = None, tri, "tribit"
                    if seg_res is not None:
                        (payload, seg_bucket), mode = seg_res, "segs"
                    elif mode == "raw":
                        payload = self._encode_tribit(staging, *geom)
                        if payload is not None:
                            mode = "tribit"
                        else:
                            payload = self._encode_nibble(staging, *geom)
                            if payload is not None:
                                mode = "nibble"
                    rows = geom
            else:
                payload = self._encode_nibble(staging)
                if payload is not None:
                    mode, rows = "nibble", (0, self.imgsz)
        ts2 = time.perf_counter()
        self.stage_stats["submit_encode"].append(ts2 - ts1)
        item = {
            "frames": frames, "metas": metas, "mode": mode, "geom": geom,
            "staging": self._staging_t[self._staging_i],
            # every frame equal to the last tick's: the detector still runs on
            # the resident canvas, and the finisher returns the last results
            "memo": mode == "skip" and all_unchanged,
            "sync": {"uploaded": threading.Event(), "h2d": None},
            "evt": threading.Event(), "out": None, "err": None,
        }
        row_bytes = self.imgsz * 3
        if mode in ("nibble", "tribit"):
            item["rows"] = rows
            item["payload"] = self._nibbuf_t[self._staging_i][:payload.size]
        elif mode == "segs":
            tc = time.perf_counter()
            item["payload"], npk, item["pred"] = self._build_fused_payload(frames, payload,
                                                                           geom[1])
            self.stage_stats["submit_crops"].append(time.perf_counter() - tc)
            item["mode"] = "fused"
            item["fused"] = (*geom, seg_bucket, npk, payload.size)
            self._fused_buckets[(*geom, seg_bucket, npk)] = None
            self.crop_mode_counts["fused_segs" if npk >= 0 else "fused_raw"] += 1
        elif mode == "slots":
            item["slots"] = [i for i, c in enumerate(changed) if c]
        elif mode == "raw":
            item["mode"] = "raw_active" if geom is not None else "raw"
        if "payload" in item:
            sent = item["payload"].numel()
        elif mode == "slots":
            sent = len(item["slots"]) * geom[1] * row_bytes
        elif mode == "raw":
            sent = self.B * (geom[1] if geom is not None else self.imgsz) * row_bytes
        else:
            sent = 0
        self.mode_counts[mode] += 1
        # bytes this tick uploads (0 for skip), not a wall time
        self.stage_stats["payload_mb"].append(sent / 1e6)
        if self.delta:
            self._prev_staging = staging
            self._prev_metas = list(metas)
        if mode != "skip":
            self._prev_geom = geom
        self._staging_sync[self._staging_i] = item["sync"]
        self._pending.append(item)
        ts3 = time.perf_counter()
        self._dispatch_q.put(item)
        self.stage_stats["submit_queue"].append(time.perf_counter() - ts3)

    def collect_batch(self) -> List[List[Dict]]:
        """The oldest in-flight batch's results (waits for the finisher);
        raises what failed that batch."""
        item = self._pending.popleft()
        item["evt"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def prewarm_async(self) -> List[torch.Tensor]:
        """Warm what the first ticks would otherwise pay for, and return the
        outputs unread: the detector with the NMS kernel (its nvcc build and
        first launch) on the resident canvas, and the classifier on the
        resident predicted crop plane, which makes cuDNN choose its
        algorithms at both of the stream's batch shapes; and the pinned
        crop-plane payload pools, made here rather than at the first ticks
        that code a crop plane. Eager torch compiles no program per shape:
        the canvas pools are made at a geometry's first segs tick. Call it
        before the first ``submit_batch``; it changes no state a tick reads."""
        if self.delta:
            if self._pred_segs_bufs is None:
                self._pred_segs_bufs = self._crop_bufs()
            if self._crop_segs_bufs is None:
                self._crop_segs_bufs = self._crop_bufs()
        with _stream_ctx(self._stream):
            small, _ = self._detect_core(self._dev_canvas)
            return [small, self._classify_u8(self._dev_pred_crops)]

    def prewarm_buckets(self, spread: int = 1, deadline: float = None,
                        max_programs: int = 8) -> List[Tuple[int, int, int, int]]:
        """The (top, nh, canvas bucket, crop bucket) keys next to the fused
        ticks' ones so far (``spread`` canvas steps either way, and the raw
        crop plane), at most ``max_programs`` of them and none once
        ``time.perf_counter()`` passes ``deadline``. The JAX package compiles
        a decode program for each; eager torch has no program per bucket, so
        this dispatches nothing and changes no state of the stream: it only
        returns the keys."""
        out = []
        for (top, nh, npc, npk) in list(self._fused_buckets):
            bufs = self._segs_bufs.get(nh)
            cstep = bufs["step"] if bufs else None
            npcs = ([npc + i * cstep for i in range(-spread, spread + 1) if npc + i * cstep >= cstep]
                    if cstep else [npc])
            for c in npcs:
                for k in sorted({npk, -1}):
                    if len(out) >= max_programs or (deadline is not None
                                                    and time.perf_counter() > deadline):
                        return out
                    if (c, k) != (npc, npk):
                        out.append((top, nh, c, k))
        return out

    # -- dispatcher thread -----------------------------------------------------

    def _upload(self, item) -> None:
        """Bring the resident canvas's bytes, or this tick's payload, up (on
        the current stream)."""
        mode, dev, src = item["mode"], self._dev_canvas, item["staging"]
        if mode == "raw":
            dev.copy_(src, non_blocking=True)
        elif mode in ("raw_active", "slots"):
            top, nh = item["geom"]
            for b in (range(self.B) if mode == "raw_active" else item["slots"]):
                dev[b, top:top + nh].copy_(src[b, top:top + nh], non_blocking=True)
                dev[b, :top] = PAD
                dev[b, top + nh:] = PAD
        elif mode in ("nibble", "tribit", "fused"):
            item["wire"] = item.pop("payload").to(self.device, non_blocking=True)

    def _decode(self, item) -> None:
        """Rebuild the resident planes from this tick's payload (on the
        current stream)."""
        mode = item["mode"]
        if mode not in ("nibble", "tribit", "fused"):
            return
        B, S = self.B, self.imgsz
        wire = item.pop("wire")
        if mode == "fused":
            top, nh, npc, npk, n_c = item["fused"]
            canvas = _segs_decoder(B, S, S, top, nh, self._segw, npc)(wire[:n_c],
                                                                   self._dev_canvas)
            ns = B * self.max_rank
            if npk >= 0:
                crops = _segs_decoder(ns, CROP, CROP, 0, CROP, CROP, npk)(wire[n_c:],
                                                                         self._dev_pred_crops)
            else:
                crops = wire[n_c:n_c + ns * CROP * CROP * 3]
            self._dev_pred_crops = crops.view(ns, CROP, CROP, 3)
        else:
            decode = nibble_decode if mode == "nibble" else tribit_decode
            canvas = decode(wire, self._dev_canvas, B, S, S, *item["rows"])
        self._dev_canvas = canvas.view(B, S, S, 3)

    @torch.inference_mode()
    def _detect_core(self, canvas_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, S, 3) uint8 BGR canvases -> (packed u8 readback (B*R*12,),
        full f16 plane (B, max_det, 7)).

        The packed format, per frame and slot of the top R = readback_det:
        4 box corners clipped to [0, S] as round(x*16) in u16, the score as
        round(s*65535) in u16 (each u16 little-endian), the class in u8 and
        the count capped at R + 1 in u8: 12 bytes. The full plane (boxes,
        score, class, count in f16) is read only when a count exceeds R."""
        B, S, R = self.B, self.imgsz, self.readback_det
        x = canvas_u8.flip(-1).float() / 255.0
        raw = self.det_model(x)
        boxes, scores = yolov8.decode_boxes(raw, (S, S), self.det_model.spec.strides)
        det = nms_ops.nms_batch(boxes, scores, conf_thres=self.conf, iou_thres=self.iou,
                                pre_nms=512, max_det=self.max_det)
        q16 = torch.round(det.boxes[:, :R].clamp(0, S) * 16).to(torch.int32)
        sc = torch.round(det.scores[:, :R].clamp(0, 1) * 65535).to(torch.int32)
        u16 = torch.cat([q16, sc[..., None]], dim=-1)  # (B, R, 5)
        b2 = torch.stack([u16 & 0xFF, u16 >> 8], dim=-1).reshape(B, R, 10)
        cnt = torch.clamp(det.count, max=R + 1)[:, None, None].expand(B, R, 1)
        small = (torch.cat([b2, det.classes[:, :R, None], cnt], dim=-1) & 0xFF).to(U8)
        full = torch.cat([
            det.boxes, det.scores[..., None], det.classes[..., None].float(),
            det.count[:, None, None].float().expand(B, self.max_det, 1),
        ], dim=-1).to(torch.float16)
        return small.reshape(-1), full

    @torch.inference_mode()
    def _classify_u8(self, crops_u8: torch.Tensor) -> torch.Tensor:
        """u8 probabilities, round(p*255), of (N, 64, 64, 3) BGR crops on the
        card, flat; the classifier runs in f32."""
        x = crops_u8.flip(-1).float() / 255.0
        return torch.round(torch.softmax(self.cls_model(x), dim=-1) * 255).to(U8).reshape(-1)

    def _dispatcher(self) -> None:
        cuda = self._stream is not None
        while True:
            item = self._dispatch_q.get()
            if item is None:
                # forwarded, so that it lands after every batch already passed on
                self._finish_q.put(None)
                return
            t0 = time.perf_counter()
            try:
                with _stream_ctx(self._stream):
                    self._upload(item)
                    if cuda:
                        item["sync"]["h2d"] = torch.cuda.Event()
                        item["sync"]["h2d"].record()
                    item["sync"]["uploaded"].set()
                    self._decode(item)
                    small, item["full"] = self._detect_core(self._dev_canvas)
                    if item["mode"] == "fused":
                        small = torch.cat([small, self._classify_u8(self._dev_pred_crops)])
                    if cuda:
                        host = torch.empty(small.shape, dtype=U8, pin_memory=True)
                        host.copy_(small, non_blocking=True)
                        item["done"] = torch.cuda.Event()
                        item["done"].record()
                        item["readback"] = host
                    else:
                        item["readback"] = small
                self.stage_stats["dispatch"].append(time.perf_counter() - t0)
            except BaseException as e:  # raised again by collect_batch
                self._delta_broken = True
                item["err"] = e
                item["sync"]["uploaded"].set()
                item["evt"].set()
                continue
            self._finish_q.put(item)

    # -- finisher thread -------------------------------------------------------

    def _finisher(self) -> None:
        while True:
            item = self._finish_q.get()
            if item is None:
                return
            try:
                t0 = time.perf_counter()
                if item.get("done") is not None:
                    item["done"].synchronize()
                flat = item.pop("readback").numpy()
                self.stage_stats["fetch_wait"].append(time.perf_counter() - t0)
                if item["memo"] and self._last_out is not None:
                    item["out"] = _copy_results(self._last_out)
                    self.memo_hits += 1
                elif "pred" in item:
                    item["out"] = self._finish_batch_fused(item["frames"], item["metas"], flat,
                                                           item["pred"], item.pop("full"))
                else:
                    item["out"] = self._finish_batch(item["frames"], item["metas"], flat,
                                                     item.pop("full"))
                self._last_out = _copy_results(item["out"])
            except BaseException as e:  # raised again by collect_batch
                self._delta_broken = True
                self._prev_crops = None
                self._last_cls_probs = None
                item["err"] = e
            item.pop("full", None)
            item["evt"].set()

    @staticmethod
    def _rect_iou(a, b) -> float:
        """IoU of two (ys, xs, ye, xe) rects."""
        iy = min(a[2], b[2]) - max(a[0], b[0])
        ix = min(a[3], b[3]) - max(a[1], b[1])
        if iy <= 0 or ix <= 0:
            return 0.0
        inter = iy * ix
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
        return inter / max(ua - inter, 1)

    @staticmethod
    def _gather_crop_u8(frame: np.ndarray, rect) -> Optional[np.ndarray]:
        """64x64 classifier crop at ``rect`` (ys, xs, ye, xe): the short side
        scaled to 64 (cv2's INTER_LINEAR), then the center cut."""
        ys, xs, ye, xe = rect
        crop = frame[ys:ye, xs:xe]
        if crop.size == 0:
            return None
        ch, cw = crop.shape[:2]
        s = CROP / min(ch, cw)
        nh, nw = max(CROP, round(ch * s)), max(CROP, round(cw * s))
        resized = native.resize_u8(crop, (nh, nw))
        t, l = (nh - CROP) // 2, (nw - CROP) // 2
        return resized[t:t + CROP, l:l + CROP]

    def _assemble_dets(self, frames, metas, packed):
        """Per-frame detection dicts and rank-crop candidates: (class id,
        hysteresis-stable rect, detection index), in class-id-then-rect
        order, at most max_rank per frame."""
        results: List[List[Dict]] = []
        all_cands: List[List[Tuple]] = []
        p = self.crop_pad
        for bi in range(self.B):
            frame = frames[bi]
            r, (top, left), _ = metas[bi]
            n = int(packed[bi, 0, 6])
            h, w = frame.shape[:2]
            boxes = (packed[bi, :n, :4] - [left, top, left, top]) / r
            np.clip(boxes, 0, [w, h, w, h], out=boxes)
            results.append([
                {
                    "class_id": int(packed[bi, i, 5]),
                    "class_name": self.names.get(int(packed[bi, i, 5]), "?"),
                    "bbox": [int(v) for v in boxes[i]],
                    "conf": round(float(packed[bi, i, 4]), 3),
                    "ocr_text": "",
                }
                for i in range(n)
            ])
            cands = []
            for i in range(n):
                cid = int(packed[bi, i, 5])
                if cid not in self._rank_ids:
                    continue
                x1, y1, x2, y2 = boxes[i]
                rect = self._stable_rect(
                    cid, (max(0, int(y1) - p), max(0, int(x1) - p), int(y2) + p, int(x2) + p))
                cands.append((cid, rect, i))
            cands.sort(key=lambda c: c[:2])
            all_cands.append(cands[: self.max_rank])
        return results, all_cands

    def _apply_rank_prob(self, results, bi, di, prob_row) -> None:
        if prob_row.dtype == np.uint8:  # u8 wire probabilities
            prob_row = prob_row.astype(np.float32) / 255.0
        text = rank_text(prob_row, results[bi][di]["class_name"], self.rank_names)
        if text:
            results[bi][di]["ocr_text"] = text

    def _publish_pred_rects(self, all_cands) -> None:
        """Hand this tick's (class id, rect) pairs to the submit thread as the
        next ticks' crop predictions (a list swap). A pair not seen again
        stays predicted for 6 ticks, so that a detection flickering out comes
        back as a hit; surviving pairs keep their slots (the crop-plane delta
        stays aligned), new ones fill the tail up to max_rank; pairs of one
        class whose rects overlap at IoU >= 0.6 keep one slot (the
        near-miss acceptance of ``_finish_batch_fused`` serves the others)."""
        out, ages_out = [], []
        for bi, cands in enumerate(all_cands):
            cur = [(cid, rect) for cid, rect, _ in cands]
            curset = set(cur)
            ages = self._pred_ages[bi]
            merged = []

            def near_dup(p):
                return any(q[0] == p[0] and self._rect_iou(q[1], p[1]) >= 0.6 for q in merged)

            for p in self._pred_rects[bi]:
                if p in curset:
                    ages[p] = 0
                    if not near_dup(p):
                        merged.append(p)
                else:
                    a = ages.get(p, 0) + 1
                    if a <= 6:
                        ages[p] = a
                        if not near_dup(p):
                            merged.append(p)
            for p in cur:
                if p not in merged and not near_dup(p):
                    ages[p] = 0
                    merged.append(p)
            merged = merged[: self.max_rank]
            out.append(merged)
            ages_out.append({p: ages.get(p, 0) for p in merged})
        self._pred_rects = out
        self._pred_ages = ages_out

    def _unpack_dets(self, flat_u8: np.ndarray, full: torch.Tensor) -> np.ndarray:
        """The packed readback -> (B, n, 7) f32 [x1, y1, x2, y2, score, class,
        count]; the full f16 plane instead when a frame's count exceeds
        readback_det (counted in readback_overflows)."""
        arr = flat_u8[: self._nd_flat].reshape(self.B, self.readback_det, 12)
        cnt = arr[:, 0, 11]
        if (cnt > self.readback_det).any():
            self.readback_overflows += 1
            return full.cpu().numpy().astype(np.float32).reshape(self.B, self.max_det, 7)
        u16 = (arr[:, :, :10].copy().view(np.uint16)
               .reshape(self.B, self.readback_det, 5).astype(np.float32))
        out = np.empty((self.B, self.readback_det, 7), np.float32)
        out[:, :, :4] = u16[:, :, :4] / 16.0
        out[:, :, 4] = u16[:, :, 4] / 65535.0
        out[:, :, 5] = arr[:, :, 10]
        out[:, :, 6] = cnt.astype(np.float32)[:, None]
        return out

    def _finish_batch(self, frames, metas, flat_np, full):
        """Unpack the readback, cut the rank crops, classify them and apply
        the rank texts; publish the crop predictions."""
        t1 = time.perf_counter()
        packed = self._unpack_dets(flat_np, full)
        results, all_cands = self._assemble_dets(frames, metas, packed)
        crops = np.zeros((self.B * self.max_rank, CROP, CROP, 3), np.uint8)
        crop_refs: List[Tuple[int, Tuple[int, int]]] = []  # (crop slot, (frame, detection))
        for bi, cands in enumerate(all_cands):
            for j, (_cid, rect, i) in enumerate(cands):
                c = self._gather_crop_u8(frames[bi], rect)
                if c is None:
                    continue
                slot = bi * self.max_rank + j
                crops[slot] = c
                crop_refs.append((slot, (bi, i)))
        if crop_refs:
            t2 = time.perf_counter()
            probs = self._classify_crops(crops).reshape(self.B * self.max_rank, -1)
            self.stage_stats["classify"].append(time.perf_counter() - t2)
            for row, (bi, di) in crop_refs:
                self._apply_rank_prob(results, bi, di, probs[row])
        self._publish_pred_rects(all_cands)
        self.stage_stats["finish_tail"].append(time.perf_counter() - t1)
        return results

    def _finish_batch_fused(self, frames, metas, flat_np, pred, full):
        """A fused tick's tail: the readback carries the u8 probabilities of
        the predicted crops. A detection whose stable rect is its frame's
        prediction (or, as the taxonomy has one field per class, overlaps a
        prediction of its class at IoU >= 0.6 with centers within 4 crop pads
        on each axis) takes that row; the others (new or moved cards) are
        cut and classified here, in a bucket of 8, 32 or B*max_rank crops."""
        t1 = time.perf_counter()
        packed = self._unpack_dets(flat_np, full)
        fused_probs = flat_np[self._nd_flat:].reshape(self.B * self.max_rank, -1)
        results, all_cands = self._assemble_dets(frames, metas, packed)
        miss_crops = None
        miss_refs: List[Tuple[int, int]] = []
        for bi, cands in enumerate(all_cands):
            slot_of = {cr: j for j, cr in enumerate(pred[bi])}
            for cid, rect, i in cands:
                j = slot_of.get((cid, rect))
                if j is None:
                    for (pcid, prect), jj in slot_of.items():
                        if (pcid == cid and self._rect_iou(prect, rect) >= 0.6
                                and abs((prect[0] + prect[2]) - (rect[0] + rect[2]))
                                <= 4 * self.crop_pad
                                and abs((prect[1] + prect[3]) - (rect[1] + rect[3]))
                                <= 4 * self.crop_pad):
                            j = jj
                            break
                if j is not None and j < self.max_rank:
                    self.fused_hits += 1
                    self._apply_rank_prob(results, bi, i, fused_probs[bi * self.max_rank + j])
                    continue
                self.fused_misses += 1
                c = self._gather_crop_u8(frames[bi], rect)
                if c is None:
                    continue
                if miss_crops is None:
                    miss_crops = np.zeros((self.B * self.max_rank, CROP, CROP, 3), np.uint8)
                k = len(miss_refs)
                if k >= self.B * self.max_rank:
                    break
                miss_crops[k] = c
                miss_refs.append((bi, i))
        if miss_refs:
            self.fallback_batches += 1
            n = len(miss_refs)
            ns = 8 if n <= 8 else 32 if n <= 32 else self.B * self.max_rank
            t2 = time.perf_counter()
            with _stream_ctx(self._cls_stream):
                probs = self._probs_u8(self._classify_probs(miss_crops[:ns])).reshape(ns, -1)
            self.stage_stats["classify"].append(time.perf_counter() - t2)
            for row, (bi, di) in enumerate(miss_refs):
                self._apply_rank_prob(results, bi, di, probs[row])
        self._publish_pred_rects(all_cands)
        self.stage_stats["finish_tail"].append(time.perf_counter() - t1)
        return results

    def _stable_rect(self, cid: int, rect: Tuple[int, int, int, int]):
        """Crop-rect hysteresis: a rect within the pad margin of a recently
        used one of the same class reuses that one verbatim, so static content
        gives byte-stable crops and a deterministic classifier input. The
        per-class lists (most recent first, at most 8) keep tables with the
        same class apart by proximity."""
        cache = self._rect_cache.setdefault(cid, [])
        tol = self.crop_pad
        for k, r in enumerate(cache):
            if (abs(r[0] - rect[0]) <= tol and abs(r[1] - rect[1]) <= tol
                    and abs(r[2] - rect[2]) <= tol and abs(r[3] - rect[3]) <= tol):
                if k:
                    cache.insert(0, cache.pop(k))
                return r
        cache.insert(0, rect)
        del cache[8:]
        return rect

    @torch.inference_mode()
    def _classify_probs(self, crops) -> torch.Tensor:
        """f32 softmax probabilities of (N, 64, 64, 3) BGR crops: a uint8
        array, or a uint8 tensor on the stream's device."""
        x = torch.as_tensor(crops).to(self.device).flip(-1).float() / 255.0
        return torch.softmax(self.cls_model(x), dim=-1)

    @staticmethod
    def _probs_u8(probs: torch.Tensor) -> np.ndarray:
        return torch.round(probs * 255).to(U8).reshape(-1).cpu().numpy()

    @torch.inference_mode()
    def _classify_crops(self, crops: np.ndarray) -> np.ndarray:
        """u8 probabilities, round(p*255), of the (B*max_rank, 64, 64, 3) BGR
        crop plane, classified in f32. With ``delta`` the plane is coded
        against the last classified one: byte-identical, the last
        probabilities again (skip); else its segs payload when that pays,
        decoded on the card against the resident last plane (segs); else the
        plane itself (raw)."""
        ns = self.B * self.max_rank
        if self.delta and self._prev_crops is not None:
            if native.arrays_equal(crops, self._prev_crops):
                self.crop_mode_counts["skip"] += 1
                return self._last_cls_probs
            enc = self._encode_crop_segs(crops)
            if enc is not None:
                payload, npb = enc
                self.crop_mode_counts["segs"] += 1
                with _stream_ctx(self._cls_stream):
                    wire = payload.to(self.device, non_blocking=True)
                    cur = _segs_decoder(ns, CROP, CROP, 0, CROP, CROP, npb)(
                        wire, self._dev_prev_crops).view(ns, CROP, CROP, 3)
                    out = self._probs_u8(self._classify_probs(cur))
                self._dev_prev_crops, self._prev_crops, self._last_cls_probs = cur, crops, out
                return out
        self.crop_mode_counts["raw"] += 1
        with _stream_ctx(self._cls_stream):
            dev = torch.from_numpy(crops).to(self.device)
            out = self._probs_u8(self._classify_probs(dev))
        if self.delta:
            self._dev_prev_crops, self._prev_crops, self._last_cls_probs = dev, crops, out
        return out

    # -- bookkeeping -----------------------------------------------------------

    def stage_summary(self, skip: int = 0) -> Dict[str, Dict[str, float]]:
        """Per-stage wall time in ms (mean, p50, max over the recorded
        batches, less the first ``skip``); byte and count records left out."""
        out = {}
        for k, v in list(self.stage_stats.items()):
            if k in ("payload_mb", "canvas_mb", "crops_mb", "canvas_seg_counts"):
                continue
            lv = list(v)
            vs = sorted(lv[skip:] if len(lv) > skip else lv)
            if not vs:
                continue
            out[k] = {
                "mean_ms": round(1e3 * sum(vs) / len(vs), 2),
                "p50_ms": round(1e3 * vs[len(vs) // 2], 2),
                "max_ms": round(1e3 * vs[-1], 2),
                "n": len(vs),
            }
        return out

    def reset_stage_stats(self) -> None:
        """Forget the stage records, e.g. between a warm-up and a timed window."""
        self.stage_stats.clear()

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def close(self) -> None:
        """Stop the pipeline threads (idempotent). Batches not collected yet
        are dropped."""
        if self._closed:
            return
        self._closed = True
        # one sentinel, passed down the chain, so it never overtakes a batch
        self._dispatch_q.put(None)
        self._dispatch_thread.join(timeout=30)
        self._finish_thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load_params(detector_weights: str, classifier_weights: str) -> Dict:
    """The constructor arguments of both classes: folded parameter trees,
    specs and class names, from a native ``.npz`` detector and a native
    ``.npz`` or ultralytics ``.pt`` classifier."""
    det_params, det_meta = load_params(detector_weights)
    sp = det_meta.get("spec", {})
    det_spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
    names = {int(k): v for k, v in det_meta.get("names", {}).items()} or taxonomy.CLASSES
    cls_params, cls_spec, rank_names = load_classifier_tree(classifier_weights)
    return dict(det_params=yolov8.fold_params(det_params, det_spec), det_spec=det_spec,
                cls_params=cls_params, cls_spec=cls_spec,
                names=names, rank_names=rank_names)


def load_streaming_engine(detector_weights: str, classifier_weights: str,
                          **kwargs) -> StreamingEngine:
    """A StreamingEngine from a native ``.npz`` detector and a native ``.npz`` or
    ultralytics ``.pt`` classifier; ``kwargs`` go to the constructor
    (``device`` defaults to ``cuda``)."""
    return StreamingEngine(**_load_params(detector_weights, classifier_weights), **kwargs)


def load_batch_stream(detector_weights: str, classifier_weights: str,
                      **kwargs) -> BatchStream:
    """A BatchStream from a native ``.npz`` detector and a native ``.npz`` or
    ultralytics ``.pt`` classifier; ``kwargs`` go to the constructor
    (``device`` defaults to ``cuda``)."""
    return BatchStream(**_load_params(detector_weights, classifier_weights), **kwargs)
