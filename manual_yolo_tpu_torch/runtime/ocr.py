"""OCR engine: device preprocessing variants + CRNN ensemble + allowlist CTC
decode, with host prefix-beam refinement and a CRAFT multi-line fallback.

Counterpart of ``manual_yolo_tpu/runtime/ocr.py``. Per field kind, every crop
is preprocessed on the host onto each geometry group's canvas, then on the
device into four variants (CLAHE / Otsu / raw / deskewed + CLAHE), read by
every CRNN of the group and greedy-decoded under every allowlist mask of the
kind; all candidates compete on confidence. Reads that fail validation or
win below the kind's escalation threshold go through the host CTC prefix
beam and the ensemble-summed rescore (``ops/ctc.py``, C++).

Differences from the JAX package, by design:

  * the engine lives on one device (``cuda`` unless the caller passes
    ``device="cpu"``) and runs in f32 with TF32 off;
  * there is no ``prewarm_async`` and no power-of-two batch bucketing: both
    exist to bound XLA compiles, and PyTorch runs eagerly. Calls are still
    chunked at ``MAX_CHUNK`` crops;
  * ``read_fields_conf`` counts every error it catches in ``errors`` (and
    reports it on stderr), so a caller can require that none occurred;
  * device calls and the host beam are marked with ``record_function``
    ranges (``ocr_recognize/<kind>``, ``ocr_beam_rescore/<kind>``,
    ``ocr_craft``) for profiler traces.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, resolve_weight_path
from manual_yolo_tpu_torch.game.text import (
    extract_card_value,
    extract_name,
    extract_numeric_value,
    normalize_rank_text,
)
from manual_yolo_tpu_torch.models import craft as craft_mod
from manual_yolo_tpu_torch.models import crnn
from manual_yolo_tpu_torch.ops import ctc as ctc_ops
from manual_yolo_tpu_torch.ops import image as img_ops
from manual_yolo_tpu_torch.runtime import native

NUMERIC_ALLOW = "0123456789.,kKmMbBlL$"  # L = lakh (the UI shows "4.55L")
# the name allowlist plus interior "."/"-": real usernames show them
NAME_ALLOW = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-"
)
# the strict name allowlist, decoded alongside the extended one (same
# logits, two masks) so a spurious dot/dash never costs a read
STRICT_NAME_ALLOW = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
CARD_ALLOW = "AKQJT2345678910SHDCshdc"
# game ids are alnum/underscore
GAME_ID_ALLOW = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)

#: Default recognizer ensemble: two 32-px members and the 64-px member
#: (kind-gated in its meta to name and game_id).
DEFAULT_RECOGNIZER_WEIGHTS = (
    "weights/crnn_real_a.npz,weights/crnn_real_b.npz,weights/crnn_h64.npz"
)


def field_kind(class_name: str) -> str:
    """Map a detection class to its OCR field kind."""
    low = class_name.lower()
    if low.endswith("_rank"):
        return "card"
    if low == "game_id":
        return "game_id"
    if low.endswith("_bet") or low.endswith("_stack") or low in (
        "my_bet", "my_stack", "total_pot", "iinput_field"
    ):
        return "numeric"
    if low.endswith("_name"):
        return "name"
    return "generic"


@dataclass
class _Group:
    """Recognizers sharing one input canvas (img_h, width); ``kinds`` (None =
    all) restricts the group to those field kinds."""

    models: List[crnn.CRNN]
    width: int
    img_h: int
    kinds: Optional[FrozenSet[str]] = None


class OCREngine:
    """CRNN-backed OCR with the multi-pass confidence policy."""

    # enhanced / otsu / raw / deskewed, batched into one recognizer call
    N_VARIANTS = 4
    # vision-LLM failure gates per kind (the JAX package's calibration)
    LLM_GATE = {"name": 0.97, "game_id": 0.97, "numeric": 0.97,
                "card": 0.0, "generic": 0.0}
    # collapse detector (name/game_id): a validated read far shorter than the
    # crop width supports gets its confidence demoted below every gate
    COLLAPSE_FLOOR = 0.30
    COLLAPSE_KINDS = ("name", "game_id")
    MAX_CHUNK = 128

    def __init__(
        self,
        models: Union[crnn.CRNN, Sequence[crnn.CRNN]],
        width: int = 256,
        text_detector: Optional[craft_mod.CRAFT] = None,
        img_h: int = 32,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        native.library()  # the beam's host library: a build failure raises here
        self._groups: List[_Group] = []
        self._add_group(list(models) if isinstance(models, (list, tuple)) else [models],
                        width, img_h)
        # per kind: an (M, C) stack of allowlist masks, padded to one M by
        # repeating the primary mask (duplicate candidates are dropped on host)
        masks = {
            "numeric": [NUMERIC_ALLOW],
            "name": [NAME_ALLOW, STRICT_NAME_ALLOW],
            "card": [CARD_ALLOW],
            "game_id": [GAME_ID_ALLOW],
            "generic": [None],
        }
        m_max = max(len(v) for v in masks.values())
        self._masks = {
            k: torch.from_numpy(np.stack(
                [ctc_ops.allowlist_mask(a) for a in v + v[:1] * (m_max - len(v))]
            )).to(self.device)
            for k, v in masks.items()
        }
        # host prefix-beam + ensemble-rescore refinement (self.beam = False
        # turns it off); read_fields escalates per kind: numeric reads beam
        # only below 0.90 confidence, the other kinds always
        self.beam = True
        self.beam_width = 8
        self.beam_escalate_conf = {"numeric": 0.90}
        self.craft = None if text_detector is None else text_detector.to(self.device).eval()
        self.errors = 0

    def _add_group(self, models: List[crnn.CRNN], width: int, img_h: int,
                   kinds=None) -> None:
        """Register a geometry group of recognizers sharing a canvas; each group
        is its own device call and candidates from every group compete on the
        host. ``kinds`` gates the group to those field kinds."""
        self._groups.append(_Group(
            [m.to(self.device).eval() for m in models], width, img_h,
            frozenset(kinds) if kinds else None,
        ))

    def _groups_for(self, kind: str) -> List[_Group]:
        """Groups competing for this field kind (kind-gated members sit out);
        every group if the gating excluded them all."""
        gs = [g for g in self._groups if g.kinds is None or kind in g.kinds]
        return gs or self._groups

    @classmethod
    def from_npz(cls, path, text_detector: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda") -> "OCREngine":
        """``path``: one npz path, or a list/comma-separated string of paths ->
        ensemble. Members whose (width, img_h, kinds) differ land in their own
        group. ``text_detector`` names CRAFT weights; a missing file gives a
        recognizer-only engine."""
        dev = resolve_device(device)
        paths = [p for p in path.split(",") if p] if isinstance(path, str) else list(path)
        by_geom: Dict[Tuple[int, int, Any], List[crnn.CRNN]] = {}
        for p in paths:
            params, meta = load_params(p)
            kinds = meta.get("kinds") or None
            if isinstance(kinds, str):
                kinds = tuple(sorted(k for k in kinds.split(",") if k))
            geom = (int(meta.get("width", 256)), int(meta.get("img_h", 32)), kinds)
            by_geom.setdefault(geom, []).append(crnn.from_jax_params(params, dev))
        td = None
        if text_detector:
            text_detector = resolve_weight_path(text_detector)
            if os.path.exists(text_detector):
                td = craft_mod.load_npz(text_detector, dev)
        (w0, h0, k0), *rest = by_geom
        eng = cls(by_geom[(w0, h0, k0)], width=w0, img_h=h0, text_detector=td, device=dev)
        if k0:
            eng._groups[0].kinds = frozenset(k0)
        for geom in rest:
            eng._add_group(by_geom[geom], geom[0], geom[1], kinds=geom[2])
        return eng

    # -- device program ----------------------------------------------------

    def _variants(self, gray: torch.Tensor) -> torch.Tensor:
        """(N, H, W) -> (N, 4, H, W): enhanced / otsu / identity / deskewed."""
        enhanced = img_ops.clahe(gray, clip_limit=2.0)
        otsu = img_ops.otsu_binarize(gray)
        deskewed = img_ops.clahe(img_ops.deskew(gray), clip_limit=2.0)
        return torch.stack([enhanced, otsu, gray, deskewed], dim=1)

    def _run_parts(self, group: _Group, gray: torch.Tensor, masks: torch.Tensor):
        """gray (N, H, W), masks (M, C) -> (ids (N, K*M*V, T), conf (N, K*M*V),
        logits (K, N*V, T, C)): K recognizers of the group, M allowlist decodes
        of each one's logits, V variants."""
        var = self._variants(gray)
        n, v, h, w = var.shape
        flat = var.reshape(n * v, h, w, 1)
        logits = torch.stack([m(flat) for m in group.models])  # (K, N*V, T, C)
        k, m = logits.shape[0], masks.shape[0]
        # every mask's decode is scored under the PRIMARY mask's softmax, so
        # that confidences compare across masks
        decoded = [ctc_ops.greedy_decode(logits[ki], masks[mi], score_mask=masks[0])
                   for ki in range(k) for mi in range(m)]
        ids = torch.stack([d[0] for d in decoded])  # (K*M, N*V, T)
        conf = torch.stack([d[1] for d in decoded])  # (K*M, N*V)
        ids = ids.reshape(k * m, n, v, -1).permute(1, 0, 2, 3).reshape(n, k * m * v, -1)
        conf = conf.reshape(k * m, n, v).permute(1, 0, 2).reshape(n, k * m * v)
        return ids, conf, logits

    def _run_logp(self, group: _Group, gray: torch.Tensor, masks: torch.Tensor):
        """``_run_parts`` plus every recognizer's log-probs at each crop's
        winning variant, (N, K, T, C), log-softmaxed under the primary mask
        (the widest allowlist of the kind), for the host beam and rescore."""
        ids, conf, logits = self._run_parts(group, gray, masks)
        n = gray.shape[0]
        vv = torch.argmax(conf, dim=1) % self.N_VARIANTS
        sel = logits[:, torch.arange(n, device=gray.device) * self.N_VARIANTS + vv]
        logp = torch.log_softmax(sel + masks[0][None, None, None, :], dim=-1)
        return ids, conf, logp.permute(1, 0, 2, 3)

    @torch.inference_mode()
    def _run(self, group: _Group, batch: np.ndarray, kind: str, logp: bool) -> Tuple:
        """Run a group over host canvases (N, H, W) in chunks of MAX_CHUNK
        crops; returns the per-crop outputs as numpy arrays."""
        masks = self._masks[kind]
        fn = self._run_logp if logp else self._run_parts
        parts = []
        with record_function(f"ocr_recognize/{kind}"):
            for s in range(0, batch.shape[0], self.MAX_CHUNK):
                gray = torch.from_numpy(batch[s:s + self.MAX_CHUNK]).to(self.device)
                res = fn(group, gray, masks)
                res = res if logp else res[:2]
                parts.append([r.cpu().numpy() for r in res])
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(len(parts[0])))

    # -- host API ----------------------------------------------------------

    @staticmethod
    def _kind_pad(kind: str):
        """Per-kind lateral background pad for preprocess_gray: game_id crops
        are long and edge-tight and gain from a wider blank lead-in."""
        if kind == "game_id":
            return lambda h: max(4, h // 4)
        return lambda h: None  # preprocess default (h // 8)

    def _pre_batch(self, group: _Group, crops_gray, kind: str) -> np.ndarray:
        """Stack variable-size gray crops onto a group's input canvas."""
        kpad = self._kind_pad(kind)
        return np.stack([
            crnn.preprocess_gray(c, group.width, pad=kpad(c.shape[0]), img_h=group.img_h)
            for c in crops_gray
        ])

    def read_batch(
        self, crops_gray: List[np.ndarray], kind: str = "generic",
        min_confidence: float = 0.35,
    ) -> List[Tuple[str, float]]:
        """Batch of variable-size gray crops -> [(text, confidence)]; per crop
        the highest-confidence candidate wins."""
        if not crops_gray:
            return []
        best: List[Tuple[str, float]] = [("", -1.0)] * len(crops_gray)
        for g in self._groups_for(kind):
            ids, conf = self._run(g, self._pre_batch(g, crops_gray, kind), kind, logp=False)
            for i in range(len(crops_gray)):
                j = int(np.argmax(conf[i]))
                c = float(conf[i, j])
                if c > best[i][1]:
                    best[i] = (ctc_ops.decode_to_text(ids[i, j]), c)
        return [(t, c) if c >= min_confidence else ("", c) for t, c in best]

    def read_batch_candidates(
        self, crops_gray: List[np.ndarray], kind: str = "generic",
        beam: Optional[bool] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Like :meth:`read_batch` but returns ALL decode candidates per crop
        (every variant x every mask x every recognizer), confidence-descending
        and deduplicated by text.

        With ``beam``, each recognizer's winning-variant log-probs are
        prefix-beam searched on the host, the pool (beams + greedy texts) is
        rescored by the ensemble-summed CTC forward score, and candidates come
        in that order first."""
        if not crops_gray:
            return []
        if beam is None:
            beam = self.beam
        n = len(crops_gray)
        groups = self._groups_for(kind)
        g_ids, g_conf, g_logps = [], [], []
        for g in groups:
            res = self._run(g, self._pre_batch(g, crops_gray, kind), kind, logp=beam)
            g_ids.append(res[0])
            g_conf.append(res[1])
            if beam:
                g_logps.append(res[2])
        out = []
        with record_function(f"ocr_beam_rescore/{kind}") if beam else contextlib.nullcontext():
            for i in range(n):
                # global candidate order across groups, confidence-descending;
                # stable: on ties the primary group's primary mask comes first
                flat = [(gi, j) for gi in range(len(groups)) for j in range(g_conf[gi].shape[1])]
                flat.sort(key=lambda t: -float(g_conf[t[0]][i, t[1]]))
                cands: List[Tuple[str, float]] = []
                seen = set()
                if beam:
                    best_conf = float(g_conf[flat[0][0]][i, flat[0][1]])
                    pool: Dict[Tuple[int, ...], None] = {}
                    for lp in g_logps:
                        for k in range(lp.shape[1]):
                            for pfx, _ in ctc_ops.prefix_beam_decode(
                                lp[i, k], beam_width=self.beam_width
                            ):
                                pool.setdefault(pfx)
                    for gi, j in flat:
                        pool.setdefault(tuple(int(x) for x in g_ids[gi][i, j] if x > 0))
                    pool_list = list(pool)
                    totals = np.zeros(len(pool_list), np.float64)
                    for lp in g_logps:
                        for k in range(lp.shape[1]):
                            totals += ctc_ops.score_candidates(lp[i, k], pool_list)
                    order = sorted(range(len(pool_list)),
                                   key=lambda j: (-totals[j], pool_list[j]))
                    for oi in order:
                        text = "".join(crnn.CHARSET[c - 1] for c in pool_list[oi])
                        if text not in seen:
                            seen.add(text)
                            cands.append((text, best_conf))
                for gi, j in flat:
                    text = ctc_ops.decode_to_text(g_ids[gi][i, j])
                    if text in seen:
                        continue
                    seen.add(text)
                    cands.append((text, float(g_conf[gi][i, j])))
                out.append(cands)
        return out

    @staticmethod
    def _to_gray(crop_bgr: np.ndarray) -> np.ndarray:
        if crop_bgr.ndim == 3:
            return np.asarray(
                0.114 * crop_bgr[..., 0] + 0.587 * crop_bgr[..., 1]
                + 0.299 * crop_bgr[..., 2],
                np.float32,
            ) / 255.0
        return crop_bgr.astype(np.float32) / 255.0

    @staticmethod
    def _validate(kind: str, class_name_low: str, text: str) -> Optional[str]:
        """Per-kind validation/normalisation."""
        if kind == "card":
            if class_name_low.endswith("_rank"):
                return normalize_rank_text(text) or None
            return extract_card_value(text)
        if kind == "numeric":
            return extract_numeric_value(text)
        if kind == "name":
            return extract_name(text)
        if kind == "game_id":
            # the crop reads "| Game ID : <digits>"; the id is the digit run
            m = re.findall(r"\d{6,}", text)
            if m:
                return m[-1]
            return extract_name(text)
        return text or None

    @staticmethod
    def _field_threshold(class_name_low: str, min_confidence: float) -> float:
        if "turn" in class_name_low or "river" in class_name_low:
            return min(min_confidence, 0.15)
        return min_confidence

    def read_field(
        self, crop_bgr: np.ndarray, class_name: str,
        min_confidence: float = 0.35,
    ) -> Optional[str]:
        """Single-field read with validation/normalisation."""
        if crop_bgr is None or crop_bgr.size == 0:
            return None
        kind = field_kind(class_name)
        low = class_name.lower()
        cands, = self.read_batch_candidates([self._to_gray(crop_bgr)], kind)
        return self._pick_validated(kind, low, cands, self._field_threshold(low, min_confidence))

    @classmethod
    def _pick_validated(
        cls, kind: str, low: str, cands: List[Tuple[str, float]], thr: float
    ) -> Optional[str]:
        """First candidate (confidence-descending) above threshold that passes
        per-kind validation."""
        return cls._pick_validated_conf(kind, low, cands, thr)[0]

    @classmethod
    def _pick_validated_conf(
        cls, kind: str, low: str, cands: List[Tuple[str, float]], thr: float
    ) -> Tuple[Optional[str], float]:
        """:meth:`_pick_validated` plus the winning candidate's confidence
        (-1.0 when nothing validated)."""
        for text, conf in cands:
            if conf < thr:
                return None, -1.0
            v = cls._validate(kind, low, text)
            if v:
                return v, conf
        return None, -1.0

    # the engine itself is usable where a read_field callable is expected
    __call__ = read_field

    def read_region(
        self,
        img_bgr: np.ndarray,
        kind: str = "generic",
        min_confidence: float = 0.35,
        text_threshold: float = 0.7,
    ) -> List[Tuple[Tuple[int, int, int, int], str, float]]:
        """CRAFT text detection over a region, then one batched CRNN read of
        every found line: [(box_xyxy, text, confidence)] top to bottom. Without
        a text detector, a single-line read of the whole region."""
        gray = self._to_gray(img_bgr)
        if self.craft is None:
            (text, conf), = self.read_batch([gray], kind, min_confidence=0.0)
            h, w = gray.shape[:2]
            return [((0, 0, w, h), text, conf)] if conf >= min_confidence else []

        h, w = img_bgr.shape[:2]
        # CRAFT input: multiple of 32, modest canvas
        side = int(np.clip(max(h, w), 64, 512))
        side = (side + 31) // 32 * 32
        rgb = img_bgr[..., ::-1].astype(np.float32) / 255.0
        canvas = np.zeros((side, side, 3), np.float32)
        s = min(side / h, side / w)
        nh, nw = max(1, round(h * s)), max(1, round(w * s))
        canvas[:nh, :nw] = img_ops.cv_resize(rgb, (nh, nw), cubic=False)
        with torch.inference_mode(), record_function("ocr_craft"):
            scores = self.craft(torch.from_numpy(canvas[None]).to(self.device))[0].cpu().numpy()
        boxes = craft_mod.text_regions_from_scores(scores, text_threshold=text_threshold)
        # map back to source pixels, pad a little, read all lines in ONE call
        out_boxes = []
        line_crops = []
        for (x1, y1, x2, y2) in sorted(boxes, key=lambda b: (b[1], b[0])):
            sx1 = max(0, int(x1 / s) - 2)
            sy1 = max(0, int(y1 / s) - 2)
            sx2 = min(w, int(x2 / s) + 2)
            sy2 = min(h, int(y2 / s) + 2)
            if sx2 - sx1 < 3 or sy2 - sy1 < 3:
                continue
            out_boxes.append((sx1, sy1, sx2, sy2))
            line_crops.append(gray[sy1:sy2, sx1:sx2])
        if not line_crops:
            return []
        reads = self.read_batch(line_crops, kind, min_confidence=0.0)
        return [(b, t, c) for b, (t, c) in zip(out_boxes, reads) if c >= min_confidence and t]

    def read_fields(
        self,
        crops_bgr: List[Optional[np.ndarray]],
        class_names: List[str],
        min_confidence: float = 0.35,
    ) -> List[Optional[str]]:
        """Batched :meth:`read_field`: one recognizer call per field kind."""
        return [t for t, _ in self.read_fields_conf(crops_bgr, class_names, min_confidence)]

    def read_fields_conf(
        self,
        crops_bgr: List[Optional[np.ndarray]],
        class_names: List[str],
        min_confidence: float = 0.35,
    ) -> List[Tuple[Optional[str], float]]:
        """:meth:`read_fields` plus each field's winning-candidate confidence
        (-1.0 when unread): greedy first, the beam for failed or
        low-confidence reads, the CRAFT fallback for empty tall crops, and the
        collapse demotion. An error inside one kind's reads leaves that kind
        unread, as in the JAX package, and adds one to ``self.errors``."""
        out: List[Optional[str]] = [None] * len(class_names)
        confs: List[float] = [-1.0] * len(class_names)
        groups: Dict[str, List[int]] = {}
        grays: List[Optional[np.ndarray]] = []
        shapes: List[Optional[Tuple[int, int]]] = []
        for i, (crop, name) in enumerate(zip(crops_bgr, class_names)):
            if crop is None or crop.size == 0:
                grays.append(None)
                shapes.append(None)
                continue
            grays.append(self._to_gray(crop))
            shapes.append(crop.shape[:2])
            groups.setdefault(field_kind(name), []).append(i)
        for kind, idxs in groups.items():
            try:
                results = self.read_batch_candidates([grays[i] for i in idxs], kind, beam=False)
                esc_thr = self.beam_escalate_conf.get(kind, 1.01)
                escalate: List[int] = []
                for i, cands in zip(idxs, results):
                    low = class_names[i].lower()
                    out[i], confs[i] = self._pick_validated_conf(
                        kind, low, cands, self._field_threshold(low, min_confidence))
                    if self.beam and (out[i] is None or confs[i] < esc_thr):
                        escalate.append(i)
                if escalate:
                    results = self.read_batch_candidates(
                        [grays[i] for i in escalate], kind, beam=True)
                    for i, cands in zip(escalate, results):
                        low = class_names[i].lower()
                        v, vc = self._pick_validated_conf(
                            kind, low, cands, self._field_threshold(low, min_confidence))
                        if v is not None:
                            out[i] = v
                            confs[i] = max(confs[i], vc)
            except Exception as e:  # degrade the kind, keep the frame alive
                self.errors += 1
                print(f"OCR batch error for kind={kind}: {e!r}", file=sys.stderr)
                continue
        # CRAFT fallback: empty fields whose crop is tall enough for >1 line
        if self.craft is not None:
            for i, (crop, name) in enumerate(zip(crops_bgr, class_names)):
                if out[i] is not None or crop is None or crop.size == 0:
                    continue
                if crop.shape[0] < 45:  # single UI lines are ~20-35 px
                    continue
                try:
                    out[i], rc = self._region_field(crop, name, min_confidence)
                    if out[i] is not None:
                        confs[i] = rc
                except Exception as e:
                    self.errors += 1
                    print(f"OCR region fallback error for {name}: {e!r}", file=sys.stderr)
        # catastrophic-collapse demotion (see COLLAPSE_FLOOR)
        for i, name in enumerate(class_names):
            if out[i] is None or shapes[i] is None:
                continue
            if field_kind(name) not in self.COLLAPSE_KINDS:
                continue
            h, w = shapes[i]
            exp_chars = max(1.0, (w / max(h, 1)) / 0.55)
            if len(out[i]) / exp_chars < self.COLLAPSE_FLOOR:
                confs[i] = min(confs[i], 0.20)
        return list(zip(out, confs))

    def _region_field(
        self, crop_bgr: np.ndarray, class_name: str, min_confidence: float
    ) -> Tuple[Optional[str], float]:
        """read_region over a loose/multi-line crop: the first line whose text
        validates for the field, and its confidence."""
        kind = field_kind(class_name)
        low = class_name.lower()
        thr = self._field_threshold(low, min_confidence)
        for _box, text, conf in self.read_region(crop_bgr, kind, thr):
            v = self._validate(kind, low, text)
            if v:
                return v, float(conf)
        return None, -1.0


def default_ocr_engine(
    weights: str = DEFAULT_RECOGNIZER_WEIGHTS,
    text_detector: Optional[str] = "weights/craft_real.npz",
    device: Union[str, torch.device] = "cuda",
) -> Optional[OCREngine]:
    """Build the default OCR engine on ``device``, or None if no recognizer
    weights exist. Missing members are dropped; a missing text detector gives
    a recognizer-only engine. Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    present = [
        p for p in (resolve_weight_path(q) for q in weights.split(",") if q)
        if os.path.exists(p)
    ]
    if not present:
        return None
    return OCREngine.from_npz(present, text_detector=text_detector, device=dev)
