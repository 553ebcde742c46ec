"""CTC decode: greedy (allowlist-masked, on the device) and prefix beam with
ensemble rescoring (on the host).

Counterpart of ``manual_yolo_tpu/ops/ctc.py``. ``greedy_decode`` is torch and
runs where the logits are. ``prefix_beam_decode`` and ``score_candidates``
call the port's host C++ library (``csrc/host.cpp`` through
``runtime/native.py``); their numpy versions, ``prefix_beam_decode_plain``
and ``score_candidates_plain`` (copies of the JAX package's), are the plain
twins the tests hold them against. Nothing falls back to the twins.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from manual_yolo_tpu_torch.models.crnn import BLANK, CHARSET
from manual_yolo_tpu_torch.runtime import native


def allowlist_mask(allow: Optional[str]) -> np.ndarray:
    """Build a (NUM_CLASSES,) 0/-inf mask for an allowlist string."""
    m = np.zeros(len(CHARSET) + 1, np.float32)
    if allow is not None:
        allowed = set(allow)
        for i, c in enumerate(CHARSET):
            if c not in allowed:
                m[i + 1] = -np.inf
    return m


def greedy_decode(
    logits: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    score_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, T, C) -> (ids (N, T) with collapsed repeats/blanks set to 0,
    confidence (N,) = mean prob of emitted frames).

    ``score_mask`` (default ``mask``) chooses the distribution confidences are
    computed under, so that several masks decoding the same logits score
    comparably."""
    dec_logits = logits if mask is None else logits + mask[None, None, :]
    sm = mask if score_mask is None else score_mask
    score_logits = logits if sm is None else logits + sm[None, None, :]
    probs = torch.softmax(score_logits, dim=-1)
    ids = torch.argmax(dec_logits, dim=-1)  # (N, T)
    pmax = torch.gather(probs, -1, ids[..., None])[..., 0]  # (N, T)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    emit = (ids != BLANK) & (ids != prev)
    out_ids = torch.where(emit, ids, 0)
    n_emit = emit.sum(dim=1)
    conf_sum = torch.where(emit, pmax, 0.0).sum(dim=1)
    conf = torch.where(n_emit > 0, conf_sum / n_emit.clamp(min=1), 0.0)
    return out_ids, conf


def decode_to_text(out_ids: np.ndarray) -> str:
    """Host: collapse one row of greedy_decode output to a string."""
    return "".join(CHARSET[i - 1] for i in np.asarray(out_ids) if i > 0)


def ctc_forward_score(logp: np.ndarray, ids) -> float:
    """Host CTC forward algorithm: log P(ids | logp) summed over all
    alignments, for (T, C) log-probabilities and non-blank ids."""
    T, _ = logp.shape
    L = len(ids)
    if L == 0:
        return float(logp[:, BLANK].sum())
    ext = np.zeros(2 * L + 1, np.int64)
    ext[1::2] = ids
    NEG = -np.inf
    alpha = np.full(2 * L + 1, NEG)
    alpha[0] = logp[0, BLANK]
    alpha[1] = logp[0, ids[0]]
    for t in range(1, T):
        prev = alpha
        shifted1 = np.concatenate(([NEG], prev[:-1]))
        stay = np.logaddexp(prev, shifted1)
        shifted2 = np.concatenate(([NEG, NEG], prev[:-2]))
        can_skip = np.zeros(2 * L + 1, bool)
        can_skip[2:] = (ext[2:] != BLANK) & (ext[2:] != ext[:-2])
        tot = np.where(can_skip, np.logaddexp(stay, shifted2), stay)
        alpha = tot + logp[t, ext]
    return float(np.logaddexp(alpha[-1], alpha[-2]))


def score_candidates_plain(logp: np.ndarray, candidates: Sequence) -> np.ndarray:
    """``ctc_forward_score`` of every candidate against one (T, C) posterior."""
    return np.asarray([ctc_forward_score(logp, ids) for ids in candidates], np.float32)


def score_candidates(logp: np.ndarray, candidates: Sequence) -> np.ndarray:
    """The ensemble rescorer's CTC forward scores, in one host C++ call."""
    return native.ctc_score_multi(logp, candidates)


def prefix_beam_decode_plain(
    logp: np.ndarray,
    beam_width: int = 8,
    topk_chars: int = 6,
    prune_lp: float = -9.0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """numpy CTC prefix beam search over ``logp`` (T, C) log-probabilities.

    Per frame only the ``topk_chars`` most probable characters above
    ``prune_lp`` are considered. Returns [(ids, log_posterior)] best first,
    at most ``beam_width``."""
    T, C = logp.shape
    NEG = -np.inf

    def lse(a: float, b: float) -> float:
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = a if a > b else b
        return m + np.log1p(np.exp(-abs(a - b)))

    # prefix -> [log mass ending in blank, log mass ending in the last char]
    beams = {(): [0.0, NEG]}
    lp_np = np.asarray(logp, np.float64)
    order = np.argsort(-lp_np, axis=1)[:, : max(topk_chars, 1)]
    for t in range(T):
        lp = lp_np[t]
        lpb = lp[BLANK]
        cand_chars = [int(c) for c in order[t] if c != BLANK and lp[c] > prune_lp]
        new: dict = {}
        for prefix, (pb, pnb) in beams.items():
            total = lse(pb, pnb)
            ent = new.get(prefix)
            if ent is None:
                ent = new[prefix] = [NEG, NEG]
            ent[0] = lse(ent[0], total + lpb)
            last = prefix[-1] if prefix else -1
            if last >= 0:
                ent[1] = lse(ent[1], pnb + lp[last])
            for c in cand_chars:
                npfx = prefix + (c,)
                ent2 = new.get(npfx)
                if ent2 is None:
                    ent2 = new[npfx] = [NEG, NEG]
                if c == last:
                    # a genuine repeat needs blank-separated mass
                    ent2[1] = lse(ent2[1], pb + lp[c])
                else:
                    ent2[1] = lse(ent2[1], total + lp[c])
        beams = dict(sorted(new.items(), key=lambda kv: -lse(*kv[1]))[:beam_width])
    out = [(pfx, lse(*v)) for pfx, v in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out


def prefix_beam_decode(
    logp: np.ndarray,
    beam_width: int = 8,
    topk_chars: int = 6,
    prune_lp: float = -9.0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """CTC prefix beam search in one host C++ call (``csrc/host.cpp::ctc_beam``);
    same algorithm and pruning as ``prefix_beam_decode_plain``."""
    return native.ctc_beam(logp, beam_width, topk_chars, prune_lp)
