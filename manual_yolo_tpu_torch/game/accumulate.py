"""Cross-frame field accumulation (fill-don't-overwrite).

Re-implements the reference's ACCUMULATE_DATA merge semantics
(``yolo.py:477-504`` ``merge_detected_values``): card fields are
fill-only (a read card is never overwritten within a hand), other fields
update whenever a non-empty new value differs, buttons replace wholesale
when the new frame has any. Returns the merged dict plus a change summary
(the reference's ``changes`` dict).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

CARD_KEYS = frozenset(
    [f"{p}_rank" for p in ("card1", "card2", "flop1", "flop2", "flop3", "turn", "river")]
    + [f"{p}_suit" for p in ("card1", "card2", "flop1", "flop2", "flop3", "turn", "river")]
    # flat-result card keys (build_flat_result/build_result level)
    + ["card1", "card2"]
)


def merge_detected_values(
    existing: Dict, new: Dict
) -> Tuple[Dict, Dict[str, List[str]]]:
    merged = dict(existing) if existing else {}
    for k in set(list(new.keys()) + list(merged.keys())):
        merged.setdefault(k, "")

    changes: Dict[str, List[str]] = {"cards_filled": [], "other_updated": []}

    if isinstance(new.get("buttons"), list) and new["buttons"]:
        merged["buttons"] = new["buttons"]

    for k, v in new.items():
        if k == "buttons":
            continue
        if k in CARD_KEYS:
            if not merged.get(k) and v:
                merged[k] = v
                changes["cards_filled"].append(k)
        elif isinstance(v, str):
            if v.strip() and merged.get(k) != v:
                merged[k] = v
                changes["other_updated"].append(k)
        elif (v or v == 0) and merged.get(k) != v:
            merged[k] = v
            changes["other_updated"].append(k)

    return merged, changes
