"""Result-JSON builders for the single-shot and hand-session pipelines.

Schema parity targets:
  * ``build_result`` — reference ``yolo.py:506-559`` (the structure of the
    shipped sample ``poker_result.json``): game_info / my_cards / my_info /
    villains[5] / community_cards / buttons / pot.
  * ``build_flat_result`` — reference ``yolo.py:425-445`` (the simpler
    ``process_screenshot`` output).
  * ``build_hand_record`` — reference ``pipe.py:263-280`` (per-hand JSON:
    buttons + iinput_field only).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional


def _street_from_fields(detected: Dict[str, str]) -> str:
    if detected.get("river_rank"):
        return "RIVER"
    if detected.get("turn_rank"):
        return "TURN"
    if any(detected.get(k) for k in ("flop1_rank", "flop2_rank", "flop3_rank")):
        return "FLOP"
    return "PREFLOP"


def build_result(detected: Dict[str, str], now: Optional[float] = None) -> Dict:
    """Structured result (reference yolo.py:506-559 / poker_result.json)."""
    card1 = (detected.get("card1_rank", "") + detected.get("card1_suit", "")).strip()
    card2 = (detected.get("card2_rank", "") + detected.get("card2_suit", "")).strip()

    community = []
    for prefix in ("flop1", "flop2", "flop3", "turn", "river"):
        rank = detected.get(f"{prefix}_rank", "")
        suit = detected.get(f"{prefix}_suit", "")
        if rank:
            community.append((rank + suit).strip())

    villains = [
        {
            "name": detected.get(f"villian{i}_name", ""),
            "stack": detected.get(f"villian{i}_stack", ""),
            "bet": detected.get(f"villian{i}_bet", ""),
        }
        for i in range(1, 6)
    ]

    return {
        "game_info": {
            "game_id": detected.get("game_id", ""),
            "time": time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now)),
            "game_state": _street_from_fields(detected),
        },
        "my_cards": {"card1": card1, "card2": card2},
        "my_info": {
            "stack": detected.get("my_stack", ""),
            "bet": detected.get("my_bet", ""),
        },
        "villains": villains,
        "community_cards": community,
        "buttons": detected.get("buttons", []),
        "pot": detected.get("total_pot", ""),
    }


def build_flat_result(
    card_ranks: Dict[str, str],
    card_suits: Dict[str, str],
    community_cards: Dict[str, str],
    buttons: List[Dict],
    now: Optional[float] = None,
) -> Dict:
    """Flat single-screenshot result (reference yolo.py:425-445)."""
    card1 = card_ranks.get("card1_rank", "") + card_suits.get("card1_rank", "")
    card2 = card_ranks.get("card2_rank", "") + card_suits.get("card2_rank", "")
    comm = [c for c in community_cards.values() if c]
    n = len(comm)
    if n == 0:
        game_state = "PREFLOP"
    elif n == 3:
        game_state = "FLOP"
    elif n == 4:
        game_state = "TURN"
    else:
        game_state = "RIVER"
    result = {
        "game_id": card_ranks.get("game_id", ""),
        "time": time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now)),
        "my_stack": card_ranks.get("my_stack", ""),
        "card1": card1,
        "card2": card2,
        "my_bet": card_ranks.get("my_bet", ""),
        "villains": [
            {
                "name": card_ranks.get(f"villian{i}_name", ""),
                "stack": card_ranks.get(f"villian{i}_stack", ""),
                "bet": card_ranks.get(f"villian{i}_bet", ""),
            }
            for i in range(1, 6)
        ],
        "buttons": buttons,
        "community_cards": list(community_cards.values()),
        "game_state": game_state,
    }
    return result


def build_hand_record(
    hand_index: int,
    buttons: List[Dict],
    input_area: Optional[Dict],
    hand_start_ts: Optional[float],
    now: Optional[float] = None,
) -> Dict:
    """Per-hand record (reference pipe.py:263-280)."""
    now = now if now is not None else time.time()
    return {
        "hand_index": hand_index,
        "time_start": (
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(hand_start_ts))
            if hand_start_ts
            else None
        ),
        "time_end": time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now)),
        "buttons": [
            {"track_id": int(b["track_id"]), "class": b["class"], "bbox": b["bbox"]}
            for b in buttons
        ],
        "iinput_field": (
            {
                "track_id": int(input_area["track_id"]),
                "class": input_area["class"],
                "bbox": input_area["bbox"],
            }
            if input_area
            else None
        ),
    }


def write_json_atomic(path: str, data: Dict) -> None:
    """Atomic JSON write (tmp + fsync + replace), reference yolo.py:330-346."""
    dirpath = os.path.dirname(path)
    if dirpath:
        os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_json_", dir=dirpath or None)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4, ensure_ascii=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
