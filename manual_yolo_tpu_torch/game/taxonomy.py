"""The 64-class table-element taxonomy shared by every pipeline.

Mirrors the class list in the reference dataset
(``roadmap1.v3i.yolov8/data.yaml:6``) and the CLASSES dict duplicated in
``yolo.py:62-82``/``yolo.py:755-772``. Kept in ONE place here (the reference
re-declares it in three files).
"""

from __future__ import annotations

from typing import Dict, FrozenSet

CLASS_NAMES = [
    "button_allin", "button_bet", "button_call", "button_check", "button_fold",
    "button_raise", "card1_rank", "card1_suite_club", "card1_suite_diamond",
    "card1_suite_heart", "card1_suite_spades", "card2_rank", "card2_suite_club",
    "card2_suite_diamond", "card2_suite_heart", "card2_suite_spades",
    "flop1_rank", "flop1_suite_club", "flop1_suite_diamond", "flop1_suite_heart",
    "flop1_suite_spades", "flop2_rank", "flop2_suite_club", "flop2_suite_diamond",
    "flop2_suite_heart", "flop2_suite_spades", "flop3_rank", "flop3_suite_club",
    "flop3_suite_diamond", "flop3_suite_heart", "flop3_suite_spades", "game_id",
    "iinput_field", "my_bet", "my_stack", "position_BB", "position_SB",
    "river_rank", "river_suite_club", "river_suite_diamond", "river_suite_heart",
    "river_suite_spades", "total_pot", "turn_rank", "turn_suite_club",
    "turn_suite_diamond", "turn_suite_heart", "turn_suite_spades",
    "villian1_bet", "villian1_name", "villian1_stack", "villian2_bet",
    "villian2_name", "villian2_stack", "villian3_bet", "villian3_name",
    "villian3_stack", "villian4_bet", "villian4_name", "villian4_stack",
    "villian5_bet", "villian5_name", "villian5_stack", "winner",
]

CLASSES: Dict[int, str] = dict(enumerate(CLASS_NAMES))
CLASS_IDS: Dict[str, int] = {v: k for k, v in CLASSES.items()}

RANK_CLASSES: FrozenSet[str] = frozenset(
    {"card1_rank", "card2_rank", "flop1_rank", "flop2_rank", "flop3_rank",
     "turn_rank", "river_rank"}
)

SUIT_CLASSES: FrozenSet[str] = frozenset(
    n for n in CLASS_NAMES if "_suite_" in n
)

BUTTON_CLASSES: FrozenSet[str] = frozenset(
    n for n in CLASS_NAMES if n.startswith("button_")
)

# classes whose crops get OCR'd in the single-shot pipeline (yolo.py:376-383)
OCR_CLASSES: FrozenSet[str] = frozenset(
    list(RANK_CLASSES)
    + ["total_pot", "my_bet", "my_stack", "game_id"]
    + [f"villian{i}_{kind}" for i in range(1, 6) for kind in ("bet", "name", "stack")]
)

# classes hinting that small objects matter -> tiled inference (pipe.py:66)
SMALL_OBJ_HINT_CLASSES = ("my_bet", "total_pot", "villian1_bet")

INPUT_FIELD_CLASS = "iinput_field"
GAME_ID_CLASS = "game_id"
BUTTON_CLASS_PREFIX = "button_"

# button class -> display label (yolo.py YOLO_TO_JSON_MAP button entries)
BUTTON_LABELS = {
    "button_fold": "Fold",
    "button_check": "Check",
    "button_bet": "Bet",
    "button_raise": "Raise",
    "button_call": "Call",
    "button_allin": "All-in",
}
