"""Per-game state machine — the TPU framework's equivalent of the
reference ``detect.py`` game-assembly layer (L4 in SURVEY.md §1).

Schema parity: the emitted game dict is field-for-field the structure of
reference ``initialize_game_state`` (``detect.py:486-521``); updates follow
``update_game_data`` (``detect.py:369-474``), street resolution follows
``determine_game_state`` (``detect.py:312-336``), and new-game detection
follows ``check_for_new_game`` (``detect.py:338-354``).
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from manual_yolo_tpu_torch.game.text import suit_phrase


def empty_card() -> Dict[str, str]:
    return {"rank": "", "suit": ""}


def new_game_state(game_id: int) -> Dict:
    """Fresh per-game structure (schema of reference detect.py:486-521)."""
    return {
        "game_id": game_id,
        "game_state": "preflop",
        "villains": [],
        "hero": {"stack": "", "bet": "", "cards": [empty_card(), empty_card()]},
        "board": {
            "flop": [empty_card(), empty_card(), empty_card()],
            "turn": empty_card(),
            "river": empty_card(),
        },
        "pot": "",
        "ui": {
            "buttons": {
                name: {"coordinates": [], "text": ""}
                for name in ("fold", "check", "call", "raise", "bet", "allin")
            },
            "bet_input": {"coordinates": [], "text": ""},
        },
    }


def resolve_street(detections: List[Dict]) -> str:
    """preflop/flop/turn/river from readable board ranks."""
    flop = 0
    turn = river = False
    for d in detections:
        name = d.get("class_name", "")
        text = d.get("ocr_text", "")
        if not text:
            continue
        if "rank" in name:
            if "flop" in name:
                flop += 1
            elif "turn" in name:
                turn = True
            elif "river" in name:
                river = True
    if river:
        return "river"
    if turn:
        return "turn"
    if flop >= 3:
        return "flop"
    return "preflop"


def hero_cards_from_detections(detections: List[Dict]) -> Dict[str, str]:
    cards = {"card1_rank": "", "card2_rank": "", "card1_suit": "", "card2_suit": ""}
    for d in detections:
        name = d.get("class_name", "")
        text = d.get("ocr_text", "")
        if name == "card1_rank" and text:
            cards["card1_rank"] = text
        elif name == "card2_rank" and text:
            cards["card2_rank"] = text
        elif name.startswith("card1_suite_"):
            cards["card1_suit"] = suit_phrase(name)
        elif name.startswith("card2_suite_"):
            cards["card2_suit"] = suit_phrase(name)
    return cards


def is_new_game(current: Dict[str, str], previous: Dict[str, str]) -> bool:
    """New hole cards => new game (reference detect.py:338-354)."""
    if not previous["card1_rank"] and not previous["card2_rank"]:
        return True
    for key in ("card1_rank", "card2_rank", "card1_suit", "card2_suit"):
        if current[key] and current[key] != previous[key]:
            return True
    return False


_BUTTON_KEYS = {
    "button_fold": "fold",
    "button_check": "check",
    "button_call": "call",
    "button_raise": "raise",
    "button_bet": "bet",
    "button_allin": "allin",
}

_FLOP_RANKS = {"flop1_rank": 0, "flop2_rank": 1, "flop3_rank": 2}


def apply_detections(state: Dict, detections: List[Dict]) -> None:
    """Route per-detection (class_name, ocr_text, bbox) into the game dict."""
    for d in detections:
        name = d.get("class_name", "")
        text = d.get("ocr_text", "")
        bbox = d.get("bbox", [])

        if name == "card1_rank" and text:
            state["hero"]["cards"][0]["rank"] = text
        elif name == "card2_rank" and text:
            state["hero"]["cards"][1]["rank"] = text
        elif name.startswith("card1_suite_"):
            state["hero"]["cards"][0]["suit"] = suit_phrase(name)
        elif name.startswith("card2_suite_"):
            state["hero"]["cards"][1]["suit"] = suit_phrase(name)
        elif name in _FLOP_RANKS and text:
            state["board"]["flop"][_FLOP_RANKS[name]]["rank"] = text
        elif name == "turn_rank" and text:
            state["board"]["turn"]["rank"] = text
        elif name == "river_rank" and text:
            state["board"]["river"]["rank"] = text
        elif name.startswith("flop") and "_suite_" in name:
            idx = int(name[4]) - 1
            state["board"]["flop"][idx]["suit"] = suit_phrase(name)
        elif name.startswith("turn_suite_"):
            state["board"]["turn"]["suit"] = suit_phrase(name)
        elif name.startswith("river_suite_"):
            state["board"]["river"]["suit"] = suit_phrase(name)
        elif name.startswith("villian") and "_name" in name:
            _update_villain(state, name[7], "name", text, create=True)
        elif name.startswith("villian") and "_stack" in name:
            _update_villain(state, name[7], "stack", text)
        elif name.startswith("villian") and "_bet" in name:
            _update_villain(state, name[7], "bet", text)
        elif name == "my_stack":
            state["hero"]["stack"] = text
        elif name == "my_bet":
            state["hero"]["bet"] = text
        elif name == "total_pot":
            state["pot"] = text
        elif name in _BUTTON_KEYS:
            state["ui"]["buttons"][_BUTTON_KEYS[name]] = {
                "coordinates": bbox, "text": text
            }
        elif name == "iinput_field":
            state["ui"]["bet_input"] = {"coordinates": bbox, "text": text}

    state["game_state"] = resolve_street(detections)


def _update_villain(state, position, key, value, create=False):
    for v in state["villains"]:
        if v["position"] == position:
            v[key] = value
            return
    if create:
        entry = {"position": position, "name": "", "stack": "", "bet": ""}
        entry[key] = value
        state["villains"].append(entry)


@dataclass
class GameTracker:
    """Carries game state across frames; detects new hands; persists JSON.

    Drives the same lifecycle as the reference main loop
    (``detect.py:627-659``): extract hero cards, roll game id on change,
    apply detections, save the game file.
    """

    output_dir: str = "live_output"
    game_id: int = 1
    state: Dict = field(default_factory=lambda: new_game_state(1))
    previous_hero: Dict[str, str] = field(
        default_factory=lambda: {
            "card1_rank": "", "card2_rank": "", "card1_suit": "", "card2_suit": ""
        }
    )

    def update(self, detections: List[Dict]) -> Dict:
        hero = hero_cards_from_detections(detections)
        if is_new_game(hero, self.previous_hero):
            if (
                self.state["hero"]["cards"][0]["rank"]
                or self.state["hero"]["cards"][1]["rank"]
            ):
                self.save()
                self.game_id += 1
            self.previous_hero = dict(hero)
            self.state = new_game_state(self.game_id)
        apply_detections(self.state, detections)
        return self.state

    def save(self) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"game_{self.game_id}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.state, f, indent=2)
        return path
