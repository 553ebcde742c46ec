"""Text normalisation + field extraction rules.

Behavioural parity with the reference's scattered helpers:
  * rank normalisation  — reference ``detect.py:59-98`` (``normalize_rank_text``
    with its OCR-confusion mapping) and ``yolo.py:322-327`` (``clean_rank``);
  * field regexes       — reference ``yolo.py:168-171`` (card / numeric /
    pot / name patterns) and the allowlist post-processing of
    ``yolo.py:218-315``.
"""

from __future__ import annotations

import re
from typing import Optional

VALID_CARD_RANKS = frozenset(
    {"A", "K", "Q", "J", "10", "9", "8", "7", "6", "5", "4", "3", "2"}
)

# common OCR confusions seen on rank glyphs (reference detect.py:38)
OCR_RANK_CORRECTIONS = {"O": "0", "I": "1", "S": "5", "Z": "2", "B": "8", "T": "10"}

CARD_PATTERN = re.compile(r"^(A|K|Q|J|T|10|[2-9])([SHDCshdc♠♥♦♣])$", re.IGNORECASE)
NUMERIC_PATTERN = re.compile(r"[\d,.]+[kKmMbB]?")
POT_PATTERN = re.compile(r"pot[:]?\s*([\d,.kKmMbM]+)", re.IGNORECASE)
# the reference validates ^[a-zA-Z0-9_]{2,25}$ (yolo.py:305) — but the real
# UI shows dotted/hyphenated usernames ("s.kaahyap"), which that regex can
# NEVER read correctly; we extend it (interior . and - allowed)
NAME_PATTERN = re.compile(r"^[a-zA-Z0-9_][a-zA-Z0-9_.-]{0,23}[a-zA-Z0-9_]$")

_DIGIT_RANKS = frozenset({"10", "9", "8", "7", "6", "5", "4", "3", "2"})


def normalize_rank_text(text: str) -> str:
    """Clean OCR text to a valid rank (A, K, Q, J, 10, 9..2) or ''."""
    if not text:
        return ""
    t = text.strip().upper()
    if len(t) == 1 and t in OCR_RANK_CORRECTIONS:
        t = OCR_RANK_CORRECTIONS[t]
    t = t.replace(" ", "").replace("|", "1").replace("O", "0")
    if t == "T":
        t = "10"
    if t in {"A", "K", "Q", "J"}:
        return t
    if t.isdigit():
        if t == "0":
            t = "10"
        if t in _DIGIT_RANKS:
            return t
    if len(t) == 1 and t in OCR_RANK_CORRECTIONS:
        mapped = OCR_RANK_CORRECTIONS[t]
        if mapped == "0":
            mapped = "10"
        if mapped in _DIGIT_RANKS:
            return mapped
    return ""


def clean_rank(rank: str) -> str:
    """Single-character rank fixups (reference yolo.py:322-327)."""
    if not rank:
        return ""
    rank = rank.strip().upper()
    return {"0": "Q", "X": "K", "1": "I", "O": "Q"}.get(rank, rank)


_SUIT_TO_CHAR = {"S": "s", "H": "h", "D": "d", "C": "c"}
_SUIT_SYMBOLS = {"♠": "S", "♥": "H", "♦": "D", "♣": "C"}


def extract_card_value(text: str) -> Optional[str]:
    """Parse OCR output into 'Rs' form (rank + lowercase suit), e.g. 'As'."""
    if not text:
        return None
    t = text.upper().replace("10", "T")
    for sym, ch in _SUIT_SYMBOLS.items():
        t = t.replace(sym, ch)
    t = re.sub(r"\s+", "", t.strip())
    m = CARD_PATTERN.match(t)
    if m:
        rank = m.group(1).upper()
        suit = m.group(2)[0].upper()
        return rank + _SUIT_TO_CHAR.get(suit, suit.lower())
    r = re.search(r"(A|K|Q|J|T|10|[2-9])", t)
    s = re.search(r"([SHDCshdc])", t)
    if r and s:
        rank = r.group(1).replace("10", "T").upper()
        suit = s.group(1).upper()
        return rank + _SUIT_TO_CHAR.get(suit, suit.lower())
    return None


def extract_numeric_value(text: str) -> Optional[str]:
    """Parse stack/bet/pot strings, e.g. '1.2k' (reference yolo.py:271-296)."""
    if not text:
        return None
    t = text.upper().replace("$", "").replace("O", "0").replace("I", "1").strip()
    t = t.replace(",", "")
    # suffixes the poker UI uses: K (thousand), L (lakh), M, B, and big-blind
    # denominations like "25BB" / "1.24KBB"
    m = re.search(r"[\d.]+(?:[KML]?BB|[KMBL])?", t)
    return m.group() if m else None


def extract_name(text: str) -> Optional[str]:
    """Validate a player-name string (reference yolo.py:298-315)."""
    if not text:
        return None
    t = re.sub(r"[^A-Za-z0-9_.-]", "", text.strip())
    return t if NAME_PATTERN.match(t) else None


def suit_phrase(class_name: str) -> str:
    """Class name -> 'of <suit>' phrase (reference detect.py:356-367)."""
    cl = class_name.lower()
    for key, phrase in (
        ("club", "of club"),
        ("diamond", "of diamond"),
        ("heart", "of heart"),
        ("spade", "of spade"),
    ):
        if key in cl:
            return phrase
    return ""


def suit_char(class_name: str) -> str:
    """Class name -> single suit char c/d/h/s (reference yolo.py:97-141)."""
    cl = class_name.lower()
    for key, ch in (("club", "c"), ("diamond", "d"), ("heart", "h"), ("spade", "s")):
        if key in cl:
            return ch
    return ""
