"""Optional vision-LLM fallback for unreadable fields (host-side HTTP).

Counterpart of ``manual_yolo_tpu/runtime/llm_fallback.py``, the reference's
GPT-4o fallback (``yolo.py:629-747``): when local OCR cannot read important
fields, a labelled collage of the failing crops goes to a vision LLM, which
answers with a field -> value JSON mapping. The same prompts, model, URL and
request body as the JAX package, and the same gating: nothing is sent
without an API key, and any error of the request gives ``{}``.

Without OpenCV: the collage's labels are drawn by ``runtime/draw.py`` and the
collage is sent as the quality-85 JPEG that ``runtime/jpeg.py::encode_jpeg``
writes (the bytes of the JAX package's ``cv2.imencode``). The request goes
through ``urllib``; no SDK is needed.
"""

from __future__ import annotations

import base64
import json
import os
import re
import urllib.request
from math import ceil, sqrt
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from manual_yolo_tpu_torch.runtime.draw import put_text
from manual_yolo_tpu_torch.runtime.jpeg import encode_jpeg

DEFAULT_MODEL = "gpt-4o"
API_URL = "https://api.openai.com/v1/chat/completions"
JPEG_QUALITY = 85

# fields worth escalating (reference yolo.py:51-59)
IMPORTANT_KEYS = (
    ["card1_rank", "card1_suit", "card2_rank", "card2_suit", "my_stack", "my_bet"]
    + [f"villian{i}_{k}" for i in range(1, 6) for k in ("name", "stack", "bet")]
    + ["total_pot", "game_id"]
)

_SYSTEM_PROMPT = (
    "You are an expert data extraction specialist. Analyze collage "
    "screenshots and extract precise information. Return ONLY valid JSON "
    "with no additional text."
)


def _user_prompt(missing_keys: Sequence[str]) -> str:
    return (
        "Analyze this image collage carefully.\n\n"
        f"EXTRACT THESE FIELDS IF VISIBLE: {', '.join(missing_keys)}\n\n"
        "FORMATTING RULES:\n"
        "- Card ranks: A, K, Q, J, T (for 10), 2-9\n"
        "- Card suits: c (clubs), d (diamonds), h (hearts), s (spades)\n"
        "- Complete cards combine rank + suit like \"As\", \"Th\"\n"
        "- Numeric values: exactly as shown (e.g. \"1.2k\", \"1500\", \"$500\")\n"
        "- Player names / game ids: exactly as shown\n"
        "- Omit any field that cannot be read clearly\n"
        "- Return ONLY a JSON object, no other text"
    )


def build_collage(
    crops: Sequence[Tuple[str, np.ndarray]], pad: int = 4, label_h: int = 18
) -> Optional[np.ndarray]:
    """Stack labelled (field_name, BGR crop) pairs into one annotated image."""
    crops = [(k, c) for k, c in crops if c is not None and c.size]
    if not crops:
        return None
    cols = max(1, int(ceil(sqrt(len(crops)))))
    rows = int(ceil(len(crops) / cols))
    w_max = max(c.shape[1] for _, c in crops) + pad
    h_max = max(c.shape[0] for _, c in crops) + label_h + pad
    canvas = np.zeros((rows * h_max, cols * w_max, 3), np.uint8)
    for idx, (key, crop) in enumerate(crops):
        r, c = divmod(idx, cols)
        y, x = r * h_max, c * w_max
        canvas[y : y + crop.shape[0], x : x + crop.shape[1]] = crop
        put_text(canvas, key, (x + 2, y + crop.shape[0] + label_h - 4), 0.4, (255, 255, 255), 1)
    return canvas


def request_body(collage_bgr: np.ndarray, missing_keys: Sequence[str],
                 model: str = DEFAULT_MODEL) -> bytes:
    """The chat-completions request's JSON body: the prompts and the collage
    as a base64 JPEG data URL."""
    jpg = encode_jpeg(collage_bgr, JPEG_QUALITY)
    payload = {
        "model": model,
        "temperature": 0.0,
        "max_tokens": 1500,
        "messages": [
            {"role": "system", "content": _SYSTEM_PROMPT},
            {
                "role": "user",
                "content": [
                    {"type": "text", "text": _user_prompt(missing_keys)},
                    {
                        "type": "image_url",
                        "image_url": {
                            "url": "data:image/jpeg;base64,"
                            + base64.b64encode(jpg).decode()
                        },
                    },
                ],
            },
        ],
    }
    return json.dumps(payload).encode()


def query_vision_llm(
    collage_bgr: np.ndarray,
    missing_keys: Sequence[str],
    model: str = DEFAULT_MODEL,
    api_key: Optional[str] = None,
    timeout: float = 30.0,
) -> Dict[str, str]:
    """Send the collage to the vision LLM; returns {} when disabled or offline."""
    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return {}
    req = urllib.request.Request(
        API_URL,
        data=request_body(collage_bgr, missing_keys, model),
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {api_key}",
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read().decode())
        text = body["choices"][0]["message"]["content"].strip()
    except Exception:
        return {}
    return parse_llm_json(text)


def parse_llm_json(text: str) -> Dict[str, str]:
    """Tolerant JSON extraction from an LLM response (direct or embedded)."""
    try:
        parsed = json.loads(text)
        if isinstance(parsed, dict):
            return {str(k): str(v) for k, v in parsed.items()}
    except json.JSONDecodeError:
        pass
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if m:
        try:
            parsed = json.loads(m.group())
            if isinstance(parsed, dict):
                return {str(k): str(v) for k, v in parsed.items()}
        except json.JSONDecodeError:
            pass
    return {}
