"""The port's vision-LLM fallback against the JAX package's.

``runtime/llm_fallback.py`` (collage, prompts, request, parsing) and
``runtime/shot.py::_llm_escalate`` (which fields escalate, validation,
filling): the JAX package's four tests of ``tests/test_llm_fallback.py`` on
the port; the collage pixel for pixel; the request body byte for byte with
``urllib.request.urlopen`` stubbed (no network); a failing request; the
escalation through ``process_screenshot`` with a stubbed query in both
packages; and the ``OPENAI_API_KEY`` gating."""

import base64
import io
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from manual_yolo_tpu.runtime import llm_fallback as jax_llm  # noqa: E402
from manual_yolo_tpu.runtime import shot as jax_shot  # noqa: E402
from manual_yolo_tpu_torch.runtime import llm_fallback as llm  # noqa: E402
from manual_yolo_tpu_torch.runtime import shot as pt_shot  # noqa: E402
from manual_yolo_tpu_torch.runtime.jpeg import encode_jpeg  # noqa: E402


class _Canned:
    """process_frame stub returning fixed detections (no device work)."""

    def __init__(self, dets):
        self._dets = dets

    def process_frame(self, frame):
        return [dict(d) for d in self._dets]


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


DETS = [
    {"class_id": 6, "class_name": "card1_rank", "bbox": [10, 10, 40, 50],
     "conf": 0.9, "ocr_text": ""},
    {"class_id": 34, "class_name": "my_stack", "bbox": [10, 60, 80, 80],
     "conf": 0.8, "ocr_text": ""},
    {"class_id": 60, "class_name": "villian1_name", "bbox": [5, 5, 60, 20],
     "conf": 0.8, "ocr_text": ""},
    # read with confidence above the gate: not escalated
    {"class_id": 56, "class_name": "total_pot", "bbox": [20, 30, 70, 45],
     "conf": 0.8, "ocr_text": "300", "ocr_conf": 0.99},
    # below the gate: escalated
    {"class_id": 35, "class_name": "villian1_stack", "bbox": [40, 40, 90, 55],
     "conf": 0.8, "ocr_text": "1O0", "ocr_conf": 0.5},
]


def _crops(seed=0):
    rng = np.random.default_rng(seed)
    return [("card1_rank", rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)),
            ("my_stack", rng.integers(0, 256, (15, 50, 3), dtype=np.uint8)),
            ("villian3_name", rng.integers(0, 256, (22, 64, 3), dtype=np.uint8)),
            ("empty", None)]


# --- the JAX package's tests/test_llm_fallback.py, on the port ------------------


def test_build_collage_layout():
    crops = [
        ("card1_rank", np.full((20, 30, 3), 200, np.uint8)),
        ("my_stack", np.full((15, 50, 3), 100, np.uint8)),
        ("empty", None),
    ]
    collage = llm.build_collage(crops)
    assert collage is not None and collage.ndim == 3
    assert llm.build_collage([]) is None


def test_parse_llm_json_variants():
    assert llm.parse_llm_json('{"card1_rank": "A"}') == {"card1_rank": "A"}
    embedded = 'Sure! Here is the data:\n```{"my_stack": "1500"}```'
    assert llm.parse_llm_json(embedded) == {"my_stack": "1500"}
    assert llm.parse_llm_json("no json here") == {}
    assert llm.parse_llm_json("[1, 2]") == {}


def test_query_disabled_without_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    out = llm.query_vision_llm(np.zeros((10, 10, 3), np.uint8), ["my_stack"])
    assert out == {}


def test_important_keys_match_reference_surface():
    assert "total_pot" in llm.IMPORTANT_KEYS
    assert "villian5_bet" in llm.IMPORTANT_KEYS
    assert len([k for k in llm.IMPORTANT_KEYS if k.startswith("villian")]) == 15
    assert llm.IMPORTANT_KEYS == jax_llm.IMPORTANT_KEYS
    assert (llm.DEFAULT_MODEL, llm.API_URL) == (jax_llm.DEFAULT_MODEL, jax_llm.API_URL)


# --- against the JAX package -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_build_collage_matches_jax(seed):
    got, ref = llm.build_collage(_crops(seed)), jax_llm.build_collage(_crops(seed))
    np.testing.assert_array_equal(got, ref)
    keys = ["x"] * 7
    many = [(k, np.full((9 + i, 11 + 2 * i, 3), 30 * i, np.uint8)) for i, k in enumerate(keys)]
    np.testing.assert_array_equal(llm.build_collage(many), jax_llm.build_collage(many))


def test_prompts_match_jax():
    keys = ["card1_rank", "villian2_stack"]
    assert llm._SYSTEM_PROMPT == jax_llm._SYSTEM_PROMPT
    assert llm._user_prompt(keys) == jax_llm._user_prompt(keys)


def _record_urlopen(monkeypatch, answer: str):
    sent = []

    def fake(req, timeout=None):
        sent.append((req, timeout))
        body = {"choices": [{"message": {"content": answer}}]}
        return _Response(json.dumps(body).encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake)
    return sent


def test_request_body_matches_jax(monkeypatch):
    """One collage array through both packages' query_vision_llm: the same
    URL, headers and body bytes (the image a quality-85 JPEG, cv2's bytes),
    and the same parsed answer."""
    collage = jax_llm.build_collage(_crops(3))
    keys = ["card1_rank", "my_stack", "villian3_name"]
    sent = _record_urlopen(monkeypatch, 'Here: {"card1_rank": "a", "my_stack": 1500}')
    got = llm.query_vision_llm(collage, keys, api_key="sk-test", timeout=7.0)
    ref = jax_llm.query_vision_llm(collage, keys, api_key="sk-test", timeout=7.0)
    assert got == ref == {"card1_rank": "a", "my_stack": "1500"}
    (pt_req, pt_timeout), (jx_req, jx_timeout) = sent
    assert pt_req.data == jx_req.data and pt_timeout == jx_timeout == 7.0
    assert pt_req.full_url == jx_req.full_url == llm.API_URL
    assert pt_req.header_items() == jx_req.header_items()
    payload = json.loads(pt_req.data)
    url = payload["messages"][1]["content"][1]["image_url"]["url"]
    assert base64.b64decode(url.split(",", 1)[1]) == encode_jpeg(collage, 85)
    assert llm.request_body(collage, keys) == pt_req.data


def test_request_error_gives_nothing(monkeypatch):
    def refuse(req, timeout=None):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    collage = llm.build_collage(_crops())
    assert llm.query_vision_llm(collage, ["my_stack"], api_key="k") == {}
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda req, timeout=None: _Response(b"not json"))
    assert llm.query_vision_llm(collage, ["my_stack"], api_key="k") == {}


def _shot_both(monkeypatch, tmp_path, use_llm, answer):
    """process_screenshot of both packages on canned detections with the
    query stubbed; -> (port result, JAX result, keys asked per package)."""
    img = tmp_path / "t.png"
    cv2.imwrite(str(img), np.random.default_rng(2).integers(0, 256, (100, 100, 3), dtype=np.uint8))
    asked = {}

    def stub(tag):
        def fake(collage, missing_keys, **kw):
            asked[tag] = (list(missing_keys), collage.copy())
            return dict(answer)
        return fake

    monkeypatch.setattr(llm, "query_vision_llm", stub("pt"))
    monkeypatch.setattr(jax_llm, "query_vision_llm", stub("jax"))
    res_pt = pt_shot.process_screenshot(_Canned(DETS), str(img), str(tmp_path / "pt.json"),
                                        output_image=None, use_llm_fallback=use_llm)
    res_jx = jax_shot.process_screenshot(_Canned(DETS), str(img), str(tmp_path / "jx.json"),
                                         output_image=None, use_llm_fallback=use_llm)
    res_pt.pop("time"), res_jx.pop("time")
    return res_pt, res_jx, asked


def test_llm_escalate_matches_jax(monkeypatch, tmp_path):
    """The same fields escalate (empty, or read below the gate), the same
    collage goes out, and the same validated values fill the result."""
    answer = {"card1_rank": "a", "my_stack": "1.2k", "villian1_name": "bob_99",
              "villian1_stack": "100", "total_pot": "999"}
    res_pt, res_jx, asked = _shot_both(monkeypatch, tmp_path, True, answer)
    assert asked["pt"][0] == asked["jax"][0]
    assert sorted(asked["pt"][0]) == ["card1_rank", "my_stack", "villian1_name", "villian1_stack"]
    np.testing.assert_array_equal(asked["pt"][1], asked["jax"][1])
    assert res_pt == res_jx
    assert res_pt["card1"] == "A" and res_pt["my_stack"] == "1.2K"
    assert res_pt["villains"][0]["name"] == "bob_99"
    dets = [dict(d) for d in DETS]
    frame = np.zeros((100, 100, 3), np.uint8)
    monkeypatch.setattr(llm, "query_vision_llm", lambda c, k, **kw: {"my_stack": "junk!!"})
    assert pt_shot._llm_escalate(frame, dets) == 0  # the validator refuses it


@pytest.mark.parametrize("key", [None, "sk-test"])
def test_openai_key_gating_matches_jax(monkeypatch, tmp_path, key):
    """use_llm_fallback=None queries only when OPENAI_API_KEY is set, in both
    packages; False never queries."""
    if key is None:
        monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    else:
        monkeypatch.setenv("OPENAI_API_KEY", key)
    res_pt, res_jx, asked = _shot_both(monkeypatch, tmp_path, None, {"my_stack": "7"})
    assert res_pt == res_jx
    assert set(asked) == (set() if key is None else {"pt", "jax"})
    _, _, asked = _shot_both(monkeypatch, tmp_path, False, {"my_stack": "7"})
    assert not asked
