"""manual_yolo_tpu_torch — the PyTorch/CUDA port of ``manual_yolo_tpu``.

The modules keep the JAX package's names and layout, so each one has a
counterpart there (``manual_yolo_tpu/<same path>``). The port imports
neither JAX nor the JAX package: what it needs of the host-only modules
(``game/*``, ``config.py``) is copied here.

The ported slices make up the single-screenshot path:

  uint8 BGR frame -> letterbox -> YOLOv8 detect (bf16 on the card) ->
  DFL decode -> NMS (greedy keep mask: hand-written CUDA kernel,
  ``csrc/nms_keep.cu``) -> unletterbox -> top-8 rank crops ->
  yolov8n-cls (f32) -> gated rank text -> OCR of the fields left empty
  (CRNN ensemble on the card, CTC prefix beam and rescore in host C++,
  CRAFT multi-line fallback) -> flat result JSON

and the two continuous loops: the live loop (``runtime/live.py``: that path
per frame, then ByteTrack, the game state and a JSONL log) and the hand
session (``runtime/hands.py``: ``runtime/engine.py`` at imgsz 1280, a frame's
tiles as one batch through one NMS-kernel launch, DeepSORT with the
appearance embedder, game-id OCR and per-hand records).

Entry points (``runtime.shot.load_fused_pipeline``,
``runtime.ocr.default_ocr_engine``, ``runtime.engine.DetectorEngine.from_npz``,
``runtime.embedder.default_embedder``, ``cli.shot``, ``cli.detect``,
``cli.pipe``) run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
