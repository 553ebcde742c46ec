"""manual_yolo_tpu_torch — the PyTorch/CUDA port of ``manual_yolo_tpu``.

The modules keep the JAX package's names and layout, so each one has a
counterpart there (``manual_yolo_tpu/<same path>``). The port imports
neither JAX nor the JAX package: what it needs of the host-only modules
(``game/*``, ``config.py``) is copied here.

This slice ports the single-screenshot path:

  uint8 BGR frame -> letterbox -> YOLOv8 detect (bf16 on the card) ->
  DFL decode -> NMS (greedy keep mask: hand-written CUDA kernel,
  ``csrc/nms_keep.cu``) -> unletterbox -> top-8 rank crops ->
  yolov8n-cls (f32) -> gated rank text -> flat result JSON

Entry points (``runtime.shot.load_fused_pipeline``, ``cli.shot``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
