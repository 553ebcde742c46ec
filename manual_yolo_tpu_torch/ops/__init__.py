"""Tensor ops of the frame path: letterbox, box geometry, NMS and its CUDA kernel."""
