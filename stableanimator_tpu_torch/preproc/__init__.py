"""Preprocessing of the PyTorch port: the ONNX reader and a differentiable
ONNX -> torch executor, image geometry, and the face models (detection,
identity embedding, face masks) that run through it."""
