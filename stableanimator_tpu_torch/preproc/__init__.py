"""Preprocessing of the PyTorch port: the ONNX reader and a differentiable
ONNX -> torch executor, image geometry, the face models (detection, identity
embedding, face masks) and DWPose skeleton extraction (YOLOX person boxes,
RTMPose keypoints, the C++ skeleton raster, the extraction worker) that run
through it."""
