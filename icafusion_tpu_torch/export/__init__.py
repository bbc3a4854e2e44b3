"""Interchange export of the port: hand-rolled ONNX (no `onnx` package
needed; fp32, baked NMS, int8 QDQ) and, in cli/export.py, a
``torch.export`` program (.pt2) and the stripped weights."""
