"""Evaluation of the port: metrics, LaTeX checks, calibration and the
test-split harness."""
