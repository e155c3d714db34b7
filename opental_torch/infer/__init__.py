"""Inference: window decoding and the video pipeline."""
