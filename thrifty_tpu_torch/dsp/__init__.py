"""Detector DSP on PyTorch tensors (counterparts of thrifty_tpu.dsp)."""
