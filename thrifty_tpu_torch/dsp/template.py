"""Matched-filter template generation.

Samples an ideal bipolar Gold-code signal at the receiver sample rate with
an integer sampler and no pulse shaping, matching the reference's template
format (thrifty/template_generate.py:19-45: 11-bit code @ 0.999707 Mcps
sampled at 2.4 Msps -> 4914-sample template).
"""

from __future__ import annotations

import numpy as np

from thrifty_tpu_torch.dsp import gold


def sample_code(code: np.ndarray, sps: float) -> np.ndarray:
    """Sample a bipolar code at ``sps`` samples/chip with an integer sampler.

    Sample i takes the value of chip ``floor(i * n_chips / n_samples)``.
    """
    n_chips = len(code)
    n_samples = int(sps * n_chips)
    chip_idx = np.arange(n_samples) * n_chips // n_samples
    return gold.bipolar(np.asarray(code))[chip_idx]


def generate(bits: int, index: int, sps: float) -> np.ndarray:
    """Generate a sampled Gold-code template."""
    return sample_code(gold.gold(bits, index), sps)


def generate_bank(bits: int, indices, sps: float) -> np.ndarray:
    """Generate a bank of templates [T, L] for multi-transmitter detection.

    All templates in a bank share the same length (same code family),
    enabling batched correlation against every transmitter at once
    (the TPU-native analog of the reference's per-TX identification).
    """
    templates = [generate(bits, i, sps) for i in indices]
    return np.stack(templates, axis=0)
