""".tpl binary template format (int16 length + float32 samples).

The reference's native detector consumes templates in this format
(fastdet/corr_detector.cpp:200-228, scripts/npy_to_tpl.py:20-23);
supported here for interchange with existing deployments.
"""

from __future__ import annotations

import numpy as np


def save_tpl(path_or_stream, template: np.ndarray):
    template = np.asarray(template, dtype=np.float32)
    if len(template) >= 2**15:
        raise ValueError(
            "the .tpl format's int16 length field cannot represent {} "
            "samples (max 32767)".format(len(template)))
    if isinstance(path_or_stream, str):
        with open(path_or_stream, "wb") as f:
            return save_tpl(f, template)
    np.int16(len(template)).tofile(path_or_stream)
    template.tofile(path_or_stream)


def load_template(path: str) -> np.ndarray:
    """Load a template from .npy or .tpl by file extension."""
    if path.endswith(".tpl"):
        return load_tpl(path)
    return np.load(path)


def load_tpl(path_or_stream) -> np.ndarray:
    if isinstance(path_or_stream, str):
        with open(path_or_stream, "rb") as f:
            return load_tpl(f)
    length = int(np.fromfile(path_or_stream, dtype=np.int16, count=1)[0])
    template = np.fromfile(path_or_stream, dtype=np.float32, count=length)
    if len(template) != length:
        raise ValueError("truncated .tpl file")
    return template.astype(np.float64)
