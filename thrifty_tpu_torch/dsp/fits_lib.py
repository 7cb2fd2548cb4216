"""The ctypes binding of ``csrc/fits.cu``, the fit kernels' library.

The wrappers sit beside their plain versions: ``dirichlet.dirichlet_fit``,
``xcorr.autocorr_fit`` and ``xcorr.maximise_search``.  They call
:func:`library` only for a CUDA tensor, so a CPU run never builds or
loads it.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_lib = None


def library() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/fits.cu``; type its C functions
    once."""
    global _lib
    if _lib is None:
        from thrifty_tpu_torch import _build

        lib = _build.load("fits")
        p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_float, ctypes.c_int)
        lib.tt_dirichlet_fit.restype = i32
        lib.tt_dirichlet_fit.argtypes = [p, p, i64, i32] + [f32] * 5 + [
            i32, f32, p]
        lib.tt_autocorr_fit.restype = i32
        lib.tt_autocorr_fit.argtypes = [p] * 4 + [i64, i32, i32, i32, f32,
                                                  f32, i32, f32, p]
        lib.tt_maximise_smem.restype = i64
        lib.tt_maximise_smem.argtypes = [i64]
        lib.tt_maximise.restype = i32
        lib.tt_maximise.argtypes = [p, p, i32, p, p, i64, i64, f32, f32, f32,
                                    i32, p]
        lib.tt_error_string.restype = ctypes.c_char_p
        lib.tt_error_string.argtypes = [i32]
        _lib = lib
    return _lib


@contextlib.contextmanager
def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for a launch (when it is
    not already); yields its current stream's handle."""
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            yield torch.cuda.current_stream(dev).cuda_stream
    else:
        yield torch.cuda.current_stream(dev).cuda_stream


def check(err: int, what: str):
    """Raise for a launch's non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError("{} kernel launch failed: {} ({})".format(
            what, library().tt_error_string(err).decode(), err))
