"""Fused per-row power/peak reduction (counterpart of
thrifty_tpu.dsp.pallas_kernels).

The batched detector reduces each [B, N] carrier spectrum and
correlation to a few numbers per row: the windowed argmax of |x|^2, the
peak power, the total power and, optionally, masked power / magnitude
sums.  Eager PyTorch would take separate passes over [B, N] for the
power, the argmax, the gather and the sum; the hand-written CUDA kernel
``csrc/power_peak.cu`` does all of it in one read of the array.

:func:`fused_power_peak` launches that kernel for a CUDA tensor and
takes the plain PyTorch version :func:`fused_power_peak_reference` for
a CPU tensor; on any other device it raises.  ``launches`` counts the
kernel launches, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LAYOUTS = ("interleaved", "planes")

# Kernel launches made by fused_power_peak (CUDA tensors only).
launches = 0


def fused_power_peak_reference(re, im, mask, stats_mask=None):
    """Plain PyTorch reduction: (windowed argmax of power, peak power,
    total power[, stats-masked power sum, stats-masked magnitude sum]).

    ``re``/``im``: float32 [B, N]; ``mask``/``stats_mask``: bool [N] on
    the same device.  Masked-out columns count as -1.0 in the argmax,
    which keeps the earliest column on ties (torch.argmax).  With the
    stats sums, ``var(mag) = stat_pow/m - (stat_mag/m)**2`` where
    ``m = stats_mask.sum()``.
    """
    power = re * re + im * im
    masked = torch.where(mask, power, -1.0)
    idx = torch.argmax(masked, dim=-1)
    peak = torch.gather(power, -1, idx[..., None])[..., 0]
    total = torch.sum(power, dim=-1)
    idx = idx.to(torch.int32)
    if stats_mask is None:
        return idx, peak, total
    stat_pow = torch.sum(torch.where(stats_mask, power, 0.0), dim=-1)
    stat_mag = torch.sum(torch.where(stats_mask, torch.sqrt(power), 0.0),
                         dim=-1)
    return idx, peak, total, stat_pow, stat_mag


class Mask:
    """A column mask checked on the host and held on the device.

    ``host``: numpy bool [N]; ``flags``: uint8 [N] for the kernel;
    ``bool``: bool [N] for the plain version.  Build it once per
    detector: a mask handed to :func:`fused_power_peak` as a numpy
    array is uploaded on every call.
    """

    def __init__(self, mask, device, allow_empty=False):
        host = np.asarray(mask, dtype=bool)
        if host.ndim != 1:
            raise ValueError("mask must be 1-D, got shape {}".format(
                host.shape))
        if not allow_empty and not host.any():
            # An empty search window is a config error; the kernel's -1.0
            # sentinel would otherwise surface as a masked-out winner.
            raise ValueError("search mask has no True entries "
                             "(empty carrier/correlation window)")
        self.host = host
        self.flags = torch.from_numpy(host.astype(np.uint8)).to(device)
        self.bool = self.flags.bool()

    def __len__(self):
        return len(self.host)


def _as_mask(mask, device, allow_empty=False):
    if isinstance(mask, Mask):
        if mask.flags.device != device:
            raise ValueError("mask lives on {}, data on {}".format(
                mask.flags.device, device))
        if not allow_empty and not mask.host.any():
            raise ValueError("search mask has no True entries "
                             "(empty carrier/correlation window)")
        return mask
    return Mask(mask, device, allow_empty=allow_empty)


def fused_power_peak(x, mask, stats_mask=None, layout="interleaved"):
    """One-pass windowed power argmax + peak + energy over [B, N].

    Parameters
    ----------
    x : complex64 [B, N] tensor, contiguous, on the CPU or a CUDA card
    mask : [N] bool (numpy array or :class:`Mask`): searchable columns;
        an all-False mask raises ``ValueError``
    stats_mask : optional [N] bool; when given the same pass also
        returns the masked power sum and masked magnitude sum
    layout : 'interleaved' (the kernel reads ``view_as_real(x)`` in
        place) or 'planes' (separate contiguous re / im float32 planes,
        made from ``x`` first; the same kernel with element stride 1)

    Returns (idx int32 [B], peak f32 [B], total f32 [B]
    [, stat_pow f32 [B], stat_mag f32 [B]]).
    """
    if layout not in LAYOUTS:
        raise ValueError("unknown layout {!r}: expected 'interleaved' or "
                         "'planes'".format(layout))
    if not isinstance(x, torch.Tensor) or x.dtype != torch.complex64 \
            or x.dim() != 2:
        raise ValueError("x must be a complex64 [B, N] tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[1]
    mask = _as_mask(mask, x.device)
    smask = None if stats_mask is None else _as_mask(
        stats_mask, x.device, allow_empty=True)
    for m in (mask, smask):
        if m is not None and len(m) != n:
            raise ValueError("mask length {} != row length {}".format(
                len(m), n))
    if x.device.type == "cpu":
        return fused_power_peak_reference(
            x.real, x.imag, mask.bool, None if smask is None else smask.bool)
    if x.device.type != "cuda":
        raise ValueError("fused_power_peak runs on 'cpu' or 'cuda' "
                         "tensors, not {!r}".format(x.device.type))
    return _launch(x, mask, smask, layout)


def _library():
    from thrifty_tpu_torch import _build

    lib = _build.load("power_peak")
    if not getattr(lib, "_tt_typed", False):
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.tt_power_peak.restype = ctypes.c_int
        lib.tt_power_peak.argtypes = [p] * 9 + [i64] * 4 + [ctypes.c_int, p]
        lib.tt_error_string.restype = ctypes.c_char_p
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib._tt_typed = True
    return lib


def _launch(x, mask, smask, layout):
    global launches
    lib = _library()
    b, n = x.shape
    dev = x.device
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    peak = torch.empty(b, dtype=torch.float32, device=dev)
    total = torch.empty(b, dtype=torch.float32, device=dev)
    outs = [idx, peak, total]
    if smask is not None:
        outs += [torch.empty(b, dtype=torch.float32, device=dev),
                 torch.empty(b, dtype=torch.float32, device=dev)]
    if layout == "interleaved":
        y = torch.view_as_real(x)  # [B, N, 2] float32, zero-copy
        re_ptr = y.data_ptr()
        im_ptr = re_ptr + 4
        row_stride, elem_stride, interleaved = 2 * x.stride(0), 2, 1
    else:
        re = x.real.contiguous()
        im = x.imag.contiguous()
        re_ptr, im_ptr = re.data_ptr(), im.data_ptr()
        row_stride, elem_stride, interleaved = n, 1, 0
    spow_ptr = outs[3].data_ptr() if smask is not None else None
    smag_ptr = outs[4].data_ptr() if smask is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tt_power_peak(
            re_ptr, im_ptr, mask.flags.data_ptr(),
            None if smask is None else smask.flags.data_ptr(),
            idx.data_ptr(), peak.data_ptr(), total.data_ptr(),
            spow_ptr, smag_ptr, b, n, row_stride, elem_stride,
            interleaved, stream)
    if err != 0:
        raise RuntimeError("power_peak kernel launch failed: {} ({})".format(
            lib.tt_error_string(err).decode(), err))
    if b:
        launches += 1
    return tuple(outs)
