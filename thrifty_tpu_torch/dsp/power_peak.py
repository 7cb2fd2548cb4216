"""Fused per-row power/peak reduction (counterpart of
thrifty_tpu.dsp.pallas_kernels).

The batched detector reduces each [B, N] carrier spectrum and
correlation to a few numbers per row: the windowed argmax of |x|^2, the
peak power, the total power and, optionally, masked power / magnitude
sums.  Eager PyTorch would take separate passes over [B, N] for the
power, the argmax, the gather and the sum; the hand-written CUDA kernel
``csrc/power_peak.cu`` does all of it in one read of the array, with one
CTA per row, or a row split over a thread-block cluster when the rows
are too few to fill the card (:func:`cluster_plan`).

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
        self.nonempty = bool(host.any())
        if not allow_empty and not self.nonempty:
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
        if not allow_empty and not mask.nonempty:
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


# The kernel's launch plan (csrc/power_peak.cu:make_plan, mirrored here
# for the tests): a row of n columns is split over a cluster of S CTAs
# only while the rows alone give fewer CTAs than half the card's SMs, and
# never into slices under CTA_COLS columns: S = clamp(min(ceil(sms / 2 /
# rows), ceil(n / CTA_COLS)), 1, MAX_CLUSTER).  Each CTA reduces a slice
# of ceil(n / S) columns rounded up to a multiple of SLICE_ALIGN.
CTA_COLS = 2048
MAX_CLUSTER = 8
SLICE_ALIGN = 4


def cluster_plan(n, rows, sms):
    """(CTAs per row S, columns per CTA) for ``rows`` rows of ``n``
    samples on a card with ``sms`` streaming multiprocessors."""
    by_rows = -(-max(sms // 2, 1) // rows) if rows > 0 else 1
    s = min(max(min(by_rows, -(-n // CTA_COLS)), 1), MAX_CLUSTER)
    slice_len = -(-n // s)
    return s, slice_len + -slice_len % SLICE_ALIGN


def vector_path(re, im, mask, smask, row_stride, elem_stride, interleaved):
    """Does the kernel take its 16-byte load path for these operands?
    Addresses in bytes, strides in floats (as the C interface takes
    them).  It needs the row base (and, in planes, the im plane and an
    element stride of 1) and the masks 16-byte aligned, and rows
    ``4 * row_stride`` bytes apart on a 16-byte boundary; anything else
    takes the scalar path of the same kernel."""
    vec = re % 16 == 0 and mask % 16 == 0 \
        and (smask is None or smask % 16 == 0) and (4 * row_stride) % 16 == 0
    if not interleaved:
        vec = vec and im % 16 == 0 and elem_stride == 1
    return vec


def slice_bounds(n, rows, sms):
    """[(lo, hi)] of the S column slices of a row, in rank order."""
    s, slice_len = cluster_plan(n, rows, sms)
    return [(min(r * slice_len, n), min((r + 1) * slice_len, n))
            for r in range(s)]


_fn = None     # the typed tt_power_peak, once the library is loaded
_plan = None   # the typed tt_power_peak_plan
_errstr = None


def _library():
    """Build (if needed) and load the kernel; type its C functions once."""
    global _fn, _plan, _errstr
    if _fn is None:
        from thrifty_tpu_torch import _build

        lib = _build.load("power_peak")
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.tt_power_peak.restype = ctypes.c_int
        lib.tt_power_peak.argtypes = [p] * 9 + [i64] * 4 + [ctypes.c_int, p]
        lib.tt_power_peak_plan.restype = None
        lib.tt_power_peak_plan.argtypes = [p] * 4 + [i64] * 4 + [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.tt_error_string.restype = ctypes.c_char_p
        lib.tt_error_string.argtypes = [ctypes.c_int]
        _plan, _errstr = lib.tt_power_peak_plan, lib.tt_error_string
        _fn = lib.tt_power_peak
    return _fn


def _operands(x, layout):
    """(re pointer, im pointer, row stride, element stride, interleaved,
    tensors to keep alive) as the kernel reads ``x`` in ``layout``."""
    if layout == "interleaved":
        ptr = x.data_ptr()  # view_as_real(x): [B, N, 2] float32, zero-copy
        return ptr, ptr + 4, 2 * x.stride(0), 2, 1, ()
    re = x.real.contiguous()
    im = x.imag.contiguous()
    return re.data_ptr(), im.data_ptr(), x.shape[1], 1, 0, (re, im)


def kernel_plan(x, mask, stats_mask=None, layout="interleaved"):
    """The launch plan the kernel itself computes for these operands on
    the current CUDA device: (S, columns per CTA, vector path?, SMs
    counted).  Tests hold it against :func:`cluster_plan` and
    :func:`vector_path`."""
    _library()
    dev = x.device
    mask = _as_mask(mask, dev)
    smask = None if stats_mask is None else _as_mask(stats_mask, dev,
                                                     allow_empty=True)
    re_ptr, im_ptr, row_stride, elem_stride, inter, _ = _operands(x, layout)
    out = (ctypes.c_int * 4)()
    _plan(re_ptr, im_ptr, mask.flags.data_ptr(),
          None if smask is None else smask.flags.data_ptr(), x.shape[0],
          x.shape[1], row_stride, elem_stride, inter, out)
    return out[0], out[1], bool(out[2]), out[3]


def _launch(x, mask, smask, layout):
    global launches
    dev = x.device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, mask, smask, layout)
    fn = _library()
    b, n = x.shape
    # One output buffer per call: rows idx (int32 view), peak, total
    # [, stat_pow, stat_mag]; unbind makes the row views in one call.
    out = torch.empty((3 if smask is None else 5, b), dtype=torch.float32,
                      device=dev)
    re_ptr, im_ptr, row_stride, elem_stride, inter, _keep = _operands(
        x, layout)
    base, step = out.data_ptr(), 4 * b
    stats = smask is not None
    err = fn(re_ptr, im_ptr, mask.flags.data_ptr(),
             smask.flags.data_ptr() if stats else None, base, base + step,
             base + 2 * step, base + 3 * step if stats else None,
             base + 4 * step if stats else None, b, n, row_stride,
             elem_stride, inter, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("power_peak kernel launch failed: {} ({})".format(
            _errstr(err).decode(), err))
    if b:
        launches += 1
    rows = out.unbind(0)
    return (rows[0].view(torch.int32),) + rows[1:]
