"""Plain PyTorch float64 reference of upstream fastdet's receiver.

Upstream ``fastdet`` (fastdet/fastdet.cpp, fastdet/corr_detector.cpp)
fuses capture and detect: every block runs the carrier detector of
fastcard (fastcard/cardet.c), and only the blocks whose carrier was
detected are correlated with the template.  This module computes those
semantics one block at a time, in float64, with plain ``torch`` ops:

- the carrier FFT of the block and its power spectrum;
- the peak power in the carrier window, the noise variance
  ``(sum - 2 * peak) / (N - 1)`` of the spectrum's power, kept signed as
  fastcard keeps it, and the detection ``peak > const + snr * noise``
  (cardet.c:22-27);
- on a detection, the 3-point parabolic sub-bin fit on the magnitudes,
  ``(c - a) / (4b - 2a - 2c)`` clipped to +-0.5 (corr_detector.cpp:
  88-101, 190-194), the integer roll of the carrier FFT by the peak bin
  (:13-17, 178-182), the product with the template's conjugate spectrum
  and the inverse FFT (:132-141);
- the correlation peak over the block's unique lags (:148-155), its
  noise ``(signal energy * template energy - peak power) / N`` and the
  same threshold form (:118-125, 159), and the Gaussian sub-sample fit
  on the log magnitudes clipped to +-0.5 (:103-116).

There is no capacity: every carrier-positive block is correlated, as
fastdet does.  The port's gated detector (``gate_capacity``) has to give
these answers whether its batch overflows the gate or not.

Departures from fastdet/corr_detector.cpp, each also a departure of the
port's NumPy oracle (``numpy_ref.FastdetOracleDetector``):

- float64 throughout, where fastdet converts bytes through a float32
  table (fastcard/rawconv.c:10-11) and runs FFTW and volk in float32;
- the outputs are the port's ``.toad`` fields: peak magnitudes (the
  square roots of fastdet's powers) and noise as an rms magnitude;
- the Gaussian fit takes the logs of magnitudes where fastdet takes
  those of powers: the factor 2 cancels in the offset;
- the correlation offset is 0 where the correlation is not detected or
  its peak has no neighbour on one side, as the port reports it.

Where the noise variance is negative (a carrier or a burst holding more
than half the energy) this module follows fastdet's signed threshold
and reports a noise of 0; the NumPy oracle's square root there is NaN
and detects nothing.  The tests use streams without such blocks.

It imports only ``torch``, ``numpy`` and the standard library: nothing of
the port, no kernel, no JAX.  No code path of the program reads it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

DC_OFFSET = 127.4  # upstream's byte-to-sample conversion (rawconv.c)
CLIP = 0.5         # fastdet's bound on both sub-bin / sub-sample offsets
FIELDS = ("detected", "carrier_detect", "carrier_bin", "carrier_offset",
          "carrier_energy", "carrier_noise", "corr_sample", "corr_offset",
          "corr_energy", "corr_noise")


@contextlib.contextmanager
def no_tf32():
    """TF32 off for float32 products on a card while the reference
    computes; the flags as they were afterwards."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def window_indices(start, stop, length):
    """FFT array indices of the closed signed-bin interval [start, stop],
    wrapped (upstream thrifty/carrier_detect.py:17-58); (0, -1) is the
    whole spectrum."""
    if abs(start) >= length or abs(stop) >= length:
        raise ValueError(
            "frequency window out of range: {} - {}".format(start, stop))
    if start < 0 and stop >= 0:
        start, stop = length + start, length + stop
    if start < 0:
        start = length + start
    if stop < 0:
        stop = length + stop
    if stop < start:
        start, stop = stop, start
    return torch.arange(start, stop + 1) % length


class FastdetPlain:
    """fastdet's detector, one block at a time, at the precision of
    ``REAL`` and ``COMPLEX``."""

    REAL = torch.float64
    COMPLEX = torch.complex128

    def __init__(self, template, block_len=16384, history_len=4920,
                 carrier_thresh=(0.0, 15.0, 0.0), carrier_window=None,
                 corr_thresh=(0.0, 15.0, 0.0)):
        for name, coeffs in (("carrier_thresh", carrier_thresh),
                             ("corr_thresh", corr_thresh)):
            if coeffs[2]:
                raise ValueError("{}: fastdet has no stddev term".format(
                    name))
        template = torch.as_tensor(np.asarray(template, np.float64),
                                   dtype=self.REAL)
        if template.dim() != 1:
            raise ValueError("template must be 1-D")
        tlen = template.shape[0]
        if history_len < tlen - 1:
            raise ValueError("history_len must be >= template_len - 1")
        self.block_len = block_len
        self.carrier_thresh = carrier_thresh[:2]
        self.corr_thresh = corr_thresh[:2]
        self.template_energy = torch.sum(template * template)
        padded = torch.zeros(block_len, dtype=self.REAL)
        padded[:tlen] = template
        self.template_fft_conj = torch.conj(torch.fft.fft(
            padded.to(self.COMPLEX)))
        self.corr_len = block_len - tlen + 1
        # The lags unique to a block (thrifty/soa_estimator.py:20-39).
        padding = history_len - tlen + 1
        self.lags = (padding // 2, self.corr_len - (padding - padding // 2))
        window = (0, -1) if carrier_window is None else carrier_window
        self.carrier_idx = window_indices(window[0], window[1], block_len)

    def raw_to_iq(self, raw):
        """uint8 interleaved I/Q [..., 2N] -> complex [..., N]."""
        f = torch.as_tensor(np.asarray(raw)).to(self.REAL)
        return torch.complex((f[..., 0::2] - DC_OFFSET) / 128.0,
                             (f[..., 1::2] - DC_OFFSET) / 128.0)

    def detect_block(self, block):
        """The fields of :data:`FIELDS` for one complex block [N], as
        Python numbers."""
        n = self.block_len
        block = torch.as_tensor(block).to(self.COMPLEX)
        spec = torch.fft.fft(block)
        power = spec.real * spec.real + spec.imag * spec.imag
        sel = power[self.carrier_idx]
        k = int(torch.argmax(sel))
        c_bin = int(self.carrier_idx[k])
        c_pow = sel[k]
        c_var = (torch.sum(power) - 2.0 * c_pow) / (n - 1)
        const, snr = self.carrier_thresh
        c_det = bool(c_pow > const + snr * c_var)
        out = {"detected": False, "carrier_detect": c_det,
               "carrier_bin": c_bin, "carrier_offset": 0.0,
               "carrier_energy": float(torch.sqrt(c_pow)),
               "carrier_noise": float(torch.sqrt(torch.clamp(c_var,
                                                             min=0.0))),
               "corr_sample": 0, "corr_offset": 0.0, "corr_energy": 0.0,
               "corr_noise": 0.0}
        if not c_det:
            return out
        mag = torch.sqrt(power)
        a, b, c = (mag[(c_bin + d) % n] for d in (-1, 0, 1))
        den = 4.0 * b - 2.0 * a - 2.0 * c
        if den != 0:
            out["carrier_offset"] = float(torch.clamp((c - a) / den,
                                                      -CLIP, CLIP))

        corr = torch.fft.ifft(torch.roll(spec, -c_bin)
                              * self.template_fft_conj)
        corr_mag = torch.abs(corr[:self.corr_len])
        lo, hi = self.lags
        p = int(torch.argmax(corr_mag[lo:hi])) + lo
        p_mag = corr_mag[p]
        signal_energy = torch.sum(block.real * block.real
                                  + block.imag * block.imag)
        p_var = (signal_energy * self.template_energy - p_mag * p_mag) / n
        const, snr = self.corr_thresh
        p_det = bool(p_mag * p_mag > const + snr * p_var)
        out.update(detected=p_det, corr_sample=p,
                   corr_energy=float(p_mag),
                   corr_noise=float(torch.sqrt(torch.clamp(p_var,
                                                           min=0.0))))
        if p_det and 0 < p < self.corr_len - 1:
            la, lb, lc = torch.log(corr_mag[p - 1:p + 2])
            den = 2.0 * lb - la - lc
            if den != 0:
                out["corr_offset"] = float(torch.clamp(
                    0.5 * (lc - la) / den, -CLIP, CLIP))
        return out

    def detect(self, blocks):
        """{field: numpy [B]} of complex blocks [B, N], block by block."""
        with no_tf32():
            rows = [self.detect_block(b) for b in torch.as_tensor(blocks)]
        return {k: np.array([r[k] for r in rows]) for k in FIELDS}

    def detect_raw(self, raw):
        """:meth:`detect` of uint8 interleaved I/Q blocks [B, 2N]."""
        return self.detect(self.raw_to_iq(raw))
