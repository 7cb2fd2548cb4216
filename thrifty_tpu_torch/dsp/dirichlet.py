"""Sub-bin carrier interpolation by Dirichlet-kernel fitting
(counterpart of thrifty_tpu.dsp.dirichlet).

The carrier is a finite-duration sinusoid, so its DFT magnitude around
the peak follows |A * D(x - delta)| with D the Dirichlet kernel.  The
reference fits (A, delta) per block with scipy's curve_fit
(thrifty/carrier_sync.py:150-196); here the fit is a fixed number of
damped Gauss-Newton steps with an analytic Jacobian, run on the whole
batch at once: a handful of [B, width] element-wise ops and a
closed-form 2x2 solve per step.
"""

from __future__ import annotations

import numpy as np
import torch


def dirichlet_kernel(x: torch.Tensor, block_len: int, carrier_len: int):
    """D(x) = sin(pi*W*x/N) / (W * sin(pi*x/N)), with D(0) = 1 and a
    Taylor form near 0 for numerical stability."""
    n, w = block_len, carrier_len
    a = np.pi / n
    num = torch.sin(a * w * x)
    den = torch.sin(a * x)
    # Taylor about 0: D(x) ~= 1 - a^2 x^2 (W^2-1)/6
    taylor = 1.0 - (a * a) * x * x * (w * w - 1.0) / 6.0
    near = torch.abs(x) < 1e-2
    safe_den = torch.where(near, 1.0, den)
    return torch.where(near, taylor, num / (w * safe_den))


def dirichlet_kernel_deriv(x: torch.Tensor, block_len: int,
                           carrier_len: int):
    """Analytic derivative dD/dx of the Dirichlet kernel."""
    n, w = block_len, carrier_len
    a = np.pi / n
    sin_wx, cos_wx = torch.sin(a * w * x), torch.cos(a * w * x)
    sin_x, cos_x = torch.sin(a * x), torch.cos(a * x)
    num = a * w * cos_wx * sin_x - a * sin_wx * cos_x
    den = w * sin_x * sin_x
    # Taylor about 0: D'(x) ~= -a^2 x (W^2-1)/3
    taylor = -(a * a) * x * (w * w - 1.0) / 3.0
    near = torch.abs(x) < 1e-2
    safe_den = torch.where(near, 1.0, den)
    return torch.where(near, taylor, num / safe_den)


def gather_neighborhood(values: torch.Tensor, peak_idx: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """values[..., (peak_idx + k) mod N] for k in ``offsets`` (magnitude
    or complex arrays; FFT bins and circular lags both wrap)."""
    n = values.shape[-1]
    idx = torch.remainder(peak_idx[..., None].to(torch.int64) + offsets, n)
    return torch.gather(values, -1, idx)


def make_dirichlet_interpolator(block_len: int, carrier_len: int,
                                width: int = 6, iters: int = 12,
                                damping: float = 1e-4):
    """Build a batched sub-bin interpolator fitting |A*D(x-delta)|.

    Returns ``interp(values[..., width+1]) -> delta [...]``: the
    neighbourhood of ``width+1`` magnitudes centred on the peak goes in,
    and ``iters`` damped Gauss-Newton steps (a Python loop; the JAX
    package runs the same steps in ``lax.scan``) fit the offset.
    """
    xs = np.arange(-(width // 2), width // 2 + 1).astype(np.float64)

    def interpolate(y: torch.Tensor) -> torch.Tensor:
        xgrid = torch.as_tensor(xs, dtype=y.dtype, device=y.device)
        amp = y[..., len(xs) // 2]
        delta = torch.zeros_like(amp)
        for _ in range(iters):
            u = xgrid - delta[..., None]
            d = dirichlet_kernel(u, block_len, carrier_len)
            absd = torch.abs(d)
            resid = y - amp[..., None] * absd
            # Jacobian of the model m = A*|D(x-delta)|:
            #   dm/dA = |D|,  dm/ddelta = -A * sign(D) * D'(x-delta)
            j_a = absd
            j_d = -amp[..., None] * torch.sign(d) * dirichlet_kernel_deriv(
                u, block_len, carrier_len)
            # Damped normal equations, closed-form 2x2 solve per row.
            a11 = torch.sum(j_a * j_a, dim=-1) * (1.0 + damping)
            a22 = torch.sum(j_d * j_d, dim=-1) * (1.0 + damping) + 1e-20
            a12 = torch.sum(j_a * j_d, dim=-1)
            b1 = torch.sum(j_a * resid, dim=-1)
            b2 = torch.sum(j_d * resid, dim=-1)
            det = a11 * a22 - a12 * a12
            det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
            step_a = (a22 * b1 - a12 * b2) / det
            step_d = (a11 * b2 - a12 * b1) / det
            # The true offset is sub-bin; clamp to keep iterates in-basin.
            amp = amp + step_a
            delta = torch.clamp(delta + step_d, -1.0, 1.0)
        return delta

    return interpolate


def parabolic_interpolate(values: torch.Tensor, clip=None) -> torch.Tensor:
    """Batched 3-point parabolic sub-bin interpolation.

    offset = (c - a) / (4b - 2a - 2c) on the neighbourhood ``values``
    [..., 3] = (a, b, c) (reference thrifty/carrier_sync.py:199-204),
    with a +-1e-30 guard on the denominator.  ``clip`` bounds the offset
    to +-clip: fastdet clips its carrier offset to +-0.5
    (fastdet/corr_detector.cpp:88-101), the Python reference does not.
    """
    a, b, c = values[..., 0], values[..., 1], values[..., 2]
    den = 4.0 * b - 2.0 * a - 2.0 * c
    tiny = torch.where(den < 0.0, -1e-30, 1e-30)
    den = torch.where(torch.abs(den) < 1e-30, tiny, den)
    offset = (c - a) / den
    if clip is not None:
        offset = torch.clamp(offset, -clip, clip)
    return offset
