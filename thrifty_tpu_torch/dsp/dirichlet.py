"""Sub-bin carrier interpolation by Dirichlet-kernel fitting
(counterpart of thrifty_tpu.dsp.dirichlet).

The carrier is a finite-duration sinusoid, so its DFT magnitude around
the peak follows |A * D(x - delta)| with D the Dirichlet kernel.  The
reference fits (A, delta) per block with scipy's curve_fit
(thrifty/carrier_sync.py:150-196); here the fit is a fixed number of
damped Gauss-Newton steps with an analytic Jacobian and a closed-form
2x2 solve per step, run on the whole batch at once:
:func:`dirichlet_fit` launches ``csrc/fits.cu``'s kernel (one thread per
row, every step in registers) for a CUDA tensor and takes the plain
version :func:`dirichlet_fit_reference` (an eager loop of [B, width]
element-wise ops) for a CPU tensor.  ``launches`` counts the kernel's
launches.

The other carrier interpolators (parabolic, gaussian, cosine, polyfit)
are closed forms on the same gathered neighbourhood, and
:func:`dirichlet_weights` shapes the carrier peak filter.
"""

from __future__ import annotations

import numpy as np
import torch

from thrifty_tpu_torch.dsp.xcorr import guard_denominator


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


def dirichlet_fit_reference(y: torch.Tensor, block_len: int,
                            carrier_len: int, iters: int = 12,
                            damping: float = 1e-4) -> torch.Tensor:
    """The plain PyTorch Dirichlet fit: ``iters`` damped Gauss-Newton
    steps of |A*D(x - delta)| on ``y`` [..., P] (P odd, x = -P//2 ..
    P//2) as an eager loop (the JAX package runs the same steps in
    ``lax.scan``).  Returns delta [...]."""
    half = y.shape[-1] // 2
    xgrid = torch.arange(-half, half + 1, dtype=y.dtype, device=y.device)
    amp = y[..., half]
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


# Kernel launches made by dirichlet_fit (CUDA tensors only).
launches = 0


def dirichlet_fit(y: torch.Tensor, block_len: int, carrier_len: int,
                  iters: int = 12, damping: float = 1e-4) -> torch.Tensor:
    """The Dirichlet fit of :func:`dirichlet_fit_reference`: on a CUDA
    tensor one launch of ``csrc/fits.cu``'s ``dirichlet_fit_kernel``
    (float32 [..., P] with P odd, else it raises), on a CPU tensor
    the plain version; any other device raises."""
    if y.device.type == "cpu":
        return dirichlet_fit_reference(y, block_len, carrier_len, iters,
                                       damping)
    if y.device.type != "cuda":
        raise ValueError("dirichlet_fit runs on 'cpu' or 'cuda' tensors, "
                         "not {!r}".format(y.device.type))
    return _launch(y, block_len, carrier_len, iters, damping)


def _launch(y, block_len, carrier_len, iters, damping):
    global launches
    from thrifty_tpu_torch.dsp import fits_lib

    p = y.shape[-1] if y.dim() else 0
    if y.dtype != torch.float32 or p % 2 == 0:
        raise ValueError("the Dirichlet fit kernel takes float32 [..., P] "
                         "with P odd, got {} {}".format(y.dtype,
                                                        tuple(y.shape)))
    rows = y.reshape(-1, p).contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=y.device)
    # The plain version's Python scalars, each rounded once to float32.
    a = np.pi / block_len
    with fits_lib.on_device(y.device) as stream:
        err = fits_lib.library().tt_dirichlet_fit(
            rows.data_ptr(), out.data_ptr(), rows.shape[0], p, a,
            a * carrier_len, carrier_len, a * a,
            carrier_len * carrier_len - 1.0, iters, 1.0 + damping, stream)
    fits_lib.check(err, "dirichlet_fit")
    if rows.shape[0]:
        launches += 1
    return out.reshape(y.shape[:-1])


def make_dirichlet_interpolator(block_len: int, carrier_len: int,
                                width: int = 6, iters: int = 12,
                                damping: float = 1e-4):
    """Build a batched sub-bin interpolator fitting |A*D(x-delta)|.

    Returns ``interp(values[..., P]) -> delta [...]`` with P = 2*(width
    // 2) + 1: the neighbourhood of magnitudes centred on the peak goes
    in, and :func:`dirichlet_fit` runs ``iters`` damped Gauss-Newton
    steps (one kernel launch on the card).
    """
    points = 2 * (width // 2) + 1

    def interpolate(y: torch.Tensor) -> torch.Tensor:
        if y.shape[-1] != points:
            raise ValueError("expected {} magnitudes per row (width {}), "
                             "got {}".format(points, width, y.shape[-1]))
        return dirichlet_fit(y, block_len, carrier_len, iters, damping)

    return interpolate


def dirichlet_weights(filter_len: int, block_len: int,
                      carrier_len: int) -> np.ndarray:
    """Unit-energy Dirichlet-shaped weights for the carrier peak filter,
    float64 numpy (JAX ``dirichlet_weights`` on its numpy branch, term
    for term, so the weights are bit-equal)."""
    x = np.arange(-(filter_len // 2), filter_len // 2 + 1)
    n, w = block_len, carrier_len
    a = np.pi / n
    num = np.sin(a * w * x)
    den = np.sin(a * x)
    taylor = 1.0 - (a * a) * x * x * (w * w - 1.0) / 6.0
    safe_den = np.where(np.abs(x) < 1e-2, 1.0, den)
    coeffs = np.where(np.abs(x) < 1e-2, taylor, num / (w * safe_den))
    return coeffs / np.sqrt(np.sum(coeffs**2))


def parabolic_interpolate(values: torch.Tensor, clip=None) -> torch.Tensor:
    """Batched 3-point parabolic sub-bin interpolation.

    offset = (c - a) / (4b - 2a - 2c) on the neighbourhood ``values``
    [..., 3] = (a, b, c) (reference thrifty/carrier_sync.py:199-204),
    with a +-1e-30 guard on the denominator.  ``clip`` bounds the offset
    to +-clip: fastdet clips its carrier offset to +-0.5
    (fastdet/corr_detector.cpp:88-101), the Python reference does not.
    """
    a, b, c = values[..., 0], values[..., 1], values[..., 2]
    offset = (c - a) / guard_denominator(4.0 * b - 2.0 * a - 2.0 * c)
    if clip is not None:
        offset = torch.clamp(offset, -clip, clip)
    return offset


def gaussian_interpolate(values: torch.Tensor, clip=None) -> torch.Tensor:
    """Batched 3-point Gaussian (log-parabolic) sub-bin interpolation:
    (ln c - ln a) / (4 ln b - 2 ln a - 2 ln c) on ``values`` [..., 3]
    (reference thrifty/experimental/carrier_interpolators.py:48-54).
    Not shared with ``xcorr.gaussian_interpolate``: the carrier form has
    no bounds mask (bins wrap) and a different scale."""
    y = torch.clamp(values, min=1e-30)
    la, lb, lc = torch.log(y[..., 0]), torch.log(y[..., 1]), \
        torch.log(y[..., 2])
    offset = (lc - la) / guard_denominator(4.0 * lb - 2.0 * la - 2.0 * lc)
    if clip is not None:
        offset = torch.clamp(offset, -clip, clip)
    return offset


def cosine_interpolate(values: torch.Tensor) -> torch.Tensor:
    """Batched 3-point cosine-fit sub-bin interpolation through y_k =
    A cos(w k + theta) (reference thrifty/experimental/
    carrier_interpolators.py:84-93); 0 where (a + c) / 2b > 1, the
    reference's guard."""
    a, b, c = values[..., 0], values[..., 1], values[..., 2]
    b = torch.clamp(b, min=1e-30)
    cos_w = (a + c) / (2.0 * b)
    w = torch.arccos(torch.clamp(cos_w, -0.999999, 0.999999))
    sin_w = torch.where(torch.sin(w) == 0, 1e-30, torch.sin(w))
    theta = torch.atan((a - c) / (2.0 * b * sin_w))
    offset = -theta / torch.where(w == 0, 1e-30, w)
    return torch.where(cos_w <= 1.0, offset, 0.0)


def make_polyfit_interpolator(width: int):
    """Batched quadratic least-squares sub-bin interpolation over
    ``width+1`` points (reference thrifty/carrier_sync.py:207-219): a
    projection onto the pseudo-inverse of the [x^2, x, 1] Vandermonde
    matrix, built once in float64 and applied in the values' dtype.

    Returns ``interp(values[..., width+1]) -> offset``.
    """
    xs = np.arange(-(width // 2), width // 2 + 1).astype(np.float64)
    pinv = np.linalg.pinv(np.stack([xs**2, xs, np.ones_like(xs)], axis=1))
    # The matrix on each (dtype, device), moved there once: no upload a
    # batch, and a captured CUDA graph reads it by address on replays.
    moved = {}

    def interpolate(values: torch.Tensor) -> torch.Tensor:
        key = (values.dtype, values.device)
        p = moved.get(key)
        if p is None:
            p = moved[key] = torch.as_tensor(pinv, dtype=values.dtype,
                                             device=values.device)
        # Element-wise product and sum (no matmul: no TF32 path at all).
        coeffs = torch.sum(values[..., None, :] * p, dim=-1)
        return -coeffs[..., 1] / guard_denominator(coeffs[..., 0]) / 2.0

    return interpolate
