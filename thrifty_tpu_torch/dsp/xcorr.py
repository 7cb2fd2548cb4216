"""Batched matched filtering and sub-sample SoA estimation (counterpart of
thrifty_tpu.dsp.xcorr).

  corr      = IFFT(FFT(block_shifted) * conj(FFT(template)))
  noise_rms = sqrt((E_signal * E_template - peak^2) / N)
  threshold = sqrt(c + s*noise^2 + d*var(|corr|))
  offset    = sub-sample interpolation around the peak (gaussian by
              default, clipped to +-0.6)

(reference thrifty/soa_estimator.py:42-170).  The template constants are
numpy, computed once on the host in float64 and rounded to the device
dtypes exactly as the JAX package rounds them; a [T, L] template bank
gives [T, N] spectra and [T] energies.

Every interpolator takes the neighbourhood form the detector uses:
``values`` [..., 2*half+1] magnitudes gathered around ``peak_idx`` and
``length`` (the number of unique lags) for the bounds check; the
``maximise`` interpolator reads the correlation spectrum instead.

The two iterative interpolators, the autocorr fit and the maximise
search, launch ``csrc/fits.cu``'s kernels for CUDA tensors
(:func:`autocorr_fit`, :func:`maximise_search`: one launch per call,
counted in ``autocorr_launches`` / ``maximise_launches``) and take their
plain versions, the eager loops :func:`autocorr_fit_reference` and
:func:`maximise_reference`, for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def corr_window(block_len: int, history_len: int, template_len: int):
    """Half-open [start, stop) interval of correlation lags unique to a block.

    With overlap-save blocking a correlation peak inside this window
    appears in exactly one block (reference thrifty/soa_estimator.py:20-39).
    """
    if history_len < template_len - 1:
        raise ValueError("history_len must be >= template_len - 1")
    corr_len = block_len - template_len + 1
    padding = history_len - template_len + 1
    left = padding // 2
    right = padding - left
    return left, corr_len - right


def template_fft_conj(template: np.ndarray, block_len: int) -> np.ndarray:
    """conj(FFT(zero-padded template)) as complex64, computed in float64:
    [block_len] for one template, [T, block_len] for a [T, L] bank (a
    bank stays 2-D even with one row)."""
    template = np.asarray(template, dtype=np.float64)
    if template.ndim not in (1, 2):
        raise ValueError("expected a 1-D template or a 2-D [T, L] bank")
    single = template.ndim == 1
    tmpl2d = np.atleast_2d(template)
    padded = np.zeros((tmpl2d.shape[0], block_len), dtype=np.float64)
    padded[:, :tmpl2d.shape[1]] = tmpl2d
    out = np.conj(np.fft.fft(padded)).astype(np.complex64)
    return out[0] if single else out


def template_energy(template: np.ndarray) -> np.ndarray:
    """Sum of squared template samples (per template of a bank), float32."""
    template = np.asarray(template, dtype=np.float64)
    return np.sum(template**2, axis=-1).astype(np.float32)


def despread_spec(shifted_fft: torch.Tensor,
                  tmpl_fft_conj: torch.Tensor) -> torch.Tensor:
    """Correlation spectrum X = FFT(block_shifted) * conj(FFT(template)):
    [B, N] * [N] -> [B, N], or [B, N] * [T, N] -> [B, T, N]; corr =
    IFFT(X)."""
    if tmpl_fft_conj.dim() == 2:
        return shifted_fft[:, None, :] * tmpl_fft_conj[None, :, :]
    return shifted_fft * tmpl_fft_conj


def noise_rms(peak_mag, signal_energy, tmpl_energy, block_len: int):
    """Correlation-domain noise estimate: the block's time-domain energy
    sum(|x|^2) times the template energy is the total correlation
    energy; the peak's power is subtracted (reference
    thrifty/soa_estimator.py:108-120)."""
    corr_energy = signal_energy * tmpl_energy
    power = (corr_energy - torch.square(peak_mag)) / block_len
    return torch.sqrt(torch.clamp(power, min=0.0))


def var_from_stats(stat_pow, stat_mag, count: int):
    """var(|x|) over ``count`` entries from the power/peak reduction's
    one-pass sums (sum |x|^2, sum |x|): E[|x|^2] - E[|x|]^2, clamped at
    0 because the uncentred form can cancel to -epsilon in float32 on a
    near-constant magnitude surface (JAX ``var_from_stats``,
    thrifty_tpu/dsp/detector.py:714-722).  The stddev threshold term
    d*std^2 is ``d * var_from_stats(...)``."""
    mean = stat_mag / count
    return torch.clamp(stat_pow / count - torch.square(mean), min=0.0)


def _gather_neighborhood(corr_mag, peak_idx, half, values=None,
                         length=None):
    """(y [..., 2*half+1], in_bounds [...]) around each peak.

    ``values`` bypasses the gather with a precomputed neighbourhood
    (pass ``length`` for the bounds check then).  Peaks within ``half``
    of either edge are flagged out of bounds (callers return offset 0
    there); the gather indices are clipped so those lanes still read
    valid memory.
    """
    n = corr_mag.shape[-1] if length is None else length
    if values is None:
        safe_idx = torch.clamp(peak_idx.to(torch.int64), half, n - half - 1)
        offs = torch.arange(-half, half + 1, device=peak_idx.device)
        y = torch.gather(corr_mag, -1, safe_idx[..., None] + offs)
    else:
        y = values
    in_bounds = (peak_idx >= half) & (peak_idx < n - half)
    return y, in_bounds


def guard_denominator(den):
    """Replace |den| < 1e-30 by +-1e-30 (the sign of den, + for 0): the
    guard of every closed-form interpolator's denominator."""
    tiny = torch.where(den < 0.0, -1e-30, 1e-30)
    return torch.where(torch.abs(den) < 1e-30, tiny, den)


def gaussian_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                         values=None, length=None):
    """Batched Gaussian (log-parabolic) sub-sample peak interpolation.

    offset = 0.5*(ln c - ln a)/(2 ln b - ln a - ln c), clipped to +-clip
    (reference thrifty/soa_estimator.py:159-170).  Out-of-bounds peaks
    return offset 0.  ``values`` bypasses the gather with a
    precomputed [..., 3] magnitude neighbourhood (pass ``length`` for
    the bounds check then); ``corr_mag`` may then be None.
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1, values,
                                        length)
    y = torch.clamp(y, min=1e-30)  # guard log of zero magnitudes
    la, lb, lc = torch.log(y[..., 0]), torch.log(y[..., 1]), \
        torch.log(y[..., 2])
    offset = 0.5 * (lc - la) / guard_denominator(2.0 * lb - la - lc)
    offset = torch.clamp(offset, -clip, clip)
    return torch.where(in_bounds, offset, 0.0)


def parabolic_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                          values=None, length=None):
    """Batched parabolic sub-sample peak interpolation:
    0.5*(c - a)/(2b - a - c), clipped to +-clip, 0 out of bounds
    (reference thrifty/experimental/xcorr_interpolators.py)."""
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1, values,
                                        length)
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    offset = torch.clamp(0.5 * (c - a) / guard_denominator(2.0 * b - a - c),
                         -clip, clip)
    return torch.where(in_bounds, offset, 0.0)


def cosine_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                       values=None, length=None):
    """Batched cosine-fit sub-sample peak interpolation.

    Fits y_k = A*cos(w*k + theta) through the three points around the
    peak: w = arccos((a+c)/2b), offset = -theta/w (reference
    thrifty/experimental/xcorr_interpolators.py cosine).  Returns 0
    where the fit is invalid (|a+c| >= 2b) or out of bounds.
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1, values,
                                        length)
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    b = torch.clamp(b, min=1e-30)
    cos_w = (a + c) / (2.0 * b)
    valid = torch.abs(cos_w) < 1.0
    w = torch.arccos(torch.clamp(cos_w, -0.999999, 0.999999))
    theta = torch.atan2(a - c, 2.0 * b * torch.sin(w))
    offset = torch.clamp(-theta / torch.where(w == 0, 1e-30, w), -clip, clip)
    return torch.where(valid & in_bounds, offset, 0.0)


def none_interpolate(corr_mag, peak_idx, clip: float = 0.6, values=None,
                     length=None):
    """Integer-only peaks: offset 0 (reference
    thrifty/experimental/xcorr_interpolators.py:31-32)."""
    del corr_mag, clip, values, length
    return torch.zeros(peak_idx.shape, dtype=torch.float32,
                       device=peak_idx.device)


# Kernel launches made by maximise_search and autocorr_fit (CUDA tensors
# only).
maximise_launches = 0
autocorr_launches = 0

INVPHI = float(np.float32((math.sqrt(5.0) - 1.0) / 2.0))


def maximise_reference(spec, peak_idx, clip: float = 0.55,
                       iters: int = 34):
    """The plain PyTorch golden-section search (the eager loop): maximise
    |corr(p + o)| over o in [-clip, clip] from the spectrum ``spec``
    [..., N] complex64 around ``peak_idx`` [...]; 2 + ``iters``
    [..., N] evaluations.  Returns the offset [...] float32."""
    two_pi_i = 2j * math.pi
    n = spec.shape[-1]
    dev = spec.device
    k = torch.arange(n, dtype=torch.int64, device=dev)
    p = torch.remainder(peak_idx.to(torch.int64)[..., None], n)
    kp = torch.remainder(k * p, n)
    base = spec * torch.exp(two_pi_i * (kp.to(torch.float32) / n))
    # Signed (fftfreq) frequencies for the fractional part, as the
    # reference (xcorr_interpolators.py:102).
    f_signed = torch.where(k < (n + 1) // 2, k, k - n).to(
        torch.float32) / n

    def value(o):
        ph = torch.exp(two_pi_i * (o[..., None] * f_signed))
        return torch.abs(torch.sum(base * ph, dim=-1))

    a = torch.full(peak_idx.shape, -clip, dtype=torch.float32, device=dev)
    b = torch.full(peak_idx.shape, clip, dtype=torch.float32, device=dev)
    c = b - INVPHI * (b - a)
    d = a + INVPHI * (b - a)
    fc, fd = value(c), value(d)
    for _ in range(iters):
        left = fc > fd  # keep [a, d]; else keep [c, b]
        a, b = torch.where(left, a, c), torch.where(left, d, b)
        c = b - INVPHI * (b - a)
        d = a + INVPHI * (b - a)
        # One evaluation per step: the surviving interior point's
        # value is reused, only its mirror is fresh.
        fnew = value(torch.where(left, c, d))
        fc, fd = torch.where(left, fnew, fd), torch.where(left, fc, fnew)
    return 0.5 * (a + b)


def maximise_search(spec, peak_idx, clip: float = 0.55, iters: int = 34):
    """The search of :func:`maximise_reference`: on CUDA tensors one
    launch of ``csrc/fits.cu``'s ``maximise_kernel`` (one CTA per row of
    ``spec`` complex64, ``peak_idx`` int32 or int64 of the same leading
    shape, else it raises), on CPU tensors the plain version; any other
    device raises."""
    if spec.device.type == "cpu":
        return maximise_reference(spec, peak_idx, clip, iters)
    if spec.device.type != "cuda":
        raise ValueError("maximise_search runs on 'cpu' or 'cuda' tensors, "
                         "not {!r}".format(spec.device.type))
    return _launch_maximise(spec, peak_idx, clip, iters)


def _launch_maximise(spec, peak_idx, clip, iters):
    global maximise_launches
    from thrifty_tpu_torch.dsp import fits_lib

    if spec.dtype != torch.complex64 or spec.dim() < 1 \
            or peak_idx.dtype not in (torch.int32, torch.int64) \
            or tuple(peak_idx.shape) != tuple(spec.shape[:-1]) \
            or peak_idx.device != spec.device:
        raise ValueError(
            "the maximise kernel takes complex64 spec [..., N] and int32 or "
            "int64 peak_idx [...] on its device, got {} {} and {} {}".format(
                spec.dtype, tuple(spec.shape), peak_idx.dtype,
                tuple(peak_idx.shape)))
    n = spec.shape[-1]
    rows = spec.reshape(-1, n).contiguous()
    idx = peak_idx.reshape(-1).contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=spec.device)
    lib = fits_lib.library()
    with fits_lib.on_device(spec.device) as stream:
        # A row that does not fit in shared memory takes a scratch row.
        scratch = None if lib.tt_maximise_smem(n) else torch.empty_like(rows)
        err = lib.tt_maximise(
            rows.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64,
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            rows.shape[0], n, clip, INVPHI, 2.0 * math.pi, iters, stream)
    fits_lib.check(err, "maximise")
    if rows.shape[0]:
        maximise_launches += 1
    return out.reshape(peak_idx.shape)


def make_maximise_interpolator(clip: float = 0.55, iters: int = 34):
    """Band-limited correlation-peak maximisation (JAX
    ``make_maximise_interpolator``, a re-design of the reference's
    experimental 'maximise', thrifty/experimental/
    xcorr_interpolators.py:94-111).

    corr(p + o) = (1/N) sum_k X_k e^{2 pi i k (p+o)/N} is evaluated from
    the correlation spectrum X and maximised over o in [-clip, clip]
    with ``iters`` golden-section steps, one [..., N] evaluation per
    step (:func:`maximise_search`: one kernel launch on the card).  The
    bracket is rounded to float32 at every step, as JAX does, or it
    converges elsewhere.  ``(k*p) mod N`` is exact in int64 for any N
    (JAX needs uint32 wraparound and a power-of-two N).

    Returns ``interp(spec [..., N] complex64, peak_idx [...]) -> offset``.
    """

    def interpolate(spec, peak_idx):
        return maximise_search(spec, peak_idx, clip, iters)

    return interpolate


def autocorr_tables(template, oversample: int = 16, width: int = 2):
    """The autocorr interpolator's shape tables, float32 numpy.

    |R(tau)|, the correlation of the template's OOK envelope with the
    bipolar template, oversampled ``oversample`` times by spectral
    zero-padding, for tau in [-width-2, width+2], normalised to peak 1;
    and its derivative by central differences.  Returns (table,
    dtable): [M] for one template, [T, M] for a [T, L] bank (JAX
    ``make_autocorr_interpolator``'s tables, bit for bit).
    """
    template = np.asarray(template, dtype=np.float64)
    rows = np.atleast_2d(template)

    def shape_tables(tmpl):
        ook = tmpl - np.min(tmpl)
        tlen = len(ook)
        pad_ook = np.zeros(2 * tlen)
        pad_ook[:tlen] = ook
        pad_bip = np.zeros(2 * tlen)
        pad_bip[:tlen] = tmpl
        spec = np.fft.fft(pad_ook) * np.conj(np.fft.fft(pad_bip))
        fine_spec = np.zeros(2 * tlen * oversample, dtype=complex)
        fine_spec[:tlen] = spec[:tlen]
        fine_spec[-tlen:] = spec[-tlen:]
        fine = np.abs(np.fft.ifft(fine_spec)) * oversample
        span = (width + 2) * oversample
        taus = np.concatenate([fine[-span:], fine[:span + 1]])
        taus = taus / np.max(taus)
        return taus, np.gradient(taus, 1.0 / oversample)

    pairs = [shape_tables(r) for r in rows]
    table = np.stack([p[0] for p in pairs]).astype(np.float32)
    dtable = np.stack([p[1] for p in pairs]).astype(np.float32)
    if template.ndim == 1:
        return table[0], dtable[0]
    return table, dtable


def autocorr_fit_reference(y, table, dtable, oversample: int = 16,
                           iters: int = 10, clip: float = 0.6):
    """The plain PyTorch autocorr fit (the eager loop): ``iters``
    Gauss-Newton steps for amplitude and shift of the shape tables
    ``table``/``dtable`` ([M], or [T, M] with ``y`` [..., T, K]: row t
    serves template t) on ``y`` [..., K] float32 (K = 2*width+1), the
    shift clamped to +-``clip``.  Returns the offset [...]."""
    width = y.shape[-1] // 2
    num_entries = table.shape[-1]
    ks = torch.arange(-width, width + 1, dtype=torch.float32,
                      device=y.device)
    t_idx = (torch.arange(table.shape[0], device=table.device)[:, None]
             if table.dim() == 2 else None)

    def lookup(tbl, u):
        # Linear interpolation between the fine-grid entries around u
        # (samples relative to the peak).
        pos = torch.clamp((u + (width + 2)) * oversample, 0.0,
                          num_entries - 1.001)
        i0 = torch.floor(pos).to(torch.int64)
        frac = pos - i0
        if t_idx is None:
            v0, v1 = tbl[i0], tbl[i0 + 1]
        else:
            v0, v1 = tbl[t_idx, i0], tbl[t_idx, i0 + 1]
        return v0 * (1 - frac) + v1 * frac

    amp = y[..., width]
    delta = torch.zeros_like(amp)
    for _ in range(iters):
        u = ks - delta[..., None]
        r = lookup(table, u)
        j_d = -amp[..., None] * lookup(dtable, u)
        resid = y - amp[..., None] * r
        a11 = torch.sum(r * r, dim=-1) * 1.0001
        a22 = torch.sum(j_d * j_d, dim=-1) * 1.0001 + 1e-12
        a12 = torch.sum(r * j_d, dim=-1)
        b1 = torch.sum(r * resid, dim=-1)
        b2 = torch.sum(j_d * resid, dim=-1)
        det = a11 * a22 - a12 * a12
        det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
        amp = amp + (a22 * b1 - a12 * b2) / det
        delta = torch.clamp(delta + (a11 * b2 - a12 * b1) / det,
                            -1.0, 1.0)
    return torch.clamp(delta, -clip, clip)


def autocorr_fit(y, table, dtable, oversample: int = 16, iters: int = 10,
                 clip: float = 0.6):
    """The fit of :func:`autocorr_fit_reference`: on CUDA tensors one
    launch of ``csrc/fits.cu``'s ``autocorr_fit_kernel`` (float32 ``y``
    [..., K] with K odd, float32 tables on its device, else it raises),
    on CPU tensors the plain version; any other device raises."""
    if y.device.type == "cpu":
        return autocorr_fit_reference(y, table, dtable, oversample, iters,
                                      clip)
    if y.device.type != "cuda":
        raise ValueError("autocorr_fit runs on 'cpu' or 'cuda' tensors, "
                         "not {!r}".format(y.device.type))
    return _launch_autocorr(y, table, dtable, oversample, iters, clip)


def _launch_autocorr(y, table, dtable, oversample, iters, clip):
    global autocorr_launches
    from thrifty_tpu_torch.dsp import fits_lib

    k = y.shape[-1] if y.dim() else 0
    t_rows = table.shape[0] if table.dim() == 2 else 1
    if y.dtype != torch.float32 or k % 2 == 0 \
            or table.dtype != torch.float32 or table.dim() not in (1, 2) \
            or dtable.shape != table.shape or dtable.dtype != torch.float32 \
            or table.device != y.device or dtable.device != y.device \
            or (table.dim() == 2 and (y.dim() < 2 or y.shape[-2] != t_rows)):
        raise ValueError(
            "the autocorr fit kernel takes float32 y [..., K] (K odd; [..., "
            "T, K] for [T, M] tables) and float32 tables on its device, got "
            "{} {} and {} {}".format(y.dtype, tuple(y.shape), table.dtype,
                                     tuple(table.shape)))
    rows = y.reshape(-1, k).contiguous()
    tbl, dtbl = table.contiguous(), dtable.contiguous()
    m = table.shape[-1]
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=y.device)
    with fits_lib.on_device(y.device) as stream:
        err = fits_lib.library().tt_autocorr_fit(
            rows.data_ptr(), tbl.data_ptr(), dtbl.data_ptr(), out.data_ptr(),
            rows.shape[0], k // 2, t_rows, m, oversample, m - 1.001, iters,
            clip, stream)
    fits_lib.check(err, "autocorr_fit")
    if rows.shape[0]:
        autocorr_launches += 1
    return out.reshape(y.shape[:-1])


def make_autocorr_interpolator(table, dtable, oversample: int = 16,
                               width: int = 2, iters: int = 10,
                               clip: float = 0.6):
    """Sub-sample interpolation by fitting the template's own
    autocorrelation shape (tables of :func:`autocorr_tables`, tensors on
    the detector's device) to the ``2*width+1``-point peak
    neighbourhood: ``iters`` Gauss-Newton steps for amplitude and shift
    (:func:`autocorr_fit`: one kernel launch on the card; JAX runs them
    in ``lax.scan``).  With [T, M] tables, ``values`` is [..., T,
    2*width+1] and row t of the table serves template t.

    Returns ``interp(corr_mag, peak_idx, clip=, values=, length=)``
    with the ``width`` attribute (the neighbourhood half-width).
    """

    def interpolate(corr_mag, peak_idx, clip=clip, values=None,
                    length=None):
        y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, width,
                                            values, length)
        offset = autocorr_fit(y.to(torch.float32), table, dtable,
                              oversample, iters, clip)
        return torch.where(in_bounds, offset, 0.0)

    interpolate.width = width
    return interpolate
