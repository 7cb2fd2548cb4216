"""Batched transforms: ``torch.fft`` (cuFFT on the card) or the DFT as
matrix products (counterpart of thrifty_tpu.dsp.mxu_fft).

The JAX package writes the FFT as matrix products to put it on the TPU's
matrix unit.  This module keeps that family under the same names,
choices and errors, with the products as real float32 GEMMs
(``torch.matmul``, cuBLAS on the card):

- n <= ``_DFT_MAX``: one dense DFT matrix product, out = x @ F with
  F[j, k] = W_n^{jk}.
- larger n with n = 128 * n2, 128 <= n2 <= ``_DFT_MAX`` (Bailey's four
  step): view x as [n1, n2], transform the columns with F_{n1}, apply the
  twiddles W_n^{k1 n2}, transform the rows with F_{n2} and read the
  result transposed.
- any other n: ``torch.fft`` (no supported factorization).

``impl``:
  'auto'    -- ``torch.fft`` on every device, the card included.  JAX
               resolves it to the matmul path on any accelerator, where
               it pays on a TPU.  On an H100 (700 W) at [256, 16384],
               L2 cold, cuFFT takes 0.041 ms against the four-step's
               0.350 ms in float32 and 0.218 ms in TF32 (its two
               complex GEMM stages need 8.6 GFLOP, at least 0.128 ms in
               float32), and the windowed carrier DFT 0.103 ms against
               cuFFT's 0.048 (PERF.md section 6), so the port's default
               path stays on cuFFT;
  'matmul'  -- the matmul path (``torch.fft`` only for an n with no
               supported factorization);
  'matmul3' -- the matmul path with every complex product by Karatsuba's
               three real products (:func:`_right`, :func:`_left`);
  'xla'     -- ``torch.fft``; the name is the JAX package's, kept so the
               CLIs and scripts take the same values.

``precision`` of the matrix products on a CUDA card:
  'highest' -- float32 operands and accumulation, TF32 off (the global
               state ``device.resolve_device`` sets); the default;
  'high'    -- TF32 tensor cores (JAX's own GPU meaning of
               ``Precision.HIGH``), switched on for the call's products
               only and restored after each;
  'default' -- bf16 operands, float32 accumulation and output.
On the CPU every precision computes in float32, as JAX's CPU backend
does.

Complex products are carried as real GEMMs (interleaved re/im read in
place through ``view_as_real``): torch has no complex bf16, and its TF32
switch is not documented to reach complex GEMMs.

Two trimmed variants compute only what the detector consumes, exactly
(the same dot products as the full transform, minus unused outputs):
:func:`ifft_head` (the first ``m`` outputs) and :func:`windowed_dft`
(an arbitrary set of output bins).  The constants are the JAX package's
numpy complex64 arrays, bit for bit; each is moved to a device once, in
the form a product needs, and kept per (device, key).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# Largest n handled by a single dense DFT matrix (32 MB complex64 at
# 2048).
_DFT_MAX = 2048

PRECISIONS = ("default", "high", "highest")
IMPLS = ("auto", "matmul", "matmul3", "xla")

# 2*pi rounded to float32, as JAX rounds the weak-typed constant.
_TWO_PI = float(np.float32(2.0 * np.pi))


def _resolve_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(
            "unknown fft precision {!r}: expected one of {}".format(
                precision, sorted(PRECISIONS)))
    return precision


def _use_matmul(impl):
    if impl not in IMPLS:
        raise ValueError("unknown fft impl {!r}: expected 'auto', "
                         "'matmul', 'matmul3' or 'xla'".format(impl))
    return impl in ("matmul", "matmul3")


@functools.lru_cache(maxsize=32)
def _dft_matrix(n, inverse):
    sgn = 2j if inverse else -2j
    k = np.arange(n)
    return np.exp(sgn * np.pi * np.outer(k, k) / n).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _four_step_consts(n1, n2, inverse):
    n = n1 * n2
    sgn = 2j if inverse else -2j
    f1 = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n1))
                / n1).astype(np.complex64)
    f2 = np.exp(sgn * np.pi * np.outer(np.arange(n2), np.arange(n2))
                / n2).astype(np.complex64)
    tw = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n2))
                / n).astype(np.complex64)
    return f1, f2, tw


def _split(n):
    """(n1, n2) four-step factorization, or None: n1 = 128, n2 the rest
    (itself one dense [n2, n2] product, so capped like the dense path)."""
    if n % 128 == 0 and 128 <= n // 128 <= _DFT_MAX:
        return 128, n // 128
    return None


# Dense windowed-DFT heuristic: X[sel] as ONE [n, W] product whenever the
# constant stays below this element count; the factorized form (the
# four-step's column transform plus a W-bin combine) otherwise.
# Module-level so a test or an A/B run can pin either form.
WINDOWED_DENSE_MAX_ELEMS = 8 * 1024 * 1024


@functools.lru_cache(maxsize=32)
def _windowed_consts(n, sel, inverse, dense):
    """Constants for :func:`windowed_dft` at output bins ``sel``:
    (cols [n, W], None, None) for the dense product, (f1 [n1, n1],
    k1_idx [W], comb [W, n2]) for the factorized one (with t = j1*n2 +
    j2, X[k] = sum_j2 W_n^{j2 k} * b1[k mod n1, j2], b1 the four-step's
    column transform), or (None, None, None) without a factorization."""
    sgn = 2j if inverse else -2j
    sel_arr = np.asarray(sel, dtype=np.int64)
    if n <= _DFT_MAX or dense:
        k = np.arange(n)
        cols = np.exp(sgn * np.pi * np.outer(k, sel_arr) / n)
        return cols.astype(np.complex64), None, None
    split = _split(n)
    if split is None:
        return None, None, None
    n1, n2 = split
    f1 = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n1))
                / n1).astype(np.complex64)
    k1_idx = (sel_arr % n1).astype(np.int32)
    comb = np.exp(sgn * np.pi * np.outer(sel_arr, np.arange(n2))
                  / n).astype(np.complex64)  # [W, n2]
    return f1, k1_idx, comb


def _numpy_const(key):
    """The numpy constant named by ``key`` (a hashable tuple)."""
    kind = key[0]
    if kind == "dft":      # ("dft", n, inverse, m): first m columns
        _, n, inverse, m = key
        return _dft_matrix(n, inverse)[:, :m]
    if kind == "four":     # ("four", n1, n2, inverse, which, cols)
        _, n1, n2, inverse, which, cols = key
        return _four_step_consts(n1, n2, inverse)[which][:, :cols]
    # ("win", n, sel, dense, which)
    _, n, sel, dense, which = key
    return _windowed_consts(n, sel, False, dense)[which]


def _real_forms(c, form):
    """float32 numpy arrays of complex ``c`` [K, N] for one product form:

    'right'  [2K, 2N]: x @ c as a real GEMM on x's interleaved (re, im)
             pairs, with interleaved output;
    'left'   [2K, N]: [re(c); im(c)], c @ u for interleaved u as
             P = re(c) @ u, Q = im(c) @ u, out = P + iQ;
    'kara'   re(c), im(c), re(c) + im(c) (Karatsuba's three factors);
    'comb'   [K, 2N, 2]: row k of c as a [2N, 2] real matrix, for a
             per-row contraction of interleaved data.
    """
    cr = c.real.astype(np.float32)
    ci = c.imag.astype(np.float32)
    if form == "right":
        big = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.float32)
        big[0::2, 0::2], big[0::2, 1::2] = cr, ci
        big[1::2, 0::2], big[1::2, 1::2] = -ci, cr
        return (big,)
    if form == "left":
        return (np.concatenate([cr, ci], axis=0),)
    if form == "kara":
        return cr, ci, (c.real + c.imag).astype(np.float32)
    comb = np.empty((c.shape[0], 2 * c.shape[1], 2), np.float32)
    comb[:, 0::2, 0], comb[:, 0::2, 1] = cr, ci
    comb[:, 1::2, 0], comb[:, 1::2, 1] = -ci, cr
    return (comb,)


# The device constants are kept for the life of the process (no
# eviction): a captured CUDA graph (dsp/detector.py) reads them by
# address on every replay.  There is one entry per transform shape and
# form a process uses.
@functools.cache
def _const(key, device, form, dtype=torch.float32):
    """The constant ``key`` on ``device`` in ``form`` ('complex', 'index'
    or a :func:`_real_forms` form), moved there once."""
    c = _numpy_const(key)
    if form == "complex":
        return torch.tensor(c, device=device)
    if form == "index":
        return torch.tensor(np.asarray(c, np.int64), device=device)
    return tuple(torch.tensor(np.ascontiguousarray(a), device=device,
                              dtype=dtype) for a in _real_forms(c, form))


def _dtype(device, prec):
    return torch.bfloat16 if device.type == "cuda" and prec == "default" \
        else torch.float32


@contextlib.contextmanager
def _tf32(enabled):
    """TF32 for float32 matrix products on the card while the block runs;
    the previous setting afterwards.  The same switch as
    ``device.resolve_device`` (torch >= 2.9 may refuse a mix of the
    legacy and the newer ``fp32_precision`` switches)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _gemm(a, b, prec):
    """``a @ b`` (2-D or batched 3-D, one operand may be 2-D and
    broadcast) with float32 output, at ``prec`` on a CUDA card."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    if prec == "default":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if a.dim() == 2 and b.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        batch = a.shape[0] if a.dim() == 3 else b.shape[0]
        a = a if a.dim() == 3 else a.expand(batch, -1, -1)
        b = b if b.dim() == 3 else b.expand(batch, -1, -1)
        return torch.bmm(a, b, out_dtype=torch.float32)
    with _tf32(prec == "high"):
        return torch.matmul(a, b)


def _karatsuba(t1, t2, t3):
    return torch.complex(t1 - t2, t3 - t1 - t2)


def _right(x, key, kara, prec):
    """``x @ c`` for complex x [..., K] and the constant c [K, N] named
    by ``key``: one real GEMM [M, 2K] @ [2K, 2N] on x's interleaved
    pairs, or Karatsuba's three [M, K] @ [K, N]
    (t1 = xr@cr, t2 = xi@ci, t3 = (xr+xi)@(cr+ci), out = (t1-t2) +
    i(t3-t1-t2))."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    dt = _dtype(x.device, prec)
    if kara:
        cr, ci, cs = _const(key, x.device, "kara", dt)
        xr, xi = x2.real, x2.imag
        out = _karatsuba(_gemm(xr, cr, prec), _gemm(xi, ci, prec),
                         _gemm(xr + xi, cs, prec))
        return out.reshape(lead + (out.shape[-1],))
    big, = _const(key, x.device, "right", dt)
    pairs = torch.view_as_real(x2.contiguous()).reshape(-1, 2 * k)
    out = _gemm(pairs, big, prec)
    return torch.view_as_complex(out.reshape(-1, out.shape[-1] // 2, 2)) \
        .reshape(lead + (out.shape[-1] // 2,))


def _left(c_key, u, kara, prec):
    """``c @ u[b]`` for the constant c [n1, n1] named by ``c_key`` and
    complex u [B, n1, n2] (the four-step's column transform): one real
    GEMM [2n1, n1] @ [n1, 2n2] per batch row giving P = re(c) @ u and
    Q = im(c) @ u, out = P + iQ; or Karatsuba's three."""
    b, n1, n2 = u.shape
    dt = _dtype(u.device, prec)
    if kara:
        cr, ci, cs = _const(c_key, u.device, "kara", dt)
        ur, ui = u.real, u.imag
        return _karatsuba(_gemm(cr, ur, prec), _gemm(ci, ui, prec),
                          _gemm(cs, ur + ui, prec))
    g, = _const(c_key, u.device, "left", dt)
    pq = _gemm(g, torch.view_as_real(u.contiguous()).reshape(b, n1, 2 * n2),
               prec)
    p = torch.view_as_complex(pq[:, :n1].reshape(b, n1, n2, 2))
    q = torch.view_as_complex(pq[:, n1:].reshape(b, n1, n2, 2))
    return p + q * 1j


def _four_step(a, inverse, prec, kara, m):
    """Four-step transform of ``a`` [..., n1, n2] (time index t = j1*n2 +
    j2); returns the first ``m`` output bins [..., m]."""
    n1, n2 = a.shape[-2], a.shape[-1]
    n = n1 * n2
    # Output index j = k2*n1 + k1: keeping j < m needs row-transform
    # columns k2 < ceil(m/n1) only.
    k2_max = -(-m // n1)
    lead = a.shape[:-2]
    a = a.reshape((-1, n1, n2))
    b = _left(("four", n1, n2, inverse, 0, n1), a, kara, prec)
    tw = _const(("four", n1, n2, inverse, 2, n2), a.device, "complex")
    d = _right(b * tw, ("four", n1, n2, inverse, 1, k2_max), kara, prec)
    out = d.transpose(1, 2).reshape(lead + (k2_max * n1,))[..., :m]
    return out / n if inverse else out


def _transform(x, inverse, impl, precision="highest", head=None):
    """Full transform, or (``head=m``) only its first ``m`` outputs: the
    same dot products the full transform computes (a column slice of the
    DFT matrix, or of the four-step's row transform), so
    ``_transform(x, head=m)`` equals ``_transform(x)[..., :m]``."""
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    m = n if head is None else min(int(head), n)
    if _use_matmul(impl):
        if n <= _DFT_MAX:
            out = _right(x, ("dft", n, inverse, m), kara, prec)
            return out / n if inverse else out
        split = _split(n)
        if split is not None:
            n1, n2 = split
            return _four_step(x.reshape(x.shape[:-1] + (n1, n2)),
                              inverse, prec, kara, m)
        # No supported factorization: a dense [n, n] constant beyond
        # _DFT_MAX -- fall back.
    full = torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)
    return full if head is None else full[..., :m]


def fft_ramped(x, shift, impl="auto", precision="highest", separable=True):
    """FFT of ``x * exp(2j*pi*shift*(t/n - 0.5))``: the reference's
    fractional carrier shift (thrifty/carrier_sync.py:60-75), the one home
    of the ramp formula.

    ``x``: complex64 [..., n]; ``shift``: float32 [...] in bins.  On the
    four-step path (matmul impl, ``separable=True``) the ramp factors over
    t = j1*n2 + j2 as shift*j1/n1 + shift*(j2/n - 0.5): two factors of
    [..., n1] and [..., n2] (n1 + n2 exponentials instead of n).  The
    integer part of the shift wraps exactly as (si*j1) mod n1 and the
    -shift/2 constant folds into r2 as (-1)^si * exp(-i*pi*sf), so every
    evaluated phase stays within 2*pi; the form is 2e-6 from the float64
    oracle, closer than the full ramp's large unwrapped phases.  Eager
    torch materializes the [..., n1, n2] ramped product that XLA fuses
    into the column transform.  Elsewhere the full ramp, term for term
    JAX's: ``pos = arange(n)/n - 0.5`` in float32 and phase
    ``(2*pi * shift) * pos``.
    """
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    split = _split(n)
    dev = x.device
    if separable and _use_matmul(impl) and split is not None:
        n1, n2 = split
        si = torch.round(shift)
        sf = shift - si
        sii = si.to(torch.int32)
        j1i = torch.arange(n1, dtype=torch.int32, device=dev)
        ph1 = _TWO_PI * (
            torch.remainder(sii[..., None] * j1i, n1).to(torch.float32) / n1
            + sf[..., None] * (torch.arange(n1, dtype=torch.float32,
                                            device=dev) / n1))
        ph2 = _TWO_PI * shift[..., None] * (
            torch.arange(n2, dtype=torch.float32, device=dev) / n) \
            - float(np.float32(np.pi)) * sf[..., None]
        sign = (1 - 2 * torch.remainder(sii, 2)).to(torch.float32)
        r1 = torch.complex(torch.cos(ph1), torch.sin(ph1))
        r2 = torch.complex(torch.cos(ph2) * sign[..., None],
                           torch.sin(ph2) * sign[..., None])
        a = x.reshape(x.shape[:-1] + (n1, n2)) \
            * r1[..., :, None] * r2[..., None, :]
        return _four_step(a, False, prec, kara, n)
    pos = torch.arange(n, dtype=torch.float32, device=dev) / n - 0.5
    phase = (shift[..., None] * _TWO_PI) * pos
    ramp = torch.complex(torch.cos(phase), torch.sin(phase))
    return _transform(x * ramp, False, impl, precision)


def windowed_dft(x, sel, impl="auto", precision="highest"):
    """DFT of ``x`` [..., n] at output bins ``sel`` only: [..., len(sel)],
    ``fft(x)[..., sel]`` up to the products' rounding.

    ``sel``: a 1-D int array (or tuple) of bin indices in any order, e.g.
    a wrapped carrier window.  Under 'auto'/'xla' (or an unfactorable n)
    this IS a take of the full ``torch.fft``.  On the matmul path: one
    [n, W] product while n*W <= ``WINDOWED_DENSE_MAX_ELEMS``, else the
    four-step's column transform plus a W-bin combine; no [..., n]
    spectrum is made either way.
    """
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    sel_t = tuple(int(s) for s in np.asarray(sel).ravel())
    if any(s < 0 or s >= n for s in sel_t):
        raise ValueError("windowed_dft bins out of range for n=%d" % n)
    if _use_matmul(impl):
        dense = n * len(sel_t) <= WINDOWED_DENSE_MAX_ELEMS
        cols, k1_idx, _ = _windowed_consts(n, sel_t, False, dense)
        if cols is not None and k1_idx is None:
            return _right(x, ("win", n, sel_t, dense, 0), kara, prec)
        if cols is not None:
            n1 = cols.shape[0]
            n2 = n // n1
            lead = x.shape[:-1]
            b1 = _left(("win", n, sel_t, dense, 0),
                       x.reshape((-1, n1, n2)), kara, prec)
            rows = b1.index_select(1, _const(("win", n, sel_t, dense, 1),
                                             x.device, "index"))  # [B,W,n2]
            out = _combine(rows, ("win", n, sel_t, dense, 2), kara, prec)
            return out.reshape(lead + (len(sel_t),))
    return torch.fft.fft(x, dim=-1).index_select(-1, _bins(sel_t, x.device))


@functools.cache  # kept, as _const's entries are
def _bins(sel, device):
    """int64 bin indices ``sel`` on ``device``, moved there once."""
    return torch.tensor(sel, dtype=torch.int64, device=device)


def _combine(rows, key, kara, prec):
    """out[b, w] = sum_j rows[b, w, j] * comb[w, j] for complex rows
    [B, W, n2] and the constant comb [W, n2]: a batched real GEMM over w
    ([W, B, 2n2] @ [W, 2n2, 2]), or Karatsuba's three ([W, B, n2] @
    [W, n2, 1])."""
    dt = _dtype(rows.device, prec)
    by_w = rows.transpose(0, 1)  # [W, B, n2]
    if kara:
        cr, ci, cs = _const(key, rows.device, "kara", dt)
        rr, ri = by_w.real, by_w.imag
        out = _karatsuba(_gemm(rr, cr[..., None], prec),
                         _gemm(ri, ci[..., None], prec),
                         _gemm(rr + ri, cs[..., None], prec))[..., 0]
        return out.transpose(0, 1)
    comb, = _const(key, rows.device, "comb", dt)
    w, b, n2 = by_w.shape
    pairs = torch.view_as_real(by_w.contiguous()).reshape(w, b, 2 * n2)
    out = _gemm(pairs, comb, prec)  # [W, B, 2]
    return torch.view_as_complex(out.transpose(0, 1).contiguous())


def fft(x, impl="auto", precision="highest"):
    """Batched FFT along the last axis (see the module docstring)."""
    return _transform(x, False, impl, precision)


def ifft(x, impl="auto", precision="highest"):
    """Batched inverse FFT along the last axis (1/n normalised)."""
    return _transform(x, True, impl, precision)


def ifft_head(x, m, impl="auto", precision="highest"):
    """First ``m`` outputs of the inverse FFT: exactly
    ``ifft(x, impl)[..., :m]``, without the dot products of the discarded
    tail on the matmul path."""
    return _transform(x, True, impl, precision, head=m)
