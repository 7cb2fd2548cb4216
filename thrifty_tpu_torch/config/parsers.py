"""String -> value parsers for settings shared by all CLIs.

Implements the same mini-languages as the reference
(thrifty/setting_parsers.py:43-185): SI-suffixed floats, frequency ranges
with a Hz/bin duality, and the ``A + B*snr + C*stddev`` threshold formula.
"""

from __future__ import annotations

import re

_SI = {
    "y": 1e-24, "z": 1e-21, "a": 1e-18, "f": 1e-15, "p": 1e-12, "n": 1e-9,
    "u": 1e-6, "m": 1e-3, "c": 1e-2, "d": 1e-1,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Z": 1e21, "Y": 1e24,
}

_FLOAT = r"[-+]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][-+]?\d+)?"

_FREQ_RANGE_RE = re.compile(
    r"^({f})(?:\s*-\s*({f}))?\s*([kKmM]?)([hH][zZ])?$".format(f=_FLOAT),
    re.IGNORECASE,
)

_THRESH_TERM_RE = re.compile(
    r"^\s*(?=\S)(?:({f})\s*\*?\s*)?(constant|c|snr|s|stddev|d|)\s*$".format(
        f=_FLOAT
    )
)


def metric_float(string: str) -> float:
    """Parse a float with an optional SI metric prefix suffix.

    >>> metric_float('2.4M')
    2400000.0
    """
    string = string.strip()
    if string and string[-1] in _SI:
        return float(string[:-1]) * _SI[string[-1]]
    return float(string)


def freq_range(string: str) -> tuple[float, float, bool]:
    """Parse a carrier frequency range string.

    Returns ``(start, stop, unit_is_hz)``.  A trailing ``hz`` marks the
    range as being in Hertz; otherwise the values are FFT bin indices.
    A single value means start == stop.

    >>> freq_range('7 - 110')
    (7.0, 110.0, False)
    >>> freq_range('2 - 3 MHz')
    (2000000.0, 3000000.0, True)
    """
    match = _FREQ_RANGE_RE.match(string.strip())
    if not match:
        raise ValueError("invalid frequency range: {!r}".format(string))
    start_s, stop_s, prefix, unit = match.groups()
    if stop_s is None:
        stop_s = start_s
    start, stop = float(start_s), float(stop_s)
    scale = {"k": 1e3, "m": 1e6}.get(prefix.lower(), 1.0) if prefix else 1.0
    return start * scale, stop * scale, unit is not None


def normalize_freq_range(
    range_: tuple[float, float, bool], bin_freq: float
) -> tuple[int, int]:
    """Convert a freq_range() result to integer FFT bin indices."""
    start, stop, is_hz = range_
    if is_hz:
        start, stop = start / bin_freq, stop / bin_freq
    return int(start), int(stop)


def threshold(string: str) -> tuple[float, float, float]:
    """Parse a detector threshold formula.

    The threshold mini-DSL supports a sum of terms, each an optional
    coefficient times one of ``constant``/``c``, ``snr``/``s``,
    ``stddev``/``d`` (empty symbol means constant).

    >>> threshold('15*snr')
    (0.0, 15.0, 0.0)
    >>> threshold('10c+5s+2d')
    (10.0, 5.0, 2.0)
    """
    if not string:
        raise ValueError("empty threshold formula")
    out = {"c": 0.0, "s": 0.0, "d": 0.0}
    for term in string.split("+"):
        match = _THRESH_TERM_RE.match(term)
        if not match:
            raise ValueError("invalid threshold term: {!r}".format(term))
        qty_s, symbol = match.groups()
        qty = 1.0 if qty_s is None else float(qty_s)
        key = {
            "constant": "c", "c": "c", "": "c",
            "snr": "s", "s": "s",
            "stddev": "d", "d": "d",
        }[symbol]
        out[key] += qty
    return out["c"], out["s"], out["d"]
