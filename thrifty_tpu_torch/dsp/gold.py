"""Gold code / m-sequence generation.

Generates the same code families as the reference (thrifty/gold.py:15-82):
Gold codes of length 2^n - 1 built from preferred pairs of m-sequences.
The preferred-pair feedback taps are standard published constants.
"""

from __future__ import annotations

import numpy as np

# Preferred pairs of LFSR feedback taps per register length (standard
# published preferred pairs; cf. reference thrifty/gold.py:15-23).
PREFERRED_TAPS = {
    5: ([2], [1, 2, 3]),
    6: ([5], [1, 4, 5]),
    7: ([4], [4, 5, 6]),
    8: ([1, 2, 3, 6, 7], [1, 2, 7]),
    9: ([5], [3, 5, 6]),
    10: ([2, 5, 9], [3, 4, 6, 8, 9]),
    11: ([9], [3, 6, 9]),
}


def lfsr(taps, nbits: int) -> np.ndarray:
    """Output sequence of a Fibonacci LFSR seeded with all-ones.

    The sequence obeys the recurrence
    ``y[i] = y[i-n] XOR (XOR_t y[i-n+t])`` for ``i >= n`` with
    ``y[0:n] = 1``, yielding a maximal-length sequence of 2^n - 1 bits.
    """
    n = int(nbits)
    length = (1 << n) - 1
    seq = np.zeros(length, dtype=bool)
    seq[:n] = True
    for i in range(n, length):
        bit = seq[i - n]
        for tap in taps:
            bit ^= seq[i - n + tap]
        seq[i] = bit
    return seq


def num_codes(bits: int) -> int:
    """Number of Gold codes in the family: 2^n + 1."""
    return (1 << int(bits)) + 1


def gold(bits: int, index: int = 0) -> np.ndarray:
    """Generate the index-th Gold code of length 2^bits - 1.

    index 0 and 1 select the two m-sequences of the preferred pair;
    index k >= 2 xors the first sequence with a cyclic shift of the second.
    """
    bits = int(bits)
    if bits not in PREFERRED_TAPS:
        raise ValueError(
            "no preferred pair known for {} bits "
            "(supported: {})".format(bits, sorted(PREFERRED_TAPS))
        )
    if not 0 <= index < num_codes(bits):
        raise ValueError("code index out of range: {}".format(index))
    taps_a, taps_b = PREFERRED_TAPS[bits]
    seq_a = lfsr(taps_a, bits)
    seq_b = lfsr(taps_b, bits)
    if index == 0:
        return seq_a
    if index == 1:
        return seq_b
    return np.logical_xor(seq_a, np.roll(seq_b, -(index - 2)))


def bipolar(code: np.ndarray) -> np.ndarray:
    """Map a boolean code to +-1.0 samples."""
    return np.where(code, 1.0, -1.0)


def autocorr_stats(code: np.ndarray) -> dict:
    """Cyclic-autocorrelation quality stats of a code (peak, max sidelobe)."""
    bp = bipolar(code)
    # Cyclic autocorrelation via FFT (exact for +-1 integer-valued codes).
    spec = np.fft.fft(bp)
    acorr = np.real(np.fft.ifft(spec * np.conj(spec)))
    acorr = np.round(acorr)
    peak = acorr[0]
    sidelobes = np.abs(acorr[1:])
    noise_rms = np.sqrt(np.mean(sidelobes**2))
    return {
        "peak": float(peak),
        "max_sidelobe": float(np.max(sidelobes)) if len(sidelobes) else 0.0,
        # Same empty/zero guard as max_sidelobe: a length-1 or
        # zero-sidelobe code reports inf cleanly, not a crash/warning.
        "peak_to_max": float(peak / np.max(sidelobes))
        if len(sidelobes) and np.max(sidelobes) > 0 else float("inf"),
        "peak_to_noise": float(peak / noise_rms)
        if noise_rms > 0 else float("inf"),
    }
