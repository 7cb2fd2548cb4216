"""The one traffic generator: a receiver's raw uint8 I/Q stream from a
traffic file's parameters and ``--seed``.

A traffic file (``benchmark/traffic/<name>.json``) states the
transmitters (carrier bin, amplitude), how many bursts each sends per
base stream, the noise, the base stream's length in blocks, and how the
stream reaches the program (``input``: ``pipe`` or ``card``).  The seed
draws only where bursts fall, their carrier phases and bin jitter, and
the noise: every seed gets the same number of bursts per transmitter at
the same amplitudes, so the work does not change with the seed.

The signal arithmetic is a copy of the port's ``sim.synth_stream`` (an
OOK-modulated Gold code on a carrier, a band-limited fractional delay,
complex Gaussian noise) and of ``dsp.iq.iq_to_raw`` (8-bit quantization
as an RTL-SDR delivers it), kept here so that the program cannot change
its own input.
"""

from __future__ import annotations

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BURST_PAD = 128  # guard samples absorbing the fractional delay's ringing
DC_OFFSET = 127.4


def load(name):
    """The traffic file named ``name``."""
    with open(os.path.join(ROOT, "traffic", name + ".json")) as f:
        return json.load(f)


def rng_for(seed, stream):
    """A NumPy generator for one use of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def burst_samples(ook, bin_f, phase, frac, block_len):
    """One burst delayed by ``frac`` in [0, 1) samples; (samples, lead)."""
    tlen = len(ook)
    nb = tlen + 2 * BURST_PAD
    buf = np.zeros(nb, dtype=np.complex128)
    n = np.arange(tlen)
    buf[BURST_PAD:BURST_PAD + tlen] = ook * np.exp(
        2j * np.pi * bin_f * n / block_len + 1j * phase)
    if frac:
        k = np.fft.fftfreq(nb) * nb
        buf = np.fft.ifft(np.fft.fft(buf)
                          * np.exp(-2j * np.pi * k * frac / nb))
    return buf, BURST_PAD


def iq_to_raw(samples):
    """complex [N] -> uint8 interleaved I/Q [2N], clipped and truncated
    like upstream's complex_to_raw (thrifty/block_data.py:55-67)."""
    iq = np.asarray(samples, dtype=np.complex64)
    pairs = np.stack([iq.real, iq.imag], axis=-1).reshape(-1)
    return np.clip(pairs * 128.0 + DC_OFFSET, 0.0, 255.0).astype(np.uint8)


def bursts(traffic, config, template_len, seed):
    """The base stream's bursts: dicts of position (float samples),
    carrier_bin, amplitude and phase, in position order."""
    rng = rng_for(seed, 1)
    block_len = config["block_size"]
    length = traffic["base_blocks"] * (block_len - config["block_history"])
    per_tx = traffic["bursts_per_tx"]
    period = length / per_tx
    span = template_len + 2 * BURST_PAD + 1
    if period <= span:
        raise ValueError("bursts of one transmitter overlap")
    out = []
    for tx in traffic["transmitters"]:
        first = BURST_PAD + rng.uniform(0.0, period - span)
        jitter = traffic.get("bin_jitter", 0.0)
        for k in range(per_tx):
            out.append({
                "position": first + k * period,
                "carrier_bin": tx["carrier_bin"]
                + rng.uniform(-jitter, jitter),
                "amplitude": tx["amplitude"],
                "phase": rng.uniform(0.0, 2 * np.pi),
            })
    return sorted(out, key=lambda b: b["position"])


def base_stream(traffic, config, template, seed):
    """(uint8 base stream [2 * base_blocks * new_len], bursts)."""
    block_len = config["block_size"]
    length = traffic["base_blocks"] * (block_len - config["block_history"])
    noise_std = traffic["noise_std"]
    rng = rng_for(seed, 2)
    noise = rng.standard_normal((2, length))
    stream = (noise[0] + 1j * noise[1]) * (noise_std / np.sqrt(2))
    ook = (np.asarray(template) > 0).astype(np.float64)
    placed = bursts(traffic, config, len(template), seed)
    for b in placed:
        base = int(np.floor(b["position"]))
        buf, lead = burst_samples(ook, b["carrier_bin"], b["phase"],
                                  b["position"] - base, block_len)
        start = base - lead
        stream[start:start + len(buf)] += b["amplitude"] * buf
    return iq_to_raw(stream), placed


def touched_blocks(placed, config, base_blocks, template_len):
    """Indices in [0, base_blocks) of the blocks that hold any sample of
    a burst: what a carrier-gated capture archives of this stream."""
    new_len = config["block_size"] - config["block_history"]
    hist = config["block_history"]
    out = set()
    for b in placed:
        lo = int(np.floor(b["position"]))
        hi = lo + template_len
        # Block g spans [g*new_len - hist, g*new_len - hist + block_len).
        first = max(0, -(-(lo + hist - config["block_size"] + 1) // new_len))
        last = (hi - 1 + hist) // new_len
        out.update(g % base_blocks for g in range(first, last + 1))
    return sorted(out)
