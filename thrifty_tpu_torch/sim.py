"""Synthetic capture generation for tests and benchmarks.

The reference repo ships no capture data (example/Makefile expects
user-supplied .card files), so correctness and performance are measured
on synthesized captures: OOK-modulated Gold-code bursts on a carrier at a
chosen FFT bin, embedded in AWGN, streamed through the same overlap-save
blocking as a real receiver (block 16384 / history 4920).

Signal model (per the reference's design, README.rst:27-35): the
transmitter emits a carrier OOK-modulated by a Gold code; the unmodulated
"half" of the OOK signal produces the carrier line that the carrier
detector locks onto, and the code produces the correlation peak.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from thrifty_tpu_torch.dsp import template as template_mod
from thrifty_tpu_torch.dsp import iq


@dataclasses.dataclass
class Burst:
    """Ground truth for one transmitted burst."""

    position: float        # start of code in absolute stream samples
                           # (fractional with frac_jitter)
    carrier_bin: float     # carrier frequency in (fractional) FFT bins
    amplitude: float
    phase: float
    expected_soa: float    # position + history (the detector's SoA basis)
    block_idx: int         # block whose unique window contains the peak


@dataclasses.dataclass
class Capture:
    timestamps: np.ndarray  # [B] float64
    indices: np.ndarray     # [B] int64
    blocks: np.ndarray      # [B, N] complex64
    bursts: list            # list[Burst]
    template: np.ndarray    # [L] float64 bipolar template


# The solvers' truncated reference constant (thrifty/tdoa_est.py:25):
# ground truth and solvers must share it BIT-IDENTICALLY, or every
# position test acquires a silent ~300 ppm range bias.
from thrifty_tpu_torch.pipeline.tdoa import SPEED_OF_LIGHT  # noqa: E402


def synth_network(
    rx_pos: dict,
    tx_pos: dict,
    tx_schedule,
    sample_rate: float = 2.4e6,
    clock_offsets: dict = None,
    clock_drifts: dict = None,
    soa_noise: float = 0.0,
    seed: int = 0,
    block_len: int = 16384,
    history_len: int = 4920,
):
    """Simulate detection records for a receiver network (no DSP).

    Models the *geometry and clocks* only: each transmission (txid, t)
    arrives at receiver r after the propagation delay and is stamped
    with that receiver's free-running sample counter
    ``soa = (t + dist/c) * fs_r + offset_r`` where
    ``fs_r = sample_rate * (1 + drift_r)``.  Used to test the
    identify/match/tdoa/pos stages against known ground truth.

    ``tx_schedule`` is a list of (txid, t_seconds).  Returns a detection
    array (toad.DETECTION_DTYPE) sorted by timestamp.
    """
    from thrifty_tpu_torch.io import toad

    rng = np.random.default_rng(seed)
    clock_offsets = clock_offsets or {}
    clock_drifts = clock_drifts or {}
    new_len = block_len - history_len  # samples per block advance
    rows = []
    for txid, t in tx_schedule:
        for rxid, rpos in rx_pos.items():
            dist = float(np.linalg.norm(
                np.asarray(tx_pos[txid], dtype=np.float64)
                - np.asarray(rpos, dtype=np.float64)))
            toa = t + dist / SPEED_OF_LIGHT
            fs = sample_rate * (1.0 + clock_drifts.get(rxid, 0.0))
            soa = toa * fs + clock_offsets.get(rxid, 0.0)
            if soa_noise:
                soa += rng.normal(0.0, soa_noise)
            rows.append((rxid, txid, toa, int(soa // new_len), soa))
    rows.sort(key=lambda r: r[2])

    det = toad.empty(len(rows))
    for i, (rxid, txid, ts, block, soa) in enumerate(rows):
        det[i]["rxid"] = rxid
        det[i]["txid"] = txid
        det[i]["timestamp"] = ts
        det[i]["block"] = block
        det[i]["soa"] = soa
        det[i]["sample"] = int(soa % new_len)
        det[i]["energy"] = 1000.0
        det[i]["noise"] = 10.0
        det[i]["carrier_bin"] = 10 + 15 * txid
        det[i]["carrier_energy"] = 500.0
        det[i]["carrier_noise"] = 10.0
    return det


def synth_rx_captures(
    rx_pos: dict,
    tx_pos: dict,
    tx_bins: dict,
    tx_schedule,
    template: np.ndarray = None,
    num_blocks: int = 64,
    block_len: int = 16384,
    history_len: int = 4920,
    sample_rate: float = 2.4e6,
    amplitude: float = 0.5,
    noise_std: float = 0.05,
    clock_offsets: dict = None,
    clock_drifts: dict = None,
    seed: int = 0,
    t0: float = 1.5e9,
    tx_codes: dict = None,
):
    """Signal-level simulation of a receiver network.

    Every transmission (txid, t_seconds) is synthesized into each
    receiver's IQ stream at the geometrically correct sample position
    ``(t + dist/c) * fs_rx + clock_offset`` with the transmitter's
    carrier bin.  Returns {rxid: Capture}; each Burst's ``expected_soa``
    carries the receiver-local ground truth.

    By default transmitters share one Gold template and are
    distinguished by carrier frequency (tx_bins), exactly like the
    reference deployment (rpi/freq-map.cfg).  ``tx_codes`` optionally
    maps txids to their own templates (code-division identification via
    a detector template bank).
    """
    if template is None:
        template = make_template()
    from thrifty_tpu_torch.dsp.xcorr import corr_window

    template = np.asarray(template, dtype=np.float64)
    tlen = len(template)
    new_len = block_len - history_len
    length = num_blocks * new_len
    rng = np.random.default_rng(seed)
    clock_offsets = clock_offsets or {}
    clock_drifts = clock_drifts or {}
    wstart, wstop = corr_window(block_len, history_len, tlen)

    captures = {}
    for rxid, rpos in rx_pos.items():
        fs = sample_rate * (1.0 + clock_drifts.get(rxid, 0.0))
        bursts, truth = [], []
        for txid, t in tx_schedule:
            dist = float(np.linalg.norm(
                np.asarray(tx_pos[txid], dtype=np.float64)
                - np.asarray(rpos, dtype=np.float64)))
            pos = (t + dist / SPEED_OF_LIGHT) * fs \
                + clock_offsets.get(rxid, 0.0)
            if pos < 0 or int(pos) + tlen + 1 > length:
                continue
            phase = float(rng.uniform(0, 2 * np.pi))
            spec = {
                "position": pos,
                "carrier_bin": tx_bins[txid],
                "amplitude": amplitude,
                "phase": phase,
            }
            if tx_codes and txid in tx_codes:
                spec["template"] = tx_codes[txid]
            bursts.append(spec)
            soa = pos + history_len
            block_idx = None
            # The block whose unique window contains this burst.
            b = int((soa - wstart) // new_len)
            for cand in (b, b + 1, b - 1):
                lag = soa - cand * new_len
                if wstart <= lag < wstop and 0 <= cand < num_blocks:
                    block_idx = int(cand)
                    break
            truth.append(Burst(
                position=pos, carrier_bin=tx_bins[txid],
                amplitude=amplitude, phase=phase,
                expected_soa=float(soa),
                block_idx=block_idx if block_idx is not None else -1))
        stream = synth_stream(length, bursts, template, block_len,
                              noise_std, seed + rxid)
        raw = iq.iq_to_raw(stream)
        stream = iq.raw_to_iq_host(raw).astype(np.complex128)
        blocks = stream_to_blocks(stream, block_len, history_len)
        indices = np.arange(len(blocks), dtype=np.int64)
        captures[rxid] = Capture(
            # Block k completes after k*new_len ticks of the DRIFTED
            # sample clock: stamping with the nominal rate would skew
            # timestamps by duration*drift and eventually push the
            # same transmission's detections apart by more than the
            # match window on long simulated captures.
            timestamps=t0 + indices * (new_len / fs),
            indices=indices,
            blocks=blocks.astype(np.complex64),
            bursts=truth,
            template=template,
        )
    return captures


def ook_from_template(template: np.ndarray) -> np.ndarray:
    """Map a bipolar +-1 template to the transmitted OOK envelope {0, 1}."""
    return (np.asarray(template) > 0).astype(np.float64)


def make_template(bits=11, index=0, sample_rate=2.4e6, chip_rate=0.999707e6):
    """Default example-config template: 11-bit Gold code @ 2.4/0.999707."""
    return template_mod.generate(bits, index, sample_rate / chip_rate)


_BURST_PAD = 128  # guard samples absorbing fractional-delay ringing


def _burst_samples(ook, bin_f, phase, frac, block_len):
    """Burst waveform delayed by ``frac`` in [0, 1) samples.

    The fractional delay is applied in the frequency domain (band-limited
    interpolation), modelling what a real receiver samples when a signal
    arrives between sample instants.  Returns (samples, lead) where
    ``lead`` is the number of guard samples before the nominal start.
    """
    tlen = len(ook)
    nb = tlen + 2 * _BURST_PAD
    buf = np.zeros(nb, dtype=np.complex128)
    n = np.arange(tlen)
    buf[_BURST_PAD:_BURST_PAD + tlen] = ook * np.exp(
        2j * np.pi * bin_f * n / block_len + 1j * phase)
    if frac:
        k = np.fft.fftfreq(nb) * nb
        buf = np.fft.ifft(np.fft.fft(buf)
                          * np.exp(-2j * np.pi * k * frac / nb))
    return buf, _BURST_PAD


def synth_stream(
    length: int,
    bursts,
    template: np.ndarray,
    block_len: int = 16384,
    noise_std: float = 0.05,
    seed: int = 0,
):
    """Build a continuous complex sample stream with OOK code bursts.

    ``bursts`` is a list of dicts (position, carrier_bin, amplitude,
    phase).  ``position`` may be fractional: the burst is placed with a
    band-limited fractional delay, so sub-sample SoA/TDOA ground truth
    is exact.  The carrier frequency is ``carrier_bin`` cycles per
    ``block_len`` samples.
    """
    rng = np.random.default_rng(seed)
    stream = (
        rng.normal(0.0, noise_std, length)
        + 1j * rng.normal(0.0, noise_std, length)
    ).astype(np.complex128) / np.sqrt(2)

    default_ook = ook_from_template(template)
    for b in bursts:
        pos, bin_f, ampl, phase = (
            b["position"], b["carrier_bin"], b["amplitude"], b["phase"])
        # A burst may carry its own code (code-division transmitters).
        ook = ook_from_template(b["template"]) if "template" in b \
            else default_ook
        tlen = len(ook)
        base = int(np.floor(pos))
        frac = float(pos) - base
        if base < 0 or base + tlen > length:
            raise ValueError("burst does not fit in stream")
        buf, lead = _burst_samples(ook, bin_f, phase, frac, block_len)
        start = base - lead
        lo = max(start, 0)
        hi = min(start + len(buf), length)
        stream[lo:hi] += ampl * buf[lo - start:hi - start]
    return stream


def stream_to_blocks(stream, block_len=16384, history_len=4920):
    """Overlap-save unfold: continuous stream -> [B, N] blocks with halos.

    Block b holds stream[b*new - history : b*new - history + block_len],
    zero-padded before the stream start -- the same decomposition the
    reference's readers produce (thrifty/block_data.py:70-98,
    fastcard/raw_reader.c:22-30).
    """
    new_len = block_len - history_len
    padded = np.concatenate(
        [np.zeros(history_len, dtype=stream.dtype), stream])
    num_blocks = (len(padded) - block_len) // new_len + 1
    idx = (
        np.arange(num_blocks)[:, None] * new_len + np.arange(block_len)
    )
    return padded[idx]


def synth_capture(
    num_blocks: int = 64,
    bursts_every: int = 4,
    template: np.ndarray = None,
    block_len: int = 16384,
    history_len: int = 4920,
    carrier_bin: float = 40.25,
    amplitude: float = 0.5,
    noise_std: float = 0.05,
    seed: int = 0,
    quantize: bool = True,
    t0: float = 1.5e9,
    sample_rate: float = 2.4e6,
    frac_jitter: bool = False,
) -> Capture:
    """Generate a full synthetic capture with periodic bursts.

    Bursts are placed so each lands inside a block's unique correlation
    window.  With ``quantize`` the stream round-trips through 8-bit
    interleaved I/Q like a real RTL-SDR capture.  With ``frac_jitter``
    each burst is additionally displaced by a uniform sub-sample
    fraction (band-limited fractional delay in synth_stream), so
    ``expected_soa`` carries genuinely FRACTIONAL ground truth -- the
    regime that actually exercises sub-sample interpolators (default
    off to keep existing integer-truth seeds stable).
    """
    if template is None:
        template = make_template()
    template = np.asarray(template, dtype=np.float64)
    tlen = len(template)
    new_len = block_len - history_len

    rng = np.random.default_rng(seed + 1)
    length = num_blocks * new_len
    burst_list = []
    truth = []
    for b in range(1, num_blocks, bursts_every):
        # Place the code so its correlation lag falls mid-window of block b:
        # lag ~ history + (block_len - tlen - history)//2 keeps the whole
        # burst inside the block and well inside the unique window.
        lag = history_len + (block_len - tlen - history_len) // 2
        pos = b * new_len - history_len + lag
        jitter = int(rng.integers(-200, 200))
        pos += jitter
        if frac_jitter:
            pos += float(rng.uniform(-0.5, 0.5))
        # Bounds AFTER the jitter: a tight end margin (< 200 samples)
        # could otherwise push a 'validated' burst past the stream end
        # and crash synth_stream instead of skipping the burst.
        if pos < 0 or int(pos) + tlen + 1 > length:
            continue
        phase = float(rng.uniform(0, 2 * np.pi))
        bin_jitter = float(rng.uniform(-0.4, 0.4))
        burst_list.append({
            "position": pos,
            "carrier_bin": carrier_bin + bin_jitter,
            "amplitude": amplitude,
            "phase": phase,
        })
        truth.append(Burst(
            position=pos,
            carrier_bin=carrier_bin + bin_jitter,
            amplitude=amplitude,
            phase=phase,
            expected_soa=float(pos + history_len),
            block_idx=b,
        ))

    stream = synth_stream(
        length, burst_list, template, block_len, noise_std, seed)

    if quantize:
        raw = iq.iq_to_raw(stream)
        stream = iq.raw_to_iq_host(raw).astype(np.complex128)

    blocks = stream_to_blocks(stream, block_len, history_len)
    blocks = blocks.astype(np.complex64)
    indices = np.arange(len(blocks), dtype=np.int64)
    timestamps = t0 + indices * (new_len / sample_rate)
    return Capture(
        timestamps=timestamps,
        indices=indices,
        blocks=blocks,
        bursts=truth,
        template=template,
    )
