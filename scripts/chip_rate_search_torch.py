#!/usr/bin/env python
"""Fine-tune the chip-rate estimate of a positioning signal (the
PyTorch + CUDA port's counterpart of scripts/chip_rate_search.py).

Nelder-Mead search for the chip rate that maximizes the correlation
peak of one captured block against the ideal Gold template (reference
scripts/chip_rate_search.py).  It runs on the port's host modules
(``oracle.numpy_ref.OracleDetector``, ``io.card``, ``dsp.template``,
``config``): float64 numpy and scipy, with no ``--device`` because
nothing in it touches a device.

Usage:  python scripts/chip_rate_search_torch.py rx0.card [-c detector.cfg]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.optimize

from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.dsp import template as template_mod
from thrifty_tpu_torch.io import card
from thrifty_tpu_torch.oracle.numpy_ref import OracleDetector


def _make_oracle(block, template, carrier_window):
    return OracleDetector(
        template, block_len=len(block), history_len=len(template) - 1,
        carrier_thresh=(0.0, 0.0, 0.0), corr_thresh=(0.0, 0.0, 0.0),
        carrier_window=carrier_window)


def correlation_peak(block, chip_rate, sample_rate, bits, index,
                     carrier_window):
    """Max matched-filter peak of `block` for a candidate chip rate."""
    template = template_mod.generate(bits, index, sample_rate / chip_rate)
    oracle = _make_oracle(block, template, carrier_window)
    result = oracle.detect_block(block)
    return result.corr_energy


def search(block, initial_chip_rate, sample_rate, bits, index,
           carrier_window, verbose=True):
    # The carrier stage (FFT, windowed detect, Dirichlet curve-fit,
    # fractional shift) is template-independent: run it ONCE and let
    # every Nelder-Mead evaluation only re-correlate the cached
    # carrier-removed FFT against its candidate template -- the
    # reference syncs once outside the loop too
    # (/root/reference/scripts/chip_rate_search.py).
    block = np.asarray(block, dtype=np.complex128)
    tpl0 = template_mod.generate(bits, index,
                                 sample_rate / initial_chip_rate)
    probe = _make_oracle(block, tpl0, carrier_window)
    fft = np.fft.fft(block)
    fft_mag = np.abs(fft)
    _, c_idx, _, _ = probe.carrier_detect(fft_mag)
    c_off = float(probe.carrier_interpolate(fft_mag, c_idx))
    shifted_fft = probe.sync_fft(block, fft, c_idx, c_off)
    signal_energy = np.sum(np.abs(block) ** 2)

    def objective(params):
        template = template_mod.generate(bits, index,
                                         sample_rate / params[0])
        oracle = _make_oracle(block, template, carrier_window)
        _, _, _, peak, _ = oracle.soa_estimate(shifted_fft, signal_energy)
        if verbose:
            print(".. chip rate {:.1f} -> peak {:.1f}".format(
                params[0], peak))
        return -peak

    res = scipy.optimize.minimize(
        objective, [initial_chip_rate], method="Nelder-Mead",
        options={"xatol": 10, "disp": verbose})
    return float(res.x[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", type=str, help="input .card file")
    parser.add_argument("--block", type=int, default=None,
                        help="block index to use [default: strongest]")
    parser.add_argument("--bits", type=int, default=11)
    parser.add_argument("--index", type=int, default=0)
    config, args = settings_mod.load_args(
        parser, ["sample_rate", "chip_rate", "carrier_window",
                 "block_size"], argv=argv)

    from thrifty_tpu_torch.config.parsers import normalize_freq_range
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)

    ts, idx, blocks = card.read_card_blocks(args.input)
    if args.block is not None:
        block = blocks[list(idx).index(args.block)]
    else:
        energy = np.sum(np.abs(blocks) ** 2, axis=-1)
        block = blocks[int(np.argmax(energy))]

    best = search(block.astype(np.complex128), config.chip_rate,
                  config.sample_rate, args.bits, args.index, window)
    print("best chip rate: {:.1f} Hz ({:+.1f} vs nominal)".format(
        best, best - config.chip_rate))


if __name__ == "__main__":
    sys.exit(main())
