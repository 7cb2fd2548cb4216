"""CLI: per-stage detection diagnostics for a capture.

Offline equivalent of the reference's interactive analyzer
(thrifty/detect_analysis.py): for chosen blocks of a .card capture it
recomputes every detection stage with full intermediates (float64 host
path) and renders per-stage views -- sample histogram, IQ, FFT
magnitude/PSD, carrier peak neighborhood with the fitted Dirichlet
curve, correlation magnitude, correlation peak zoom with interpolation,
and template overlay -- exported to pdf/png or .npz (no GUI).

Thresholds can be zeroed with --force to analyze blocks that would not
normally trigger (the reference's ForcibleDetector).
"""

from __future__ import annotations

import sys
import argparse

import numpy as np

from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.config.parsers import normalize_freq_range
from thrifty_tpu_torch.io import card
from thrifty_tpu_torch.io import tpl as tpl_io
from thrifty_tpu_torch.oracle.numpy_ref import (
    FastdetOracleDetector, OracleDetector, dirichlet_kernel)

PLOTS = ["hist", "iq", "mag", "fft", "fft_window", "psd",
         "carrier_zoom", "carrier_interp", "filtered_fft",
         "iq_synced", "mag_synced", "fft_synced", "psd_synced",
         "corr", "corr_log", "corr_interp", "corr_shifted",
         "template_overlay", "autocorr_compare", "phase"]

# Views that need a carrier hit / correlation intermediates.
NEEDS_CARRIER = ("iq_synced", "mag_synced", "fft_synced", "psd_synced")
NEEDS_CORR = ("corr", "corr_log", "corr_interp", "corr_shifted",
              "template_overlay", "autocorr_compare", "phase")


class BlockDiagnostics:
    """All intermediates of one block's detection, float64."""

    def __init__(self, oracle: OracleDetector, block, template):
        self.oracle = oracle
        self.block = np.asarray(block, dtype=np.complex128)
        self.template = template
        self.fft = np.fft.fft(self.block)
        self.fft_mag = np.abs(self.fft)
        (self.carrier_detected, self.carrier_bin, self.carrier_energy,
         self.carrier_noise) = oracle.carrier_detect(self.fft_mag)
        self.carrier_offset = 0.0
        self.corr_mag = None
        self.synced = None
        self.shifted_fft = None
        if self.carrier_detected:
            self.carrier_offset = float(
                oracle.carrier_interpolate(self.fft_mag, self.carrier_bin))
            shifted = oracle.sync_fft(
                self.block, self.fft, self.carrier_bin, self.carrier_offset)
            self.shifted_fft = shifted
            self.synced = np.fft.ifft(shifted)
            energy = np.sum(np.abs(self.block) ** 2)
            (self.detected, self.corr_sample, self.corr_offset,
             self.corr_energy, self.corr_noise) = oracle.soa_estimate(
                shifted, energy)
            corr = np.fft.ifft(shifted * oracle.template_fft_conj)
            self.corr_complex = corr[:oracle.corr_len]
            self.corr_mag = np.abs(self.corr_complex)
        else:
            self.detected = False

    def summary(self):
        line = "carrier: {} @ bin {}{:+.3f} (peak {:.1f}, noise {:.2f})" \
            .format("yes" if self.carrier_detected else "no",
                    self.carrier_bin, self.carrier_offset,
                    self.carrier_energy, self.carrier_noise)
        if self.carrier_detected:
            line += "; corr: {} @ {}{:+.3f} (peak {:.1f}, noise {:.2f})" \
                .format("yes" if self.detected else "no", self.corr_sample,
                        self.corr_offset, self.corr_energy, self.corr_noise)
        return line

    def to_npz(self):
        out = {
            "block": self.block, "fft_mag": self.fft_mag,
            "carrier_bin": self.carrier_bin,
            "carrier_offset": self.carrier_offset,
        }
        if self.corr_mag is not None:
            out["corr_mag"] = self.corr_mag
            out["corr_sample"] = self.corr_sample
            out["corr_offset"] = self.corr_offset
        return out

    # -- plotting ------------------------------------------------------------

    def plot(self, name, ax):
        getattr(self, "_plot_" + name)(ax)

    def _plot_hist(self, ax):
        ax.hist(self.block.real, 64, alpha=0.6, label="I")
        ax.hist(self.block.imag, 64, alpha=0.6, label="Q")
        ax.legend()
        ax.set_title("sample histogram")

    def _plot_iq(self, ax):
        ax.plot(self.block.real, lw=0.3, label="I")
        ax.plot(self.block.imag, lw=0.3, label="Q")
        ax.legend()
        ax.set_title("IQ samples")

    def _plot_fft(self, ax):
        ax.plot(np.fft.fftshift(self.fft_mag), lw=0.4)
        ax.set_yscale("log")
        ax.set_title("|FFT| (shifted)")

    def _plot_carrier_interp(self, ax):
        idx = self.carrier_bin
        n = len(self.fft_mag)
        rel = np.arange(-8, 9)
        ax.plot(rel, self.fft_mag[(idx + rel) % n], "o", label="FFT bins")
        if isinstance(self.oracle, FastdetOracleDetector):
            # Parabola through the 3 points around the peak
            # (fastdet/corr_detector.cpp:88-101).
            y3 = self.fft_mag[(idx + np.arange(-1, 2)) % n]
            coef = np.polyfit([-1.0, 0.0, 1.0], y3, 2)
            xs = np.linspace(-2, 2, 200)
            ax.plot(xs, np.polyval(coef, xs), "-", label="parabolic fit")
        else:
            xs = np.linspace(-8, 8, 400)
            model = self.carrier_energy * np.abs(dirichlet_kernel(
                xs - self.carrier_offset, self.oracle.block_len,
                self.oracle.carrier_len))
            ax.plot(xs, model, "-", label="Dirichlet fit")
        ax.axvline(self.carrier_offset, color="k", lw=0.5)
        ax.legend()
        ax.set_title("carrier sub-bin interpolation")

    def _plot_corr(self, ax):
        ax.plot(self.corr_mag, lw=0.4)
        start, stop = self.oracle.window
        ax.axvspan(0, start, color="r", alpha=0.1)
        ax.axvspan(stop, len(self.corr_mag), color="r", alpha=0.1)
        ax.set_title("correlation magnitude (red = non-unique window)")

    def _plot_corr_interp(self, ax):
        idx = int(np.clip(self.corr_sample, 5, len(self.corr_mag) - 6))
        rel = np.arange(-5, 6)
        ax.plot(rel + (self.corr_sample - idx), self.corr_mag[idx + rel],
                "o-")
        ax.axvline(self.corr_offset, color="k", lw=0.5)
        ax.set_title("corr peak (offset {:+.3f})".format(self.corr_offset))

    def _plot_mag(self, ax):
        ax.plot(np.abs(self.block), lw=0.3)
        ax.set_title("|x(t)| (unsynced)")

    def _plot_iq_synced(self, ax):
        ax.plot(self.synced.real, lw=0.3, label="I")
        ax.plot(self.synced.imag, lw=0.3, label="Q")
        ax.legend()
        ax.set_title("IQ samples (carrier removed)")

    def _plot_mag_synced(self, ax):
        ax.plot(np.abs(self.synced), lw=0.3)
        ax.set_title("|x(t)| (carrier removed)")

    def _plot_fft_window(self, ax):
        ax.plot(self.fft_mag, lw=0.4)
        win = self.oracle.carrier_idx
        ax.plot(win, self.fft_mag[win], lw=0.6, color="C1",
                label="carrier search window")
        ax.set_yscale("log")
        ax.legend()
        ax.set_title("|FFT| with carrier window")

    def _plot_fft_synced(self, ax):
        ax.plot(np.fft.fftshift(np.abs(self.shifted_fft)), lw=0.4)
        ax.set_yscale("log")
        ax.set_title("|FFT| after carrier removal (shifted)")

    def _plot_filtered_fft(self, ax):
        # Dirichlet matched peak filter on the magnitude spectrum
        # (reference carrier_detect.py:128-154), computed EXACTLY as
        # detection does: the FIR runs over the contiguous wrapped
        # carrier-window selection with zero initial conditions at the
        # window start, delay-realigned, so the displayed curve is the
        # surface the peak search actually ran on (a whole-spectrum
        # FIR would diverge at the window start and across the DC
        # wrap).
        # The detector's float32 filter, on a CPU tensor.
        import torch

        from thrifty_tpu_torch.dsp.carrier import apply_peak_filter
        from thrifty_tpu_torch.dsp.dirichlet import dirichlet_weights
        n = self.oracle.block_len
        w = dirichlet_weights((n // self.oracle.carrier_len - 1) * 2,
                              n, self.oracle.carrier_len)
        sel = self.oracle.carrier_idx
        filt, delay = apply_peak_filter(torch.from_numpy(
            self.fft_mag[sel][None, :].astype(np.float32)), w)
        filt = filt.numpy()[0]
        full = np.full(n, np.nan)
        # Filter output at selection position k estimates the peak at
        # position k - delay; place it there.
        aligned = filt[delay:]
        full[sel[: len(aligned)]] = aligned
        ax.plot(self.fft_mag, lw=0.3, label="|FFT|")
        ax.plot(full, lw=0.5, label="peak-filtered (window)")
        ax.set_yscale("log")
        ax.legend()
        ax.set_title("Dirichlet peak-filtered spectrum")

    def _plot_psd_synced(self, ax):
        n = len(self.block)
        psd = np.abs(self.shifted_fft) ** 2 / n
        ax.plot(np.fft.fftshift(np.fft.fftfreq(n)),
                10 * np.log10(np.fft.fftshift(psd) + 1e-30), lw=0.4)
        ax.set_xlabel("normalized frequency")
        ax.set_ylabel("PSD (dB)")
        ax.set_title("power spectral density (carrier removed)")

    def _plot_corr_shifted(self, ax):
        # Time-shift the correlation by -offset so the true peak lands
        # on an integer sample (reference plot_corr_peak_shifted).
        m = len(self.corr_complex)
        spec = np.fft.fft(self.corr_complex)
        # Advance by +offset so the true peak (at sample + offset)
        # lands on the integer sample.
        ramp = np.exp(2j * np.pi * self.corr_offset
                      * np.fft.fftfreq(m))
        shifted = np.abs(np.fft.ifft(spec * ramp))
        idx = int(np.clip(self.corr_sample, 5, m - 6))
        rel = np.arange(-5, 6)
        ax.plot(rel, self.corr_mag[idx + rel], "o-", label="raw",
                lw=0.6)
        ax.plot(rel, shifted[idx + rel], "s--", label="shifted by "
                "{:+.3f}".format(-self.corr_offset), lw=0.6)
        ax.legend()
        ax.set_title("corr peak, sub-sample aligned")

    def _plot_psd(self, ax):
        n = len(self.block)
        psd = np.abs(self.fft) ** 2 / n
        ax.plot(np.fft.fftshift(np.fft.fftfreq(n)),
                10 * np.log10(np.fft.fftshift(psd) + 1e-30), lw=0.4)
        ax.set_xlabel("normalized frequency")
        ax.set_ylabel("PSD (dB)")
        ax.set_title("power spectral density")

    def _plot_carrier_zoom(self, ax):
        idx = self.carrier_bin
        rel = np.arange(-30, 31)
        ax.plot(rel + idx,
                self.fft_mag[(idx + rel) % len(self.fft_mag)], ".-",
                lw=0.5)
        ax.axvline(idx + self.carrier_offset, color="k", lw=0.5)
        ax.set_title("carrier neighborhood (+-30 bins)")

    def _plot_corr_log(self, ax):
        ax.semilogy(self.corr_mag + 1e-30, lw=0.4)
        ax.set_title("correlation magnitude (log)")

    def _plot_autocorr_compare(self, ax):
        # Compare the captured peak's shape against the template's
        # ideal autocorrelation (reference detect_analysis autocorr view).
        tlen = len(self.template)
        pad = np.concatenate([self.template, np.zeros(tlen)])
        spec = np.fft.fft(pad)
        acorr = np.abs(np.fft.ifft(spec * np.conj(spec)))[:40]
        acorr /= acorr[0]
        peak = self.corr_sample
        lo = max(peak - 39, 0)
        hi = min(peak + 40, len(self.corr_mag))
        cut = self.corr_mag[lo:hi]
        cut = cut / np.max(cut)
        ax.plot(np.arange(lo - peak, hi - peak), cut, ".-",
                lw=0.5, label="captured")
        rel = np.arange(40)
        ax.plot(rel, acorr, lw=0.8, label="ideal autocorr")
        ax.plot(-rel, acorr, lw=0.8, color="C1")
        ax.legend()
        ax.set_title("correlation peak vs ideal autocorrelation")

    def _plot_phase(self, ax):
        # Carrier-removed phase across the code: should be ~constant
        # when the carrier estimate is good.
        start = self.corr_sample
        tlen = len(self.template)
        seg = self.synced[start:start + tlen]
        ax.plot(np.unwrap(np.angle(seg[np.abs(seg) > 0.1 * np.max(
            np.abs(seg))])), lw=0.4)
        ax.set_ylabel("phase (rad)")
        ax.set_title("carrier-removed phase across the code")

    def _plot_template_overlay(self, ax):
        start = self.corr_sample
        tlen = len(self.template)
        cut = np.abs(self.synced[start:start + tlen])
        cut = cut / np.max(cut)
        ax.plot(cut, lw=0.3, label="|captured|")
        ax.plot((self.template > 0) * np.max(cut), lw=0.3, alpha=0.7,
                label="template (OOK)")
        ax.legend()
        ax.set_title("template overlay")


class InteractiveViewer:
    """Keyboard-nav diagnostics browser.

    The headless-friendly re-design of the reference's PyQt4 tabbed
    browser (reference thrifty/detect_analysis.py:555-621): one
    matplotlib window, left/right steps through blocks, up/down (or
    j/k) through the plot views, 'q' closes.  Works over any
    matplotlib backend (X11, Tk, or ssh -X on a headless TPU host).
    """

    def __init__(self, diagnostics, plot_names, fig=None):
        import matplotlib.pyplot as plt

        if not diagnostics:
            raise ValueError("no blocks to browse")
        self.diags = diagnostics  # [(block_idx, BlockDiagnostics)]
        self.names = list(plot_names)
        self.block_i = 0
        self.view_i = 0
        self.fig = plt.figure(figsize=(9, 5)) if fig is None else fig
        self.ax = self.fig.add_subplot(111)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.render()

    def on_key(self, event):
        if event.key in ("right", "n"):
            self.block_i = (self.block_i + 1) % len(self.diags)
        elif event.key in ("left", "p"):
            self.block_i = (self.block_i - 1) % len(self.diags)
        elif event.key in ("down", "j"):
            self.view_i = (self.view_i + 1) % len(self.names)
        elif event.key in ("up", "k"):
            self.view_i = (self.view_i - 1) % len(self.names)
        elif event.key == "q":
            import matplotlib.pyplot as plt

            plt.close(self.fig)
            return
        else:
            return
        self.render()

    @property
    def current(self):
        return self.diags[self.block_i], self.names[self.view_i]

    def render(self):
        (bidx, diag), name = self.current
        self.ax.clear()
        unavailable = (name in NEEDS_CORR and diag.corr_mag is None) or \
            (name in NEEDS_CARRIER and diag.synced is None)
        if unavailable:
            self.ax.text(0.5, 0.5, "{}: needs a {} detection".format(
                name, "corr" if name in NEEDS_CORR else "carrier"),
                ha="center", va="center", transform=self.ax.transAxes)
        else:
            diag.plot(name, self.ax)
        self.fig.suptitle(
            "block {}  [{} {}/{}]   <-/->: block  up/down: view  q: quit"
            .format(bidx, name, self.view_i + 1, len(self.names)),
            fontsize=9)
        self.fig.canvas.draw_idle()


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", type=str, help="input .card file")
    parser.add_argument("--blocks", type=str, default=None,
                        help="comma-separated block indices to analyze "
                             "[default: all detected]")
    parser.add_argument("--force", action="store_true",
                        help="zero the thresholds (analyze all blocks)")
    parser.add_argument("--fastdet", action="store_true",
                        help="analyze with fastdet's numerics (integer "
                             "roll, parabolic carrier offset, 0.5 clips) "
                             "instead of the Python reference's")
    parser.add_argument("--plots", type=str, default=",".join(PLOTS),
                        help="comma-separated plot names [default: all]")
    parser.add_argument("--export", type=str, default=None,
                        help="write plots to this pdf")
    parser.add_argument("--save-npz", type=str, default=None,
                        help="dump intermediates to an .npz file")
    parser.add_argument("--interactive", action="store_true",
                        help="open a key-navigable plot browser "
                             "(left/right: block, up/down: view, q: "
                             "quit) instead of/next to exporting")
    keys = ["sample_rate", "block_size", "block_history", "carrier_window",
            "carrier_threshold", "corr_threshold", "template"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    template = tpl_io.load_template(config.template)
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    thresh_c = (0.0, 0.0, 0.0) if args.force else config.carrier_threshold
    thresh_u = (0.0, 0.0, 0.0) if args.force else config.corr_threshold
    oracle_cls = FastdetOracleDetector if args.fastdet else OracleDetector
    oracle = oracle_cls(
        template, block_len=config.block_size,
        history_len=config.block_history, carrier_thresh=thresh_c,
        carrier_window=window, corr_thresh=thresh_u)

    ts, idx, blocks = card.read_card_blocks(args.input)
    if args.blocks:
        wanted = {int(b) for b in args.blocks.split(",")}
        sel = [i for i, b in enumerate(idx) if int(b) in wanted]
    else:
        sel = range(len(idx))

    plot_names = args.plots.split(",")
    diagnostics = []
    for i in sel:
        diag = BlockDiagnostics(oracle, blocks[i], template)
        if not diag.carrier_detected and not args.blocks and not args.force:
            continue
        diagnostics.append((int(idx[i]), diag))
        print("block {}: {}".format(int(idx[i]), diag.summary()))

    if args.save_npz and diagnostics:
        arrays = {}
        for bidx, diag in diagnostics:
            for k, v in diag.to_npz().items():
                arrays["b{}_{}".format(bidx, k)] = v
        np.savez_compressed(args.save_npz, **arrays)
        print("saved intermediates to", args.save_npz)

    if args.interactive:
        if not diagnostics:
            print("nothing to browse (no analyzed blocks)")
            return
        import matplotlib.pyplot as plt

        # Keep a strong reference: mpl_connect holds the key handler
        # weakly, so an unassigned viewer would be GC'd and navigation
        # would silently go dead.
        viewer = InteractiveViewer(diagnostics, plot_names)
        plt.show()
        del viewer

    if args.export and diagnostics:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages
        with PdfPages(args.export) as pdf:
            for bidx, diag in diagnostics:
                for name in plot_names:
                    if name in NEEDS_CORR and diag.corr_mag is None:
                        continue
                    if name in NEEDS_CARRIER and diag.synced is None:
                        continue
                    fig, ax = plt.subplots(figsize=(9, 4))
                    diag.plot(name, ax)
                    fig.suptitle("block {}".format(bidx))
                    pdf.savefig(fig)
                    plt.close(fig)
        print("saved plots to", args.export)


if __name__ == "__main__":
    sys.exit(_main())
