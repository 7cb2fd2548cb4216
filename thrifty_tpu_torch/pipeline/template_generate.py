"""CLI: generate an ideal Gold-code template (.npy).

Mirrors the reference ``thrifty template_generate``
(thrifty/template_generate.py:48-75): sample a Gold code at
sample_rate/chip_rate samples per chip with an integer sampler.
"""

from __future__ import annotations

import sys
import argparse

import numpy as np

from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.dsp import template as template_mod


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("length", type=int,
                        help="Gold code register length (code len = 2^n-1)")
    parser.add_argument("index", nargs="?", type=int, default=0,
                        help="code index within the Gold family")
    parser.add_argument("-o", "--output", type=str, default="template.npy",
                        help="output file (.npy) [default: template.npy]")
    config, args = settings_mod.load_args(
        parser, ["sample_rate", "chip_rate"], argv=argv)

    sps = config.sample_rate / config.chip_rate
    samples = template_mod.generate(args.length, args.index, sps)
    np.save(args.output, samples)

    code_len = 2 ** args.length - 1
    print("Generated new template: {} symbols @ {:.6f} MHz = {:.3f} ms "
          "--> {} samples @ {:.6f} Msps".format(
              code_len, config.chip_rate / 1e6,
              code_len / config.chip_rate * 1e3, len(samples),
              config.sample_rate / 1e6))


if __name__ == "__main__":
    sys.exit(_main())
