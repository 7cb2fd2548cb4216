"""Layered settings: CLI args > kv config file > defaults.

Single source of truth for the framework's runtime settings, mirroring the
reference's registry (thrifty/settings.py:23-109) and kv config syntax
(``key: value`` with ``#`` comments, thrifty/settings.py:309-321).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterable

from thrifty_tpu_torch.config import parsers

log = logging.getLogger(__name__)


class ConfigError(Exception):
    """Base class for settings-related errors."""


class ConfigSyntaxError(ConfigError):
    def __init__(self, line_no: int, msg: str):
        super().__init__("line #{}: {}".format(line_no, msg))
        self.line_no = line_no
        self.msg = msg


class UnknownSettingError(ConfigError):
    pass


@dataclasses.dataclass(frozen=True)
class Setting:
    flags: tuple
    parse: Callable[[str], Any]
    default: Any
    help: str


SETTINGS: dict[str, Setting] = {
    "sample_rate": Setting(
        ("--sample-rate", "-s"), parsers.metric_float, "2.4M",
        "Sample rate (sps)"),
    "chip_rate": Setting(
        ("--chip-rate", "-p"), parsers.metric_float, "0.999707M",
        "Rate at which the code is transmitted (bps)"),
    "tuner_freq": Setting(
        ("--freq", "-f"), parsers.metric_float, "433.83M",
        "Tuner center frequency (Hz)"),
    "tuner_gain": Setting(
        ("--gain", "-g"), float, "0",
        "Tuner gain (dB)"),
    "capture_skip": Setting(
        ("--skip", "-k"), int, "1",
        "Number of blocks to skip before capturing from the SDR"),
    "block_size": Setting(
        ("--block-size", "-b"), int, "16384",
        "Length of fixed-sized blocks (samples, power of two)"),
    "block_history": Setting(
        ("--history", "-y"), int, "4920",
        "Samples repeated from the end of a block at the start of the next"),
    "carrier_window": Setting(
        ("--carrier-window", "-w"), parsers.freq_range, "0--1",
        "Range of frequencies or frequency bins to look for carrier"),
    "carrier_threshold": Setting(
        ("--carrier-threshold", "-t"), parsers.threshold, "15*snr",
        "Threshold formula for carrier detector"),
    "corr_threshold": Setting(
        ("--corr-threshold", "-u"), parsers.threshold, "15*snr",
        "Threshold formula for correlation peak detector"),
    "template": Setting(
        ("--template", "-z"), str, "template.npy",
        "Load template from a Numpy .npy file"),
    "rxid": Setting(
        ("--rxid", "-r"), int, -1,
        "Unique identifier of this receiver"),
    # TPU-native additions (no reference equivalent):
    "batch_size": Setting(
        ("--batch-size",), int, "256",
        "Number of blocks processed per device batch"),
    "sync_mode": Setting(
        ("--sync-mode",), str, "fractional",
        "Carrier sync mode: 'fractional' (phase-ramp shift, reference "
        "python semantics), 'integer' (FFT roll, fastdet semantics) or "
        "'preshift' (integer roll + pre-shifted template bank)"),
}

DEFAULT_CONFIG_PATH = "detector.cfg"
_COMMENT = "#"
_DELIM = ":"


def parse_kv_config(lines: Iterable[str]) -> dict[str, str]:
    """Parse a simple ``key: value`` config file with ``#`` comments."""
    out: dict[str, str] = {}
    for line_no, line in enumerate(lines, start=1):
        if _COMMENT in line:
            line = line.split(_COMMENT, 1)[0]
        if not line.strip():
            continue
        if _DELIM not in line:
            raise ConfigSyntaxError(line_no, "no delimiter found")
        key, value = line.split(_DELIM, 1)
        out[key.strip()] = value.strip()
    return out


def load_settings(args=None, config_file=None, definitions=None):
    """Resolve setting values with precedence: args > config file > default.

    ``args`` and the config file hold *strings*; each value is run through
    its setting's parser.  Unknown keys raise UnknownSettingError.
    """
    defs = SETTINGS if definitions is None else definitions

    strings = {k: s.default for k, s in defs.items() if s.default is not None}

    if config_file is not None:
        cfg = parse_kv_config(config_file)
        for key in cfg:
            if key not in defs:
                raise UnknownSettingError("unknown setting: {}".format(key))
        strings.update(cfg)

    if args is not None:
        for key in args:
            if key not in defs:
                raise UnknownSettingError("unknown setting: {}".format(key))
        strings.update(args)

    return {
        k: (defs[k].parse(v) if isinstance(v, str) else v)
        for k, v in strings.items()
    }


def add_setting_args(parser, keys, definitions=None):
    """Add argparse string arguments for the given setting keys."""
    defs = SETTINGS if definitions is None else definitions
    for key in keys:
        if key not in defs:
            raise UnknownSettingError("unknown setting: {}".format(key))
        setting = defs[key]
        if setting.flags:
            help_str = setting.help
            if setting.default is not None:
                help_str += " [default: {}]".format(setting.default)
            parser.add_argument(
                *setting.flags, dest=key, type=str, help=help_str
            )


class Namespace(dict):
    """Dict whose items are also attributes (argparse-style access)."""

    def __init__(self, d):
        super().__init__(d)
        self.__dict__.update(d)


def load_args(parser, keys, argv=None, definitions=None):
    """Parse CLI args for the given setting keys plus a --config option.

    Returns ``(settings, extra_args)`` where *settings* holds resolved
    values for *keys* and *extra_args* holds any other parser arguments.
    """
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="increase verbosity"
    )
    parser.add_argument(
        "-c", "--config", dest="config", type=str, default=None,
        help="config file to load settings from [default: {}]".format(
            DEFAULT_CONFIG_PATH),
    )
    add_setting_args(parser, keys, definitions=definitions)
    args = vars(parser.parse_args(argv))

    if args.get("verbose", False):
        # Configure logging but LEAVE the flag in extra_args: callers
        # may key their own output on it (the reference's load_args
        # exposes it the same way, thrifty/settings.py:263-278).
        logging.basicConfig(level=logging.DEBUG)

    config_file = None
    config_arg = args.pop("config")
    if config_arg is None:
        try:
            config_file = open(DEFAULT_CONFIG_PATH)
        except IOError:
            log.warning("no config file found; using default values")
    else:
        try:
            config_file = open(config_arg)
        except IOError as e:
            # An explicitly named config that cannot be read is a
            # clean usage error (exit 2), not a traceback -- unlike
            # the implicit default, which is optional.
            parser.error("cannot read config file: {}".format(e))

    key_args = {k: v for k, v in args.items() if k in keys and v is not None}
    extra = {k: v for k, v in args.items() if k not in keys}

    try:
        values = load_settings(key_args, config_file, definitions)
    finally:
        if config_file is not None:
            config_file.close()

    return Namespace({k: v for k, v in values.items() if k in keys}), \
        Namespace(extra)
