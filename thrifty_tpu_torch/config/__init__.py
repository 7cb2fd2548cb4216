from thrifty_tpu_torch.config.parsers import (
    metric_float,
    freq_range,
    normalize_freq_range,
    threshold,
)
from thrifty_tpu_torch.config.settings import (
    SETTINGS,
    ConfigError,
    ConfigSyntaxError,
    UnknownSettingError,
    parse_kv_config,
    load_settings,
    add_setting_args,
    load_args,
)

__all__ = [
    "metric_float",
    "freq_range",
    "normalize_freq_range",
    "threshold",
    "SETTINGS",
    "ConfigError",
    "ConfigSyntaxError",
    "UnknownSettingError",
    "parse_kv_config",
    "load_settings",
    "add_setting_args",
    "load_args",
]
