"""Command-line pipelines of the port (counterparts of thrifty_tpu.pipeline)."""
