"""thrifty-tpu on PyTorch + CUDA: the receiver's paths and the offline
chain on one GPU.

A second implementation of ``thrifty_tpu``, written for eager PyTorch
on an NVIDIA Hopper card.  The JAX package stays the reference; this
package mirrors its module names so each counterpart is easy to find,
and imports neither ``jax`` nor anything of ``thrifty_tpu``: the numpy
host modules it needs are its own copies.

Layer map:
  ingest   -- .card / raw IQ readers and live sources (.io, numpy),
              the native host I/O engine (.native, g++ at first use)
  config   -- config files and threshold parsers           (.config)
  detect   -- carrier detect + sync + matched filter + SoA  (.dsp)
  kernels  -- hand-written CUDA for the fused power/peak reduction
              (.csrc, built at first use by ._build)
  server   -- identify -> match -> tdoa -> pos        (.pipeline)
  CLI      -- ``python -m thrifty_tpu_torch.cli <command>``

Every entry point that touches tensors takes a ``device`` that defaults
to ``"cuda"``; there is no silent CPU fallback
(:func:`thrifty_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
