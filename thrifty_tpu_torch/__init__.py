"""thrifty-tpu on PyTorch + CUDA: the receiver's detect path on one GPU.

A second implementation of the ``thrifty_tpu`` detector, written for
eager PyTorch on an NVIDIA Hopper card.  The JAX package stays the
reference; this package mirrors its module names so each counterpart
is easy to find, and never imports ``jax``.

Layer map:
  ingest   -- .card / raw IQ readers, reused from thrifty_tpu.io (numpy)
  detect   -- carrier detect + sync + matched filter + SoA  (.dsp)
  kernels  -- hand-written CUDA for the fused power/peak reduction
              (.csrc, built at first use by ._build)
  CLI      -- ``python -m thrifty_tpu_torch.cli detect``     (.pipeline)

Every function that touches tensors takes an explicit ``device``;
there is no global device and no silent CPU fallback
(:func:`thrifty_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
