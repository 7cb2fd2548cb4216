"""The benchmark of the PyTorch + CUDA port (``thrifty_tpu_torch``):
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see ``PERF.md``."""
