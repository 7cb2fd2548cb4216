#!/usr/bin/env python
"""Rank-grid scaling sweep of the PyTorch + CUDA port: streaming-detect
throughput vs the number of ranks (the port's counterpart of
scripts/scaling_sweep.py, on ``thrifty_tpu_torch.parallel``).

For each (rx, time) shape a local world of rx*time ranks is spawned
(as scripts/network_demo_torch.py spawns its ranks: NCCL when the world
has at most one rank per card, gloo when ranks share a card or run on
the CPU), the halo-exchange streaming detector is timed on every rank
with ``thrifty_tpu_torch.bench.time_stream_mesh`` over burst-spliced
streams, and rank 0 reports per-shape step time, aggregate throughput
and scaling efficiency relative to the first (1x1) row.

Ranks that share a card contend for it (and for the host's cores), so on
a machine with fewer cards than ranks the efficiency column measures that
contention, not scaling; the header line on stderr prints the card count
and the ranks per card of every shape.

Timing uses the same data-dependent chain as the bench (the carry
perturbs the next iteration's input with a value visible in float32),
so steps cannot overlap behind the host's back.

Usage:
  # wiring check on the CPU: worlds of 1 and 2 gloo ranks
  python scripts/scaling_sweep_torch.py --device cpu --geometry tiny \\
      --shapes 1x1,1x2

  # one card: a world of one, then 2 and 4 gloo ranks sharing it
  python scripts/scaling_sweep_torch.py --shapes 1x1,1x2,2x2 --json s.json

  # across nodes: run THIS under torchrun on every node (env://
  # rendezvous); shapes must span the whole world; rank 0 reports
  torchrun --nnodes 2 --nproc-per-node 4 ... \\
      scripts/scaling_sweep_torch.py --distributed --shapes 2x4

``--device cuda`` (the default) without a card raises.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RANK_TIMEOUT_S = 900


def parse_shapes(text, n_avail):
    """'1x1,1x2,2x2' -> [(1,1),(1,2),(2,2)]; default: powers of two."""
    if text:
        shapes = []
        for part in text.split(","):
            rx, _, t = part.lower().partition("x")
            shapes.append((int(rx), int(t)))
        return shapes
    shapes = []
    n = 1
    while n <= n_avail:
        shapes.append((1, n))
        if n >= 4 and n % 2 == 0:
            shapes.append((2, n // 2))
        n *= 2
    return shapes


def parse_args(argv):
    from thrifty_tpu_torch.device import DEVICES

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--shapes", type=str, default=None,
                        help="comma list of RXxTIME rank grids "
                             "[default: power-of-two sweep up to "
                             "--ranks-per-node ranks]")
    parser.add_argument("--geometry", choices=["tiny", "full"],
                        default="full",
                        help="'full': 16384/4920 example geometry; "
                             "'tiny': 256/64 wiring check")
    parser.add_argument("--blocks-per-shard", type=int, default=4)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where every rank computes; 'cuda' fails "
                             "without a card [default: cuda]")
    parser.add_argument("--json", type=str, default=None,
                        help="also write results to this JSON file")
    parser.add_argument("--ranks-per-node", type=int, default=None,
                        help="local ranks the default sweep may use "
                             "[default: one per card; 1 on the CPU]")
    parser.add_argument("--rendezvous", type=str, default=None,
                        help="init_method of every spawned world, e.g. "
                             "tcp://127.0.0.1:29511 [default: a file:// "
                             "store in a temporary directory]")
    parser.add_argument("--distributed", action="store_true",
                        help="join the world torchrun started (env:// "
                             "rendezvous; run on every node; every shape "
                             "must span the world; rank 0 reports)")
    return parser.parse_args(argv)


def card_count(device):
    import torch

    return torch.cuda.device_count() if device == "cuda" else 0


def world_backend(args, world):
    """NCCL with at most one rank per card; gloo when ranks share a card
    (NCCL refuses that) or run on the CPU."""
    if args.device == "cpu":
        return "gloo"
    return "nccl" if world <= card_count(args.device) else "gloo"


def make_detector(geometry, device):
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import template as template_mod
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    if geometry == "full":
        template = sim.make_template()
        config = DetectorConfig(carrier_window=(7, 110))
    else:
        template = template_mod.generate(5, 0, 2.0)
        config = DetectorConfig(block_len=256, history_len=64,
                                carrier_window=(4, 60), gn_iters=4)
    return template, BatchDetector(template, config, device=device)


def time_mesh(detector, template, num_rx, num_time, blocks_per_shard,
              iters, device):
    """Chained per-step seconds of this rank for one mesh shape, and the
    samples one step covers across the mesh.

    Uses the bench's shared ``time_stream_mesh`` timer with
    burst-bearing streams: the data-dependent chain's 1e-10 perturbation
    factor is calibrated against a corr-energy carry of ~1e5-1e6, which
    only burst-bearing inputs produce (pure noise would leave the chain
    perturbation below float32 visibility).
    """
    import numpy as np

    from thrifty_tpu_torch import bench
    from thrifty_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh(num_rx=num_rx, num_time=num_time, device=device)
    total_blocks = num_time * blocks_per_shard
    new_len = detector.new_len
    total = total_blocks * new_len
    tpl = np.asarray(template, dtype=np.complex64)
    streams = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        s = (rng.normal(size=(num_rx, total))
             + 1j * rng.normal(size=(num_rx, total))
             ).astype(np.complex64) * 0.05
        # Splice a template copy into every block so the corr-energy
        # carry is large in every shard/iteration.
        for b in range(total_blocks):
            pos = b * new_len
            end = min(pos + len(tpl), total)
            s[:, pos:end] += 0.6 * tpl[: end - pos]
        streams.append(s)

    sec = bench.time_stream_mesh(detector, streams, m, blocks_per_shard,
                                 iters)
    samples = num_rx * num_time * blocks_per_shard * new_len
    return sec, samples


def run_shape(args, shape, rank=None, world=None, init_method=None,
              result_path=None):
    """One rank's timing of ``shape``: in the torchrun world joined
    already (``--distributed``), else in a world of ``world`` ranks made
    here and destroyed after.  Returns (sec, samples); rank 0 of a made
    world also writes them to ``result_path``."""
    import torch.distributed as dist

    from thrifty_tpu_torch.parallel import distributed

    if not args.distributed:
        distributed.initialize(init_method=init_method,
                               num_processes=world, process_id=rank,
                               backend=world_backend(args, world),
                               device=args.device)
    try:
        template, detector = make_detector(args.geometry, args.device)
        sec, samples = time_mesh(detector, template, shape[0], shape[1],
                                 args.blocks_per_shard, args.iters,
                                 args.device)
    finally:
        if not args.distributed:
            dist.destroy_process_group()
    if result_path is not None and rank == 0:
        with open(result_path, "w") as f:
            json.dump([sec, samples], f)
    return sec, samples


def _spawned(args, shape, rank, world, init_method, result_path):
    run_shape(args, shape, rank, world, init_method, result_path)


def spawn_world(args, shape, workdir):
    """Time ``shape`` in a fresh local world of rx*time ranks; a world
    of one runs in this process.  Returns rank 0's (sec, samples)."""
    world = shape[0] * shape[1]
    tag = "{}x{}".format(*shape)
    init = args.rendezvous or "file://" + os.path.join(
        workdir, "store_" + tag)
    if world == 1:
        return run_shape(args, shape, 0, 1, init)
    result_path = os.path.join(workdir, "result_" + tag + ".json")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned,
                         args=(args, shape, rank, world, init, result_path))
             for rank in range(world)]
    for p in procs:
        p.start()
    failed = []
    try:
        for rank, p in enumerate(procs):
            p.join(RANK_TIMEOUT_S)
            if p.exitcode != 0:
                failed.append((rank, p.exitcode))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    if failed:
        raise RuntimeError("mesh {}: ranks failed (rank, exit code; None "
                           "= timed out): {}".format(tag, failed))
    with open(result_path) as f:
        sec, samples = json.load(f)
    return sec, samples


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else list(argv))

    from thrifty_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card for 'cuda': raise here
    cards = card_count(args.device)
    if args.distributed:
        import torch.distributed as dist

        from thrifty_tpu_torch.parallel import distributed

        distributed.initialize(
            backend=world_backend(args, int(os.environ["WORLD_SIZE"])),
            device=args.device)
        world = dist.get_world_size()
        shapes = parse_shapes(args.shapes, world)
        dropped = [s for s in shapes if s[0] * s[1] != world]
        shapes = [s for s in shapes if s[0] * s[1] == world] or [(1, world)]
        report = dist.get_rank() == 0
        if dropped and report:
            print("# distributed: dropping shapes {} that do not span the "
                  "world of {}".format(dropped, world), file=sys.stderr)
    else:
        per_node = args.ranks_per_node or max(cards, 1)
        shapes = parse_shapes(args.shapes, per_node)
        world = max(s[0] * s[1] for s in shapes)
        report = True
    if report:
        per_card = " ".join(
            "{}x{}:{}".format(r, t, -(-r * t // max(cards, 1))
                              if cards else "-") for r, t in shapes)
        print("# device={} cards={} geometry={} ranks per card: {}{}".format(
            args.device, cards, args.geometry, per_card,
            " (ranks share a card: efficiency measures contention, not "
            "scaling)" if cards and world > cards else ""),
            file=sys.stderr, flush=True)

    results = []
    base_rate_per_rank = None
    with tempfile.TemporaryDirectory(prefix="scaling_sweep_") as workdir:
        for num_rx, num_time in shapes:
            n = num_rx * num_time
            if args.distributed:
                sec, samples = run_shape(args, (num_rx, num_time))
            else:
                sec, samples = spawn_world(args, (num_rx, num_time),
                                           workdir)
            rate = samples / sec
            if base_rate_per_rank is None:
                base_rate_per_rank = rate / n
            eff = rate / (n * base_rate_per_rank)
            row = {"mesh": "{}x{}".format(num_rx, num_time), "devices": n,
                   "sec_per_step": round(sec, 6),
                   "samples_per_s": round(rate, 1),
                   "efficiency": round(eff, 3)}
            results.append(row)
            if report:
                print("{mesh:>6}  n={devices:<3d} {sec_per_step:>10.6f} "
                      "s/step  {samples_per_s:>14.4g} samples/s  "
                      "eff={efficiency:.2f}".format(**row), flush=True)

    if args.json and report:
        with open(args.json, "w") as f:
            json.dump({"geometry": args.geometry, "platform": args.device,
                       "cards": cards, "processes": world,
                       "results": results}, f, indent=1)
    if args.distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
