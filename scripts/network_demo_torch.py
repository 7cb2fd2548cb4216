#!/usr/bin/env python
"""End-to-end positioning-network demo on an (rx, time) grid of ranks,
on the PyTorch + CUDA port (the port's counterpart of
scripts/network_demo.py).

Simulates 4 receivers observing beacon 9 + mobile 3 (IQ level, drifting
clocks), runs the port's streaming detector over an (rx, time) mesh of
``torch.distributed`` ranks -- each rank detects its stretch of its
receivers' streams on its device, the 4920-sample history halo comes
from the rank holding the previous stretch, and the detection table is
all-gathered -- then identify -> match -> tdoa -> the batched position
solver on the detector's device, and reports the position error against
the simulated ground truth.

    python scripts/network_demo_torch.py                    # one card
    python scripts/network_demo_torch.py --ranks 4 --backend gloo
    python scripts/network_demo_torch.py --device cpu --ranks 1
    torchrun --nproc-per-node 4 scripts/network_demo_torch.py

``--ranks N`` spawns a local world of N processes that meet through a
``file://`` store in a temporary directory: over NCCL with one rank per
card, over gloo when ranks share a card (``--backend gloo``, the default
then) or run on the CPU.  Under torchrun the script joins the world it
is given.  The mesh fits the world as the JAX demo's fits its devices:
``rx = min(4, ranks)``, ``time = ranks // rx``.
"""

import argparse
import functools
import multiprocessing
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RX_POS = {
    0: np.array([0.0, 0.0]),
    1: np.array([9000.0, 500.0]),
    2: np.array([4000.0, 8000.0]),
    3: np.array([-2000.0, 5000.0]),
}
BEACON_POS = {9: np.array([4500.0, 3000.0])}
MOBILE_POS = {3: np.array([6000.0, 2500.0])}
TX_BINS = {9: 30, 3: 70}
RANK_TIMEOUT_S = 900


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where every rank computes (default: the card)")
    parser.add_argument("--ranks", type=int, default=1,
                        help="spawn a local world of this many ranks "
                             "(ignored under torchrun)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl with one rank per card, gloo "
                             "when ranks share a card or on the CPU")
    parser.add_argument("--blocks", type=int, default=80)
    args = parser.parse_args(argv)
    if args.ranks < 1:
        parser.error("--ranks must be >= 1")
    if args.backend == "nccl" and args.device == "cpu":
        parser.error("--backend nccl needs --device cuda")
    return parser, args


def default_backend(args, world):
    if args.backend is not None:
        return args.backend
    if args.device == "cpu":
        return "gloo"
    import torch

    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def run_rank(argv, rank=None, world=None, init_method=None):
    """One rank's demo; rank 0 prints the positions.  Returns 0."""
    import torch

    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import power_peak
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.parallel import distributed, mesh as mesh_mod, \
        sharded
    from thrifty_tpu_torch.pipeline import kitchen_sink, pos

    parser, args = parse_args(argv)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if torchrun:
        world = int(os.environ["WORLD_SIZE"])
        distributed.initialize(backend=default_backend(args, world),
                               device=args.device)
    else:
        distributed.initialize(init_method=init_method, num_processes=world,
                               process_id=rank,
                               backend=default_backend(args, world),
                               device=args.device)
    try:
        n_ranks = torch.distributed.get_world_size()
        num_rx = min(len(RX_POS), n_ranks)
        num_time = max(n_ranks // num_rx, 1)
        m = mesh_mod.make_mesh(num_rx=num_rx, num_time=num_time,
                               device=args.device)
        coordinator = distributed.is_coordinator()
        if coordinator:
            print("ranks: {} ({}, {}) -> mesh (rx={}, time={})".format(
                n_ranks, torch.distributed.get_backend(), m.device, num_rx,
                num_time), flush=True)
        if not m.member:
            print("rank {}: outside the mesh".format(m.rank), flush=True)
            return 0

        tpl = sim.make_template()
        schedule = [(9, t) for t in np.arange(0.02, 0.36, 0.05)]
        schedule += [(3, t) for t in (0.085, 0.185, 0.285)]
        total_blocks = args.blocks - args.blocks % num_time
        if total_blocks <= 0:
            parser.error("--blocks must be >= the mesh's time axis "
                         "({} ranks -> num_time {})".format(n_ranks,
                                                            num_time))
        caps = sim.synth_rx_captures(
            RX_POS, {**BEACON_POS, **MOBILE_POS}, TX_BINS, schedule,
            template=tpl, num_blocks=total_blocks, amplitude=0.6,
            noise_std=0.04,
            clock_offsets={1: 777.25, 2: -123.5, 3: 2001.75},
            clock_drifts={1: 3e-6, 2: -2e-6, 3: 1e-6}, seed=11)

        detector = BatchDetector(tpl, DetectorConfig(carrier_window=(7, 110)),
                                 device=args.device)
        # Sharded streaming detect with halo exchange + gathered table.
        history = detector.config.history_len
        streams = np.stack([caps[r].blocks[:, history:].reshape(-1)
                            for r in sorted(caps)]).astype(np.complex64)
        fn = sharded.make_stream_detector(
            detector, num_rx, total_blocks // num_time, m, gather=True)
        power_peak.launches = 0
        out = {k: v.cpu().numpy()
               for k, v in fn(sharded.shard_stream(streams, m)).items()}
        print("rank {} at {}: {} power/peak kernel launches".format(
            m.rank, m.coords(), power_peak.launches), flush=True)
        if not coordinator:
            return 0
        print("sharded detect: {} detections across {} receivers".format(
            int(out["detected"].sum()), len(caps)))

        # Assemble the gathered table into detection records.
        parts = []
        for ri, rxid in enumerate(sorted(caps)):
            soa = detector.soa(out["block_idx"][ri], out["corr_sample"][ri],
                               out["corr_offset"][ri])
            parts.append(toad.from_detector_output(
                caps[rxid].timestamps, out["block_idx"][ri], soa,
                {k: v[ri] for k, v in out.items() if k != "block_idx"},
                rxid=rxid))
        detections = np.concatenate(parts)

        freqmap = {r: {9: (25.0, 35.0), 3: (65.0, 75.0)} for r in RX_POS}
        settings = kitchen_sink.PostdetectSettings(
            freqmap=freqmap, match_window=0.02, tdoa_est_window=8.0,
            rx_pos=RX_POS, beacon_pos=BEACON_POS, sample_rate=2.4e6)
        result = kitchen_sink.postdetect(
            detections, settings, pos_estimator=functools.partial(
                pos.solve_batched, device=detector.device))

        print("matches: {}; tdoa groups: {}; positions: {}".format(
            len(result.matches), len(result.tdoas), len(result.pos)))
        for row in result.pos:
            est = np.array([row["x"], row["y"]])
            err = np.linalg.norm(est - MOBILE_POS[3])
            print("  t={:.3f}  pos=({:8.1f},{:8.1f})  err={:6.2f} m  "
                  "dop={:.2f}".format(row["timestamp"] % 1000, row["x"],
                                      row["y"], err, row["dop"]))
        errs = [np.linalg.norm(np.array([r["x"], r["y"]]) - MOBILE_POS[3])
                for r in result.pos]
        if errs:
            print("position RMS error: {:.2f} m".format(
                float(np.sqrt(np.mean(np.square(errs))))))
        else:
            print("no position fixes (need more --blocks for the beacon "
                  "clock models)")
        return 0
    finally:
        torch.distributed.destroy_process_group()


def _spawned(argv, rank, world, init_method):
    sys.exit(run_rank(argv, rank, world, init_method))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    _, args = parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return run_rank(argv)
    with tempfile.TemporaryDirectory(prefix="network_demo_") as d:
        init = "file://" + os.path.join(d, "store")
        if args.ranks == 1:
            return run_rank(argv, 0, 1, init)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_spawned, args=(argv, rank, args.ranks,
                                                    init))
                 for rank in range(args.ranks)]
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
            print("ranks failed (rank, exit code; None = timed out): "
                  "{}".format(failed), file=sys.stderr)
            return 1
        return 0


if __name__ == "__main__":
    sys.exit(main())
