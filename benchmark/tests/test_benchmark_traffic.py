"""The traffic generator repeats by seed, and a seed changes where the
bursts fall but not how many there are or how strong."""

import glob
import os

import numpy as np
import pytest

from benchmark.harness import cells, traffic

TRAFFIC = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(cells.BENCH_DIR, "traffic", "*.json")))


def small(name):
    mix = traffic.load(name)
    mix["base_blocks"] = 48
    return mix


@pytest.mark.parametrize("name", TRAFFIC)
def test_repeats_by_seed(name):
    settings = cells.config("rx_example")
    template = cells.template(settings)
    mix = small(name)
    a, bursts_a = traffic.base_stream(mix, settings, template, 2 ** 31 + 5)
    b, bursts_b = traffic.base_stream(mix, settings, template, 2 ** 31 + 5)
    c, bursts_c = traffic.base_stream(mix, settings, template, 17)
    assert a.dtype == np.uint8
    assert a.shape == (2 * 48 * (settings["block_size"]
                                 - settings["block_history"]),)
    np.testing.assert_array_equal(a, b)
    assert bursts_a == bursts_b
    assert not np.array_equal(a, c)
    # The same work for every seed: as many bursts, as strong.
    assert sorted(x["amplitude"] for x in bursts_a) \
        == sorted(x["amplitude"] for x in bursts_c)
    assert len(bursts_a) == len(mix["transmitters"]) * mix["bursts_per_tx"]


def test_negative_and_large_seeds():
    settings = cells.config("rx_example")
    mix = small("tx5_1hz_pipe_devunfold")
    for seed in (-3, 0, 2 ** 40 + 1):
        placed = traffic.bursts(mix, settings, 4914, seed)
        length = 48 * (settings["block_size"] - settings["block_history"])
        assert all(0 < b["position"] and b["position"] + 4914
                   + traffic.BURST_PAD < length for b in placed)


def test_touched_blocks_hold_the_bursts():
    settings = cells.config("rx_example")
    mix = small("tx5_1hz_card")
    placed = traffic.bursts(mix, settings, 4914, 3)
    blocks = traffic.touched_blocks(placed, settings, 48, 4914)
    new = settings["block_size"] - settings["block_history"]
    hist = settings["block_history"]
    for b in placed:
        lo = int(b["position"])
        # The block whose span starts last at or before the burst holds
        # all of it (history >= template length) and is archived.
        g = (lo + hist) // new
        assert g * new - hist + settings["block_size"] >= lo + 4914
        assert g % 48 in blocks
