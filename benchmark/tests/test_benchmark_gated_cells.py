"""The ``rx_fastdet`` cells: their traffic does what the cells say, each
runs ``correct`` at a size a CPU test holds, and the readers listed on
them read something there."""

import pytest

from benchmark.harness import cells, session, traffic

SPEC = cells.manifest()
BY_NAME = {w["name"]: w for w in SPEC["workloads"]}
NEW = ("rx_fastdet.pipe_hostunfold", "rx_fastdet.pipe_dense")
# The readers of the accepted cell, listed on the new cells too, and the
# gate's own.
SHARED = ("ingest_wait_ms", "submit_ms", "kernels_per_batch", "drain_ms",
          "power_peak_us", "device_idle_pct")
GATE = "gate_overflows_per_batch"
SEEDS = (2 ** 31 + 1, 2 ** 31 + 77, 2 ** 33 + 5, 2 ** 40 + 9, 0, 1, -3,
         123456789)
BATCH = 256
CAPACITY = 32


def touched_per_batch(name, seed):
    """Touched blocks in each 256-block batch of the base stream (the
    base stream's length is a whole number of batches, so every batch
    of the repeated stream is one of these)."""
    settings = cells.config("rx_fastdet")
    mix = traffic.load(name)
    placed = traffic.bursts(mix, settings, 4914, seed)
    blocks = traffic.touched_blocks(placed, settings, mix["base_blocks"],
                                    4914)
    assert mix["base_blocks"] % BATCH == 0
    return [sum(1 for g in blocks if k * BATCH <= g < (k + 1) * BATCH)
            for k in range(mix["base_blocks"] // BATCH)]


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_mix_overflows_every_batch(seed):
    assert min(touched_per_batch("tx5_dense_pipe_hostunfold", seed)) \
        > CAPACITY


@pytest.mark.parametrize("seed", SEEDS)
def test_fielded_mix_fits_the_gate(seed):
    assert max(touched_per_batch("tx5_1hz_pipe_hostunfold", seed)) <= 20


def test_dense_mix_is_the_fielded_one_with_more_bursts():
    dense = traffic.load("tx5_dense_pipe_hostunfold")
    fielded = traffic.load("tx5_1hz_pipe_hostunfold")
    assert dense["bursts_per_tx"] == 51
    for key in set(dense) | set(fielded):
        if key not in ("bursts_per_tx", "description"):
            assert dense[key] == fielded[key], key


def test_manifest_lists_the_accepted_metrics_and_the_gates_on_the_new_cells():
    for name in NEW:
        assert BY_NAME[name]["config"] == "rx_fastdet"
        listed = {m["name"] for m in cells.metrics_for(SPEC, name, 1)}
        assert listed == set(SHARED) | {GATE}
    for m in SPEC["per_layer"]:
        if m["name"] == GATE:
            assert m["workloads"] == list(NEW) and m["layer"] == "gate"
        else:
            assert m["workloads"] == ["rx_example.pipe_hostunfold"] \
                + list(NEW)


# Batches of 8 under a gate of 4, on a 128-block base stream: the
# fielded mix leaves most batches under the capacity, the dense one
# puts a burst in nearly every block.
SMALL = {"base_blocks": 128, "batch_size": 8, "warmup_batches": 2,
         "gate_capacity": 4}


@pytest.mark.parametrize("workload", NEW)
def test_cell_runs_correct_at_a_small_size(workload):
    r = session.run_cell(BY_NAME[workload], 2 ** 31 + 13, 2.0, True,
                         device="cpu", sizes=SMALL)
    assert r["correct"], r["checks"]
    assert r["info"]["batches"] > 0 and r["info"]["records"] > 0
    values = r["per_layer"]
    # The CPU run's profiler holds no device kernels: those readers say
    # nothing here and read the card's trace.
    assert values["ingest_wait_ms"] > 0 and values["submit_ms"] > 0
    assert values["drain_ms"] > 0
    per_batch = values[GATE]
    n = len(r["window"])
    if workload == "rx_fastdet.pipe_dense":
        # Every window batch overflowed, and so did the batch drained
        # after the window's last, which the session's count holds too.
        assert r["overflows"] == n + 1
        assert per_batch == pytest.approx((n + 1) / n)
    else:
        assert per_batch < 0.5


@pytest.mark.parametrize("ctx", [
    {"settings": {"gate_capacity": 32}, "window": [], "overflows": 0},
    {"settings": {"gate_capacity": 0}, "window": [object()],
     "overflows": 0}], ids=["empty window", "ungated"])
def test_gate_reader_reads_nothing(ctx):
    assert cells.reader(GATE).read(ctx) is None
