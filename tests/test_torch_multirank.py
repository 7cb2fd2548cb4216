"""The port's sharded detection in spawned gloo worlds on the CPU,
against the JAX package's sharded programs (the torch counterpart of
tests/test_multihost.py).

Two worlds run at once, each process a ``python -c`` worker that imports
torch and the port only and meets the others through a ``file://``
store in ``tmp_path`` (no port shared between test workers):

- a world of 4 ranks on an (rx=2, time=2) mesh at a small geometry: the
  stream detector gathered and not (the parent stitches the ranks'
  slices), gated at capacities 1 and 4, with a template bank, the GSPMD
  twin ungated and gated, and ``batch_detect_sharded``;
- a world of 2 ranks on an (rx=1, time=2) mesh at the full geometry
  (16384/4920/4914), tests/test_sharded.py::test_full_geometry_halo.

The parent makes every input from numpy seeds, hands it to the workers
in an ``.npz`` and holds their saved outputs against JAX's programs on
the same (rx, time) mesh of conftest's 8 CPU devices and against JAX's
single-device detector: decisions, ``carrier_bin``, ``corr_sample``,
``template_idx`` and ``block_idx`` exact; ``corr_offset`` and
``carrier_offset`` within 2e-4; gated against ungated on carrier rows
within rtol 1e-5, atol 1e-6 (tests/test_gate.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import BLOCK, CFG, HISTORY, TPL, \
    assert_tables_match, jax_stream, new_samples, single_device, \
    small_capture  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import template  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu.parallel import mesh as jax_mesh  # noqa: E402
from thrifty_tpu.parallel import sharded as jax_sharded  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# One rank of a world: runs the runs of spec.json on inputs.npz and saves
# its outputs (and each detector's gate overflow count) as rank<k>.npz.
WORKER = r"""
import json, os, sys
import numpy as np
import torch
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu_torch.parallel import distributed, mesh, sharded

world, rank, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
distributed.initialize(init_method="file://" + os.path.join(d, "store"),
                       num_processes=world, process_id=rank,
                       backend="gloo", device="cpu")
with open(os.path.join(d, "spec.json")) as f:
    spec = json.load(f)
inp = np.load(os.path.join(d, "inputs.npz"))
# One rx row per host: LOCAL_WORLD_SIZE ranks a host.
pod = distributed.pod_mesh(device="cpu")
assert pod.shape == {"rx": spec["num_rx"], "time": spec["num_time"]}
saved = {"coordinator": np.array(distributed.is_coordinator())}
for run in spec["runs"]:
    # A run on a sub-span of the world: every rank makes its groups, the
    # ranks outside it skip it.
    m = mesh.make_mesh(*run["mesh"], device="cpu") if "mesh" in run \
        else pod
    if not m.member:
        continue
    cfg = dict(run["config"], carrier_window=tuple(run["config"]
                                                   ["carrier_window"]))
    det = BatchDetector(inp[run["template"]], DetectorConfig(**cfg),
                        device="cpu")
    if run["program"] == "batch":
        out = sharded.batch_detect_sharded(det, m)(inp[run["input"]])
    else:
        chunk = sharded.shard_stream(inp[run["input"]], m)
        if run["program"] == "gspmd":
            fn = sharded.make_stream_detector_gspmd(
                det, m.shape["time"] * run["per_shard"], m)
        else:
            fn = sharded.make_stream_detector(
                det, m.shape["rx"], run["per_shard"], m,
                gather=run["gather"])
        out = fn(chunk)
    for k, v in out.items():
        saved[run["name"] + "/" + k] = v.numpy()
    saved[run["name"] + "/gate_overflows"] = np.array(det.gate_overflows)
np.savez(os.path.join(d, "rank{}.npz".format(rank)), **saved)
torch.distributed.destroy_process_group()
print("OK rank", rank)
"""

SMALL = dict(CFG)
PER4 = 6            # blocks per rank in the world of 4
TOTAL4 = 2 * PER4   # blocks per receiver
FULL_PER = 4


def bank3():
    return np.stack([template.generate(5, i, 2.0) for i in (0, 1, 2)])


def world4_inputs():
    """(spec, inputs) of the world of 4."""
    caps = [small_capture(TOTAL4, seed=i, bursts_every=3 + 2 * i)
            for i in range(2)]
    bank = bank3()
    bcaps = [small_capture(TOTAL4, seed=9 + i, tpl=bank[1 + i])
             for i in range(2)]
    batch = small_capture(16, seed=4).blocks.astype(np.complex64)
    runs = [dict(name="plain", program="stream", gather=True),
            dict(name="local", program="stream", gather=False),
            dict(name="gate1", program="stream", gather=True, gate=1),
            dict(name="gate4", program="stream", gather=True, gate=4),
            dict(name="bank", program="stream", gather=True,
                 template="bank", input="bank_streams"),
            dict(name="twin", program="gspmd"),
            dict(name="twin_gate4", program="gspmd", gate=4),
            dict(name="batch", program="batch", input="batch"),
            # Ranks 0 and 1 only, each holding both receivers' rows.
            dict(name="sub", program="stream", gather=True, mesh=[1, 2])]
    for run in runs:
        run.setdefault("template", "tpl")
        run.setdefault("input", "streams")
        run.setdefault("gather", False)
        run["per_shard"] = PER4
        run["config"] = dict(SMALL, gate_capacity=run.pop("gate", 0))
    spec = dict(num_rx=2, num_time=2, runs=runs)
    inputs = dict(tpl=TPL, bank=bank, streams=new_samples(caps, HISTORY),
                  bank_streams=new_samples(bcaps, HISTORY), batch=batch)
    return spec, inputs


def world2_inputs():
    tpl = sim.make_template()
    cap = sim.synth_capture(num_blocks=2 * FULL_PER, bursts_every=3,
                            template=tpl, quantize=False, seed=2)
    spec = dict(num_rx=1, num_time=2, runs=[dict(
        name="full", program="stream", gather=True, template="tpl",
        input="streams", per_shard=FULL_PER,
        config=dict(carrier_window=(7, 110)))])
    return spec, dict(tpl=tpl, streams=new_samples([cap], 4920)), cap


def spawn(world, d, spec, inputs):
    os.makedirs(d)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["LOCAL_WORLD_SIZE"] = str(spec["num_time"])
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(world), str(rank), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def collect(procs, d):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o, e[-4000:])
    return [dict(np.load(os.path.join(d, "rank{}.npz".format(k))))
            for k in range(len(procs))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned together: {name: (spec, inputs, per-rank
    outputs)}, plus the full geometry's capture."""
    base = tmp_path_factory.mktemp("worlds")
    spec4, in4 = world4_inputs()
    spec2, in2, cap2 = world2_inputs()
    p4 = spawn(4, str(base / "w4"), spec4, in4)
    p2 = spawn(2, str(base / "w2"), spec2, in2)
    try:
        ranks4 = collect(p4, str(base / "w4"))
    finally:
        ranks2 = collect(p2, str(base / "w2"))
    return {"w4": (spec4, in4, ranks4), "w2": (spec2, in2, ranks2),
            "cap2": cap2}


def result(ranks, name, rank=0):
    """One run's output dict on ``rank`` (the gate's overflow count
    aside; empty on a rank outside the run's mesh)."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in ranks[rank].items()
            if k.startswith(pre) and k != pre + "gate_overflows"}


def overflows(ranks, name):
    return [int(r[name + "/gate_overflows"]) for r in ranks]


def jax_det(tpl, gate=0):
    return JaxDetector(tpl, JaxConfig(**SMALL, gate_capacity=gate))


@pytest.fixture(scope="module")
def jax_plain(worlds):
    _, inputs, _ = worlds["w4"]
    return jax_stream(jax_det(TPL), inputs["streams"], 2, 2, PER4)


def test_gathered_table_on_every_rank(worlds, jax_plain):
    """gather=True: every rank holds the [R, total] table, equal to JAX's
    shard_map program on a (2, 2) mesh and to its single-device detector
    on the host-unfolded blocks."""
    _, inputs, ranks = worlds["w4"]
    got = result(ranks, "plain")
    assert got["detected"].shape == (2, TOTAL4)
    assert_tables_match(got, jax_plain, "rank 0")
    for k in range(1, 4):
        other = result(ranks, "plain", k)
        for f in got:
            np.testing.assert_array_equal(other[f], got[f], err_msg=f)
    jdet = jax_det(TPL)
    for r in range(2):
        blocks = sim.stream_to_blocks(
            inputs["streams"][r].astype(np.complex128), BLOCK, HISTORY)
        ref = single_device(jdet, blocks.astype(np.complex64))
        assert_tables_match({k: got[k][r] for k in ref}, ref,
                            "single rx {}".format(r))
    assert got["detected"].any()


def test_local_slices_stitch_to_the_table(worlds, jax_plain):
    """gather=False: rank (r, t) holds [1, PER4] of receiver r's blocks
    t*PER4..; stitched, they are the gathered table."""
    _, _, ranks = worlds["w4"]
    parts = [result(ranks, "local", k) for k in range(4)]
    for p, k in zip(parts, range(4)):
        np.testing.assert_array_equal(
            p["block_idx"], (k % 2) * PER4 + np.arange(PER4)[None])
    stitched = {f: np.concatenate([np.concatenate(
        [parts[2 * r + t][f] for t in range(2)], axis=1) for r in range(2)])
        for f in parts[0]}
    assert_tables_match(stitched, jax_plain)


@pytest.mark.parametrize("cap", [1, 4])
def test_gate_under_the_mesh(worlds, cap):
    """tests/test_gate.py::test_sharded_gate's assertions on the gathered
    table, gated at ``cap`` per rank-local batch of 6 against ungated,
    and against JAX's gated program on the same mesh; at capacity 1 some
    ranks overflow and re-run in full, others do not."""
    _, inputs, ranks = worlds["w4"]
    a = result(ranks, "plain")
    b = result(ranks, "gate{}".format(cap))
    np.testing.assert_array_equal(a["detected"], b["detected"])
    m = a["carrier_detect"]
    for k in ("corr_sample", "template_idx", "carrier_bin"):
        np.testing.assert_array_equal(a[k][m], b[k][m], err_msg=k)
    for k in ("corr_offset", "corr_energy", "carrier_offset"):
        np.testing.assert_allclose(a[k][m], b[k][m], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert_tables_match(b, jax_stream(jax_det(TPL, cap), inputs["streams"],
                                      2, 2, PER4), "gate")
    runs = overflows(ranks, "gate{}".format(cap))
    if cap == 1:
        assert 0 in runs and 1 in runs, runs
    else:
        assert runs == [0, 0, 0, 0], runs


def test_bank_under_the_mesh(worlds):
    _, inputs, ranks = worlds["w4"]
    bank = inputs["bank"]
    got = result(ranks, "bank")
    jdet = JaxDetector(bank, JaxConfig(**SMALL))
    assert_tables_match(got, jax_stream(jdet, inputs["bank_streams"], 2, 2,
                                        PER4))
    for r in range(2):
        hit = got["detected"][r]
        assert hit.any() and (got["template_idx"][r][hit] == 1 + r).all()


def test_gspmd_twin(worlds):
    """The twin equals the shard_map program's slices and JAX's GSPMD
    program."""
    _, inputs, ranks = worlds["w4"]
    for k in range(4):
        twin = result(ranks, "twin", k)
        local = result(ranks, "local", k)
        for f in local:
            np.testing.assert_array_equal(twin[f], local[f], err_msg=f)
    stitched = {f: np.concatenate([np.concatenate(
        [result(ranks, "twin", 2 * r + t)[f] for t in range(2)], axis=1)
        for r in range(2)]) for f in result(ranks, "twin")}
    jax_gs = jax_stream(jax_det(TPL), inputs["streams"], 2, 2, PER4,
                        gspmd=True)
    assert_tables_match(stitched, jax_gs)


def test_gspmd_twin_gate(worlds):
    """tests/test_gate.py::test_gspmd_gate's assertions: the gated twin
    (capacity per rank-local batch) keeps the ungated decisions; and
    JAX's gated GSPMD program (capacity on the global batch) gives the
    same decisions."""
    _, inputs, ranks = worlds["w4"]

    def stitch(name):
        parts = [result(ranks, name, k) for k in range(4)]
        return {f: np.concatenate([np.concatenate(
            [parts[2 * r + t][f] for t in range(2)], axis=1)
            for r in range(2)]) for f in parts[0]}

    a, b = stitch("twin"), stitch("twin_gate4")
    np.testing.assert_array_equal(a["detected"], b["detected"])
    m = a["carrier_detect"]
    np.testing.assert_array_equal(a["corr_sample"][m], b["corr_sample"][m])
    np.testing.assert_allclose(a["corr_offset"][m], b["corr_offset"][m],
                               rtol=1e-5, atol=1e-6)
    jax_gs = jax_stream(jax_det(TPL, 4), inputs["streams"], 2, 2, PER4,
                        gspmd=True)
    np.testing.assert_array_equal(b["detected"], jax_gs["detected"])
    np.testing.assert_array_equal(b["corr_sample"][m],
                                  jax_gs["corr_sample"][m])


def test_sub_span_mesh(worlds, jax_plain):
    """A (1, 2) mesh over the first 2 of the 4 ranks: its ranks hold both
    receivers' rows and gather the table, JAX's first-devices mesh of the
    same shape gives the same; ranks 2 and 3 never joined it.  The pod
    mesh is one rx row per host (LOCAL_WORLD_SIZE = 2) and rank 0 alone
    is the coordinator."""
    _, inputs, ranks = worlds["w4"]
    got = result(ranks, "sub")
    assert_tables_match(got, jax_stream(jax_det(TPL), inputs["streams"], 1,
                                        2, PER4))
    assert_tables_match(got, jax_plain)
    for f in got:
        np.testing.assert_array_equal(result(ranks, "sub", 1)[f], got[f])
    assert result(ranks, "sub", 2) == {} and result(ranks, "sub", 3) == {}
    assert [bool(r["coordinator"]) for r in ranks] == [True] + [False] * 3


def test_batch_detect_sharded(worlds):
    """tests/test_sharded.py::test_batch_sharded_matches_single_device:
    each rank's slice of [16, N], all-gathered on every rank."""
    _, inputs, ranks = worlds["w4"]
    jdet = jax_det(TPL)
    m = jax_mesh.make_mesh(num_rx=2, num_time=2)
    fn = jax_sharded.batch_detect_sharded(jdet, m)
    jax_out = {k: np.asarray(v) for k, v in fn(inputs["batch"]).items()}
    ref = single_device(jdet, inputs["batch"])
    for k in range(4):
        got = result(ranks, "batch", k)
        assert_tables_match(got, jax_out, "rank {}".format(k))
        assert_tables_match(got, ref, "single")


def test_full_geometry_world_of_two(worlds):
    """tests/test_sharded.py::test_full_geometry_halo across two ranks:
    time rank 1's blocks read rank 0's 4920-sample halo."""
    spec, inputs, ranks = worlds["w2"]
    cap = worlds["cap2"]
    jdet = JaxDetector(inputs["tpl"], JaxConfig(carrier_window=(7, 110)))
    got = result(ranks, "full")
    for gspmd in (False, True):
        assert_tables_match(got, jax_stream(jdet, inputs["streams"], 1, 2,
                                            FULL_PER, gspmd=gspmd))
    np.testing.assert_array_equal(result(ranks, "full", 1)["detected"],
                                  got["detected"])
    ref = single_device(jdet, cap.blocks)
    np.testing.assert_array_equal(got["detected"][0], ref["detected"])
    np.testing.assert_array_equal(got["corr_sample"][0], ref["corr_sample"])
    soa = jdet.soa(got["block_idx"][0], got["corr_sample"][0],
                   got["corr_offset"][0])
    hits = 0
    for burst in cap.bursts:
        i = burst.block_idx
        if i >= 0 and ref["detected"][i]:
            hits += 1
            assert abs(soa[i] - burst.expected_soa) < 0.05
    assert hits >= 2


def test_network_demo_script():
    """scripts/network_demo_torch.py --device cpu --ranks 1: the JAX
    demo's scenario through the stream detector, the gathered table and
    the batched solver; every mobile fix within 15 m (PERF.md section 2;
    the JAX demo's worst is 0.93 m)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "network_demo_torch.py"),
         "--device", "cpu", "--ranks", "1"], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    errs = [float(line.split("err=")[1].split()[0])
            for line in proc.stdout.splitlines() if "err=" in line]
    assert len(errs) == 3 and max(errs) < 15.0, proc.stdout
    assert "positions: 3" in proc.stdout
