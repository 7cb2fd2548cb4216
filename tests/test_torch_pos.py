"""The port's positioning chain (CPU): the torch batched
Levenberg-Marquardt solver against JAX ``solve_batched`` (float64, x64
on: tests/conftest.py), and the port's CLI chain detect -> identify ->
match -> tdoa -> pos against the reference goldens.

Solver tolerance: positions within 1e-6 m of JAX on tests/test_pos.py's
cases (the same float64 steps; the libraries' linear solves and sums
round differently in the last bits).  Two cases cannot be held to that,
and why is tested: the near-coplanar array has two mirror minima whose
residuals agree to 13 digits, so the last bits pick the winner (every
start still lands within 1e-6 m of JAX's); and noisy 3-D fixes on an
array with 200 m of z spread sit in a valley so flat that float64 cost
comparisons stop the steps 1e-5 m apart (1e-4 m).  CLI tolerances: those of
tests/test_golden_reference.py; ``pos --batched`` within test_pos's
0.5 m of the golden scipy fixes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_golden_reference as gr  # noqa: E402
from test_pos import PAIRS4, RX4, forward_tdoas  # noqa: E402
from thrifty_tpu.pipeline import pos as jpos  # noqa: E402
from thrifty_tpu.pipeline import tdoa  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.pipeline import pos  # noqa: E402

C = jpos.SPEED_OF_LIGHT
RX5 = {0: np.array([0.0, 0.0, 0.0]), 1: np.array([9000.0, 500.0, 50.0]),
       2: np.array([4000.0, 8000.0, 120.0]),
       3: np.array([-2000.0, 6000.0, 10.0]),
       4: np.array([3000.0, -4000.0, 200.0])}
PAIRS5 = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4)]
COLLINEAR = {0: np.array([2066.0, -1867.0]), 1: np.array([439.0, 29.0]),
             2: np.array([-1205.0, 1922.0]),
             3: np.array([-2837.0, 3821.0])}
COPLANAR = {0: np.array([-29181.41857066, 25948.32954709, -222.0839601]),
            1: np.array([16777.85870735, 22205.93886653, 162.13191117]),
            2: np.array([8084.68323547, -17724.71793607, -203.5907017]),
            3: np.array([2359.35794116, -20197.98664509, 174.45982677])}


def groups_for(rx_pos, txs, pairs_for, noise=0.0, snr=100.0, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, tx in enumerate(txs):
        t = forward_tdoas(np.asarray(tx), rx_pos, pairs_for(i), snr=snr)
        t["tdoa"] += rng.normal(0.0, noise, len(t))
        out.append(tdoa.TdoaGroup(group_id=i, timestamp=float(i), tx=3,
                                  tdoas=t))
    return out


def all_pairs(rx_pos):
    ids = sorted(rx_pos)
    return [(a, b) for k, a in enumerate(ids) for b in ids[k + 1:]]


CASES = {
    # test_pos TestSolveBatchedGroups.test_matches_scipy_path: ragged.
    "ragged_2d": lambda: (RX4, groups_for(
        RX4, np.random.default_rng(1).uniform(0, 8000, (12, 2)),
        lambda i: PAIRS4 if i % 3 else PAIRS4[:4])),
    "noisy_3d": lambda: (RX5, groups_for(
        RX5, np.random.default_rng(2).uniform(
            [0, 0, 0], [8000, 8000, 500], (12, 3)),
        lambda i: PAIRS5, noise=20e-9)),
    # test_multi_start_escapes_mirror_basin.
    "mirror_basin": lambda: (COLLINEAR, groups_for(
        COLLINEAR, [[9754.6, 3013.4]], lambda i: all_pairs(COLLINEAR),
        snr=1e4)),
    # test_coplanar_mirror_reaches_equal_residual_minimum.
    "coplanar": lambda: (COPLANAR, groups_for(
        COPLANAR, [[9591.92232974, -21816.26055646, 1086.28934725]],
        lambda i: all_pairs(COPLANAR), noise=50e-9, snr=1e4, seed=71)),
    # TestBatchedSolver.test_matches_scipy_solver.
    "batched_16": lambda: (RX4, groups_for(
        RX4, np.random.default_rng(0).uniform(0, 8000, (16, 2)),
        lambda i: PAIRS4)),
    # test_weighted_matches_scipy_path: one corrupted low-SNR pair each.
    "weighted_corrupt": lambda: (RX4, corrupted_groups(
        np.random.default_rng(4), 10)),
    # test_weighted_batched_downweights_noisy_tdoa.
    "downweight": lambda: (RX4, corrupted_groups(None, 1)),
}


def corrupted_groups(rng, n):
    """test_pos's weighted cases: SNR 1e4, one pair per group off by
    100-400 m (300 m on pair 2 without ``rng``) with SNR 1."""
    txs = [[5000.0, 3000.0]] if rng is None else rng.uniform(0, 8000, (n, 2))
    out = []
    for i, tx in enumerate(txs):
        t = forward_tdoas(np.asarray(tx), RX4, PAIRS4, snr=1e4)
        bad = 2 if rng is None else i % len(PAIRS4)
        t["tdoa"][bad] += (300.0 if rng is None
                           else rng.uniform(100.0, 400.0)) / C
        t["snr"][bad] = 1.0
        out.append(tdoa.TdoaGroup(group_id=i, timestamp=float(i), tx=3,
                                  tdoas=t))
    return out


def coords(fixes):
    return np.stack([fixes[k] for k in ("x", "y", "z")
                     if k in fixes.dtype.names], axis=-1)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["ragged_2d", "mirror_basin", "noisy_3d"])
def test_solve_batched_matches_jax(case, weighted):
    rx_pos, groups = CASES[case]()
    if weighted:
        for g in groups:
            g.tdoas["snr"] = np.linspace(1.0, 1e4, len(g.tdoas))
    ref = jpos.solve_batched(groups, rx_pos, weighted=weighted,
                             verbose=False)
    got = pos.solve_batched(groups, rx_pos, weighted=weighted,
                            verbose=False, device="cpu")
    assert got.dtype == ref.dtype and len(got) == len(ref) == len(groups)
    for name in ("group_id", "timestamp", "tx", "snr"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    atol = 1e-4 if case == "noisy_3d" else 1e-6
    np.testing.assert_allclose(coords(got), coords(ref), atol=atol, rtol=0)
    np.testing.assert_allclose(got["dop"], ref["dop"], rtol=1e-6)


@pytest.mark.parametrize("case,weighted", [
    ("batched_16", False), ("weighted_corrupt", True),
    ("downweight", False), ("downweight", True)])
def test_pos_cases_match_jax(case, weighted):
    """tests/test_pos.py's other batched cases, with their own SNRs:
    positions within 1e-6 m of JAX."""
    rx_pos, groups = CASES[case]()
    ref = jpos.solve_batched(groups, rx_pos, weighted=weighted,
                             verbose=False)
    got = pos.solve_batched(groups, rx_pos, weighted=weighted,
                            verbose=False, device="cpu")
    assert len(got) == len(ref) == len(groups)
    np.testing.assert_allclose(coords(got), coords(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["dop"], ref["dop"], rtol=1e-6)


def residual_norm(fix, rx_pos, group):
    p = np.asarray(fix, dtype=np.float64)
    r = [np.linalg.norm(p - rx_pos[int(a)]) - np.linalg.norm(
        p - rx_pos[int(b)]) - t * C for a, b, t in zip(
            group.tdoas["rx0"], group.tdoas["rx1"], group.tdoas["tdoa"])]
    return float(np.linalg.norm(r))


def test_coplanar_mirror_minima_match_jax():
    """The near-coplanar array: the port reaches JAX's minimum (one of
    its starts lands within 1e-6 m of JAX's fix) and its own fix has
    JAX's residual to 1e-9; which of the two mirror minima (z = +1080
    and -1461 m, residuals equal to 13 digits) wins is float64
    rounding."""
    rx_pos, groups = CASES["coplanar"]()
    ref = coords(jpos.solve_batched(groups, rx_pos, verbose=False))[0]
    got = coords(pos.solve_batched(groups, rx_pos, verbose=False))[0]
    starts, scores = (t.numpy() for t in pos._solve_starts(
        *padded_inputs(groups, rx_pos), 30, 1e-2, None,
        torch.device("cpu")))
    assert np.min(np.linalg.norm(starts[0] - ref, axis=-1)) < 1e-6
    assert np.min(np.linalg.norm(starts[0] - got, axis=-1)) < 1e-6
    np.testing.assert_allclose(residual_norm(got, rx_pos, groups[0]),
                               residual_norm(ref, rx_pos, groups[0]),
                               rtol=1e-9)
    assert np.ptp(scores[0]) < 1e-9 * scores[0].min()
    assert np.hypot(*(got[:2] - [9591.92232974, -21816.26055646])) < 350


def test_mirror_basin_escaped():
    rx_pos, groups = CASES["mirror_basin"]()
    got = pos.solve_batched(groups, rx_pos, device="cpu")
    np.testing.assert_allclose([got["x"][0], got["y"][0]], [9754.6, 3013.4],
                               atol=1.0)


def padded_inputs(groups, rx_pos, extra_groups=0, extra_pairs=0):
    pmax = max(len(g.tdoas) for g in groups) + extra_pairs
    n = len(groups) + extra_groups
    dims = len(next(iter(rx_pos.values())))
    tp, mask = np.zeros((n, pmax)), np.zeros((n, pmax), bool)
    rx0, rx1 = np.zeros((n, pmax, dims)), np.zeros((n, pmax, dims))
    for i, g in enumerate(groups):
        k = len(g.tdoas)
        tp[i, :k], mask[i, :k] = g.tdoas["tdoa"], True
        rx0[i, :k] = [rx_pos[int(a)] for a in g.tdoas["rx0"]]
        rx1[i, :k] = [rx_pos[int(b)] for b in g.tdoas["rx1"]]
    coords = np.array(list(rx_pos.values()))
    bounds = (coords.min(0) - pos.MAX_DIST, coords.max(0) + pos.MAX_DIST)
    return tp, mask, rx0, rx1, bounds


@pytest.mark.parametrize("case", ["ragged_2d", "noisy_3d"])
def test_padding_never_changes_a_result(case):
    """The JAX solver pads groups and pairs to power-of-two buckets; the
    port pads to the largest pair count only.  Extra masked pairs and
    empty groups change no position (and JAX's padded solve agrees)."""
    rx_pos, groups = CASES[case]()
    tight = pos.solve_groups_batched(*padded_inputs(groups, rx_pos))
    padded = pos.solve_groups_batched(*padded_inputs(groups, rx_pos, 5, 3))
    np.testing.assert_allclose(padded[:len(groups)], tight, atol=1e-9)
    ref = np.asarray(jpos.solve_groups_batched(
        *padded_inputs(groups, rx_pos)))
    np.testing.assert_allclose(tight, ref,
                               atol=1e-4 if case == "noisy_3d" else 1e-6)


def test_groups_solver_matches_jax_masked_pairs():
    """test_pos TestBatchedSolver.test_masked_pairs_ignored, both
    solvers: a masked pair with a wild TDOA changes nothing."""
    g = forward_tdoas(np.array([3000.0, 3000.0]), RX4, PAIRS4)
    tp = np.concatenate([g["tdoa"], [999.0]])[None, :]
    mask = np.array([[True] * len(PAIRS4) + [False]])
    rx0 = np.stack([[RX4[int(a)] for a in g["rx0"]] + [RX4[0]]])
    rx1 = np.stack([[RX4[int(b)] for b in g["rx1"]] + [RX4[1]]])
    coords = np.array(list(RX4.values()))
    bounds = (coords.min(0) - pos.MAX_DIST, coords.max(0) + pos.MAX_DIST)
    got = pos.solve_groups_batched(tp, mask, rx0, rx1, bounds)
    ref = np.asarray(jpos.solve_groups_batched(tp, mask, rx0, rx1, bounds))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[0], [3000.0, 3000.0], atol=0.5)


def test_skips_and_empty(capsys):
    tx = np.array([3000.0, 3000.0])
    groups = [tdoa.TdoaGroup(0, 0.0, 3, forward_tdoas(tx, RX4, PAIRS4)),
              tdoa.TdoaGroup(1, 1.0, 3, forward_tdoas(tx, RX4, [(0, 1)])),
              tdoa.TdoaGroup(2, 2.0, 3, forward_tdoas(
                  tx, {**RX4, 7: np.array([1.0, 1.0])}, [(0, 7), (1, 2)]))]
    got = pos.solve_batched(groups, RX4, device="cpu")
    assert got["group_id"].tolist() == [0]
    err = capsys.readouterr().err
    assert "#1: underdetermined" in err and "#2: receiver(s) [7]" in err
    assert len(pos.solve_batched([], RX4)) == 0
    pos.solve_batched(groups[1:], RX4, verbose=False)
    assert capsys.readouterr().err == ""


# -- the port's CLI chain against the reference goldens --------------------


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_golden_chain")
    inp = gr.INPUT
    for rxid in (0, 1, 2):
        assert main(["detect", os.path.join(inp, "rx%d.card" % rxid),
                     "-o", str(d / ("rx%d.toad" % rxid)), "--quiet",
                     "--rxid", str(rxid), "--carrier-window", "7-110",
                     "--template", os.path.join(inp, "template.npy"),
                     "--device", "cpu"]) == 0
    assert main(["identify"] + [str(d / ("rx%d.toad" % i)) for i in range(3)]
                + ["-o", str(d / "rx.toads"),
                   "-m", os.path.join(inp, "freq-map.cfg")]) == 0
    assert main(["match", str(d / "rx.toads"), "-o", str(d / "rx.match"),
                 "-w", "0.02"]) == 0
    assert main(["tdoa", str(d / "rx.toads"), str(d / "rx.match"),
                 "-o", str(d / "data.tdoa"),
                 "-r", os.path.join(inp, "pos-rx.cfg"),
                 "-b", os.path.join(inp, "pos-beacon.cfg")]) == 0
    rx = os.path.join(inp, "pos-rx.cfg")
    assert main(["pos", str(d / "data.tdoa"), "-o", str(d / "data.pos"),
                 "-r", rx]) == 0
    assert main(["pos", str(d / "data.tdoa"), "-o", str(d / "batched.pos"),
                 "-r", rx, "--batched", "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("check", ["test_identify_matches_reference",
                                   "test_match_matches_reference",
                                   "test_tdoa_matches_reference",
                                   "test_pos_matches_reference"])
def test_chain_matches_reference(chain, check):
    """tests/test_golden_reference.py's checks, on the port's CLI."""
    getattr(gr, check)(chain)


def test_batched_pos_matches_golden(chain):
    ref = gr._load(os.path.join(gr.GOLDEN, "data.pos"))
    got = gr._load(str(chain / "batched.pos"))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, (0, 2)], ref[:, (0, 2)])
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=1e-3)
    np.testing.assert_allclose(got[:, 5:], ref[:, 5:], atol=0.5)


def test_pos_cuda_without_card_raises(chain, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["pos", str(chain / "data.tdoa"), "-o", str(chain / "x.pos"),
              "-r", os.path.join(gr.INPUT, "pos-rx.cfg"), "--batched"])
    assert not (chain / "x.pos").exists()
