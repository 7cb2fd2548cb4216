"""Position estimation from TDOA values on the port (counterpart of
``thrifty_tpu.pipeline.pos``).

Each TDOA constrains the transmitter to a hyperbola; position is the
bounded nonlinear least-squares solution over all receiver pairs, with
DOP (dilution of precision) from the geometry matrix (reference
thrifty/pos_est.py:31-125).

The host solvers (:func:`solve`, :func:`solve_group`, :func:`solve_1d`,
:func:`dop`) and the ``.pos`` I/O are numpy/scipy, as in the JAX
package, function for function.

:func:`solve_groups_batched` is the batched multi-start
Levenberg-Marquardt solver in torch, float64 throughout, on ``device``
(the card unless the caller asks for the CPU): the JAX solver
(``pos.py:291-383``) step for step.  Groups are padded to the largest
pair count only: eager torch has no compiled program per shape, so the
JAX power-of-two shape buckets are dropped (padding pairs and groups do
not change a result; tested).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.optimize
import torch

from thrifty_tpu_torch.device import DEVICES, as_device, resolve_device
from thrifty_tpu_torch.pipeline import tdoa as tdoa_mod

SPEED_OF_LIGHT = tdoa_mod.SPEED_OF_LIGHT
MAX_DIST = 10e3  # search bounds beyond the receiver extent

POSITION_FIELDS = ("group_id", "timestamp", "tx", "dop", "snr", "x", "y", "z")


def position_dtype(dims):
    """Structured dtype of a .pos record with `dims` coordinates
    (group_id/tx i4, timestamp/dop/snr/coords f8)."""
    return np.dtype(
        [(f, "f8" if i > 2 else ("i4" if f != "timestamp" else "f8"))
         for i, f in enumerate(POSITION_FIELDS[:5 + dims])])


class EstimationError(Exception):
    pass


def solve_1d(tdoas, rx_pos):
    """Closed-form 1-D position for exactly two receivers."""
    missing = _missing_receivers(tdoas, rx_pos)
    if missing:
        # Validate at the same depth as solve_group/_geometry: without
        # this, a stale 1-D coordinate config would silently position
        # an unrelated receiver pair's TDOA between rx_pos's own two
        # coordinates (previously only rescued downstream by dop()'s
        # incidental KeyError).
        raise EstimationError(
            "receiver(s) {} not in coordinate config".format(
                sorted(missing)))
    rxids = sorted(rx_pos)
    r0, r1 = rx_pos[rxids[0]][0], rx_pos[rxids[1]][0]
    tdoa_m = float(tdoas["tdoa"][0]) * SPEED_OF_LIGHT
    if r0 > r1:
        position = (r0 + r1 - tdoa_m) / 2
    else:
        position = (r0 + r1 + tdoa_m) / 2
    return np.array([position]), float(tdoas["snr"][0])


def _geometry(tdoas, rx_pos):
    missing = _missing_receivers(tdoas, rx_pos)
    if missing:
        raise EstimationError(
            "receiver(s) {} not in coordinate config".format(
                sorted(missing)))
    rx0 = np.array([rx_pos[int(r)] for r in tdoas["rx0"]], dtype=np.float64)
    rx1 = np.array([rx_pos[int(r)] for r in tdoas["rx1"]], dtype=np.float64)
    return rx0, rx1


def _missing_receivers(tdoas, rx_pos):
    """Receiver ids referenced by the TDOA rows but absent from the
    coordinate config (stale pos-rx.cfg, extra receiver)."""
    return {int(r) for r in np.concatenate([tdoas["rx0"], tdoas["rx1"]])
            if int(r) not in rx_pos}


def solve_group(tdoas, rx_pos, weighted=False):
    """Bounded nonlinear least squares with the analytic Jacobian.

    With ``weighted``, residuals are scaled by sqrt(snr) normalized to
    unit mean -- TDOA noise variance goes as 1/SNR, so this is the
    maximum-likelihood weighting (resolves the reference's TODO at
    pos_est.py:59 "use SNR ... as weight").
    """
    dims = len(next(iter(rx_pos.values())))
    uniq = np.unique(np.concatenate([tdoas["rx0"], tdoas["rx1"]]))
    if len(uniq) < dims + 1:
        raise EstimationError("underdetermined")

    rx0, rx1 = _geometry(tdoas, rx_pos)
    coords = np.array(list(rx_pos.values()), dtype=np.float64)
    lo = coords.min(axis=0) - MAX_DIST
    hi = coords.max(axis=0) + MAX_DIST
    # Start at the receiver centroid: always inside the bounds box even
    # for projected coordinates far from the origin (a fixed origin
    # guess would make scipy reject the bounds).
    x0 = coords.mean(axis=0)
    measured = tdoas["tdoa"] * SPEED_OF_LIGHT
    if weighted:
        w = np.sqrt(np.maximum(tdoas["snr"], 1e-12))
        w = w / np.mean(w)
    else:
        w = np.ones(len(tdoas))

    def residuals(pos):
        d0 = np.linalg.norm(rx0 - pos, axis=1)
        d1 = np.linalg.norm(rx1 - pos, axis=1)
        return w * (measured - (d0 - d1))

    def jac(pos):
        p0, p1 = rx0 - pos, rx1 - pos
        d0 = np.linalg.norm(p0, axis=1)
        d1 = np.linalg.norm(p1, axis=1)
        return w[:, None] * (p0 / d0[:, None] - p1 / d1[:, None])

    res = scipy.optimize.least_squares(
        residuals, x0, jac=jac, bounds=(lo, hi))
    return res.x, float(np.mean(tdoas["snr"]))


def dop_matrix(pos, rx_pos, rx_pairs):
    """Covariance-shape matrix inv(G^T G) of the linearized geometry."""
    pos = np.asarray(pos, dtype=np.float64)
    rx0 = np.array([rx_pos[int(a)] for a, _ in rx_pairs], dtype=np.float64)
    rx1 = np.array([rx_pos[int(b)] for _, b in rx_pairs], dtype=np.float64)
    p0, p1 = rx0 - pos, rx1 - pos
    d0 = np.linalg.norm(p0, axis=1)
    d1 = np.linalg.norm(p1, axis=1)
    g = p0 / d0[:, None] - p1 / d1[:, None]
    try:
        return np.linalg.inv(g.T @ g)
    except np.linalg.LinAlgError:
        return None


def dop(pos, rx_pos, rx_pairs):
    """Dilution of precision: sqrt(trace(inv(G^T G))); -1 if singular."""
    m = dop_matrix(pos, rx_pos, rx_pairs)
    if m is None:
        return -1.0
    return float(np.sqrt(np.trace(m)))


def _dop_batched(positions, rx0, rx1, mask):
    """Vectorized DOP over padded groups; -1 where GtG is singular.

    Semantics match :func:`dop`: only an *exactly* singular /
    non-finite geometry reports -1 -- near-singular geometry returns
    the (huge) finite DOP so downstream weighting (e.g. the Kalman
    tracker's R = (std*dop)^2) de-weights the fix instead of trusting
    it.
    """
    p0 = rx0 - positions[:, None, :]
    p1 = rx1 - positions[:, None, :]
    d0 = np.maximum(np.linalg.norm(p0, axis=-1), 1e-12)
    d1 = np.maximum(np.linalg.norm(p1, axis=-1), 1e-12)
    g = (p0 / d0[..., None] - p1 / d1[..., None]) * mask[..., None]
    gtg = np.einsum("gpi,gpj->gij", g, g)
    with np.errstate(all="ignore"):
        dets = np.linalg.det(gtg)
    ok = np.isfinite(dets) & (dets != 0.0)
    dims = gtg.shape[-1]
    safe = np.where(ok[:, None, None], gtg, np.eye(dims))
    inv = np.linalg.inv(safe)
    traces = np.trace(inv, axis1=-2, axis2=-1)
    ok &= np.isfinite(traces) & (traces >= 0.0)
    return np.where(ok, np.sqrt(np.where(ok, traces, 1.0)), -1.0)


def solve(tdoa_groups, rx_pos, weighted=False, verbose=True):
    """Solve every TDOA group; returns a structured array of positions.

    ``verbose=False`` silences the per-group failure lines (see
    :func:`solve_batched`).
    """
    num_rx = len(rx_pos)
    dims = len(next(iter(rx_pos.values())))
    results = []
    for group in tdoa_groups:
        try:
            if num_rx == 2 and dims == 1:
                coords, snr = solve_1d(group.tdoas, rx_pos)
            else:
                coords, snr = solve_group(group.tdoas, rx_pos,
                                          weighted=weighted)
            pairs = list(zip(group.tdoas["rx0"], group.tdoas["rx1"]))
            dop_est = dop(coords, rx_pos, pairs)
            results.append(
                (group.group_id, group.timestamp, group.tx, dop_est, snr)
                + tuple(coords))
        except (EstimationError, ValueError, KeyError,
                np.linalg.LinAlgError) as e:
            # One pathological group must not abort the whole run.
            # (Both paths report unknown receivers as EstimationError;
            # KeyError stays caught as defense in depth for dop()'s
            # rx_pos lookups.)
            if verbose:
                print("Failed to estimate group #{}: {}".format(
                    group.group_id, e), file=sys.stderr)
    dtype = position_dtype(dims)
    if not results:
        return np.zeros(0, dtype=dtype)
    return np.array(results, dtype=dtype)


def save_positions(stream_or_path, results):
    """Write .pos lines: group_id timestamp tx dop snr x y [z]."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save_positions(f, results)
    for row in results:
        fields = list(row)
        fields[1] = "{:.6f}".format(fields[1])
        stream_or_path.write(" ".join(str(x) for x in fields) + "\n")


def load_positions(stream_or_path):
    import warnings

    with warnings.catch_warnings():
        # An empty .pos (no fixes yet) is a normal state, not a warning.
        warnings.filterwarnings(
            "ignore", message=".*Empty input file.*")
        data = np.genfromtxt(stream_or_path, dtype=np.float64)
    if data.size == 0:
        # Empty .pos (no fixes yet): 2-D layout by default.
        dims = 2
        dtype = position_dtype(dims)
        return np.zeros(0, dtype=dtype)
    data = np.atleast_2d(data)
    dims = data.shape[1] - 5
    dtype = position_dtype(dims)
    out = np.zeros(len(data), dtype=dtype)
    for i, name in enumerate(out.dtype.names):
        out[name] = data[:, i]
    return out


def solve_groups_batched(tdoa_padded, mask, rx0_pos, rx1_pos, bounds,
                         iters=25, damping=1e-2, weights=None,
                         device="cuda"):
    """Batched multi-start Levenberg-Marquardt multilateration.

    All arrays are padded to [G, Pmax]: ``tdoa_padded`` in seconds,
    ``mask`` marks valid pairs, ``rx0_pos``/``rx1_pos`` are [G, Pmax, D]
    receiver coordinates, ``bounds`` = (lo [D], hi [D]); ``weights``
    ([G, Pmax]) scales residual and Jacobian rows.  Returns positions
    [G, D] as float64 numpy.

    K = 2^D + 1 starts per group (the centroid of the used receiver
    pairs' midpoints and the corners of their bounding box inflated
    1.5x, which straddle the mirror line/plane of a (near-)collinear or
    coplanar array); ``iters`` steps each with per-start damping
    lambda (x0.25 on an accepted step, x8 on a rejected one, clipped to
    [1e-9, 1e9]) on ``diag(J^T J) + 1e-9``; candidates clipped to the
    bounds; distances floored at 1e-6; the start with the lowest
    weighted residual wins.
    """
    pos, score = _solve_starts(tdoa_padded, mask, rx0_pos, rx1_pos, bounds,
                               iters, damping, weights, as_device(device))
    dims = pos.shape[-1]
    best = torch.argmin(score, dim=1)
    out = torch.gather(pos, 1, best[:, None, None].expand(-1, 1, dims))
    return out[:, 0].cpu().numpy()


def _solve_starts(tdoa_padded, mask, rx0_pos, rx1_pos, bounds, iters,
                  damping, weights, dev):
    """Every start's final position [G, K, D] and weighted squared
    residual [G, K] (where two mirror minima have equal residual to the
    last digits, which one wins depends on float64 rounding; this shows
    both)."""

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    measured = f64(tdoa_padded) * SPEED_OF_LIGHT
    mask_f = f64(mask)
    wgt = mask_f if weights is None else f64(weights) * mask_f
    r0, r1 = f64(rx0_pos), f64(rx1_pos)
    lo, hi = f64(bounds[0]), f64(bounds[1])
    dims = r0.shape[-1]

    def residuals(pos):
        p0 = r0[:, None] - pos[:, :, None, :]
        p1 = r1[:, None] - pos[:, :, None, :]
        d0 = torch.clamp(torch.linalg.vector_norm(p0, dim=-1), min=1e-6)
        d1 = torch.clamp(torch.linalg.vector_norm(p1, dim=-1), min=1e-6)
        resid = (measured[:, None] - (d0 - d1)) * wgt[:, None]
        return resid, p0, p1, d0, d1

    # Starts: centroid of the used pairs' midpoints and the inflated
    # corners of their bounding box.
    denom = torch.clamp(torch.sum(mask_f, dim=-1), min=1.0)[..., None]
    mids = 0.5 * (r0 + r1)
    used = mask_f[..., None] > 0
    centroid = torch.sum(mids * mask_f[..., None], dim=1) / denom
    rx_hi = torch.amax(torch.where(used, mids, -torch.inf), dim=1)
    rx_lo = torch.amin(torch.where(used, mids, torch.inf), dim=1)
    starts = [centroid]
    for c in range(1 << dims):
        corner = torch.stack(
            [rx_hi[:, d] if (c >> d) & 1 else rx_lo[:, d]
             for d in range(dims)], dim=-1)
        starts.append(centroid + 1.5 * (corner - centroid))
    pos = torch.clamp(torch.stack(starts, dim=1), lo, hi)
    lam = torch.full(pos.shape[:2], damping, dtype=torch.float64,
                     device=dev)
    eye = torch.eye(dims, dtype=torch.float64, device=dev)

    for _ in range(iters):
        resid, p0, p1, d0, d1 = residuals(pos)
        cost = torch.sum(resid * resid, dim=-1)
        jac = (p0 / d0[..., None] - p1 / d1[..., None]) \
            * wgt[:, None, :, None]
        jtj = torch.einsum("gkpi,gkpj->gkij", jac, jac)
        diag = torch.diagonal(jtj, dim1=-2, dim2=-1)
        jtj = jtj + lam[..., None, None] * (diag + 1e-9)[..., None] * eye
        jtr = torch.einsum("gkpi,gkp->gki", jac, resid)
        # jac is d(residual)/d(pos): the step is pos - (J^T J)^-1 J^T r.
        # solve_ex: no host sync, and a singular system gives non-finite
        # candidates that are rejected, as in JAX.
        delta = torch.linalg.solve_ex(jtj, jtr[..., None])[0][..., 0]
        cand = torch.clamp(pos - delta, lo, hi)
        cand_resid = residuals(cand)[0]
        accept = torch.sum(cand_resid * cand_resid, dim=-1) < cost
        pos = torch.where(accept[..., None], cand, pos)
        lam = torch.clamp(torch.where(accept, lam * 0.25, lam * 8.0),
                          1e-9, 1e9)

    resid = residuals(pos)[0]
    return pos, torch.sum(resid * resid, dim=-1)


def solve_batched(tdoa_groups, rx_pos, iters=30, weighted=False,
                  verbose=True, device="cuda"):
    """Solve many TDOA groups at once with :func:`solve_groups_batched`
    on ``device``; DOP and SNR are filled in on the host.  Groups with
    unknown receivers or too few receivers are skipped (reported unless
    ``verbose=False``), like JAX ``solve_batched``.  With ``weighted``,
    residuals are scaled by sqrt(SNR) normalised to unit mean per group.
    The host preparation is JAX ``solve_batched``'s; it is repeated here
    because that function calls its own (jax) solver.
    """
    dims = len(next(iter(rx_pos.values())))
    usable = []
    for g in tdoa_groups:
        missing = _missing_receivers(g.tdoas, rx_pos)
        if missing:
            if verbose:
                print("Failed to estimate group #{}: receiver(s) {} not "
                      "in coordinate config".format(
                          g.group_id, sorted(missing)), file=sys.stderr)
            continue
        uniq = np.unique(np.concatenate([g.tdoas["rx0"], g.tdoas["rx1"]]))
        if len(uniq) >= dims + 1:
            usable.append(g)
        elif verbose:
            print("Failed to estimate group #{}: underdetermined".format(
                g.group_id), file=sys.stderr)
    dtype = position_dtype(dims)
    if not usable:
        return np.zeros(0, dtype=dtype)

    pmax = max(len(g.tdoas) for g in usable)
    n = len(usable)
    tdoa_pad = np.zeros((n, pmax))
    mask = np.zeros((n, pmax), dtype=bool)
    weights = np.zeros((n, pmax))
    rx0 = np.zeros((n, pmax, dims))
    rx1 = np.zeros((n, pmax, dims))
    for i, g in enumerate(usable):
        k = len(g.tdoas)
        tdoa_pad[i, :k] = g.tdoas["tdoa"]
        mask[i, :k] = True
        if weighted:
            w = np.sqrt(np.maximum(g.tdoas["snr"], 1e-12))
            weights[i, :k] = w / np.mean(w)
        else:
            weights[i, :k] = 1.0
        rx0[i, :k] = [rx_pos[int(a)] for a in g.tdoas["rx0"]]
        rx1[i, :k] = [rx_pos[int(b)] for b in g.tdoas["rx1"]]
        # Padded pairs reuse the first pair's geometry (masked anyway,
        # but keeps the Jacobian finite).
        rx0[i, k:] = rx0[i, 0]
        rx1[i, k:] = rx1[i, 0]

    coords = np.array(list(rx_pos.values()), dtype=np.float64)
    bounds = (coords.min(axis=0) - MAX_DIST, coords.max(axis=0) + MAX_DIST)
    positions = solve_groups_batched(
        tdoa_pad, mask, rx0, rx1, bounds, iters=iters,
        weights=weights if weighted else None, device=device)
    dops = _dop_batched(positions, rx0, rx1, mask)
    results = [(g.group_id, g.timestamp, g.tx, dops[i],
                float(np.mean(g.tdoas["snr"]))) + tuple(positions[i])
               for i, g in enumerate(usable)]
    return np.array(results, dtype=dtype)


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("tdoa", nargs="?", type=str, default="data.tdoa")
    parser.add_argument("-o", "--output", type=str, default="data.pos")
    parser.add_argument("-r", "--rx-coordinates", dest="rx_pos",
                        type=str, default="pos-rx.cfg")
    parser.add_argument("--weighted", action="store_true",
                        help="weight residuals by sqrt(SNR)")
    parser.add_argument("--batched", action="store_true",
                        help="solve all groups at once with the batched "
                             "solver on --device (high fix rates)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES),
                        help="where the --batched solver runs; 'cuda' "
                             "fails when no card is available "
                             "[default: cuda]")
    args = parser.parse_args(argv)

    device = resolve_device(args.device) if args.batched else None
    groups = tdoa_mod.load_tdoa_groups(
        sys.stdin if args.tdoa == "-" else args.tdoa)
    rx_pos = tdoa_mod.load_pos_config(args.rx_pos)
    if args.batched:
        results = solve_batched(groups, rx_pos, weighted=args.weighted,
                                device=device)
    else:
        results = solve(groups, rx_pos, weighted=args.weighted)
    print("Estimated {} position(s)".format(len(results)))
    if args.output == "-":
        save_positions(sys.stdout, results)
    else:
        save_positions(args.output, results)


if __name__ == "__main__":
    sys.exit(_main())
