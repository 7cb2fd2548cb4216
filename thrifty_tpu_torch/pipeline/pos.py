"""Position estimation from TDOA values on the port (counterpart of
``thrifty_tpu.pipeline.pos``).

The host solvers (:func:`solve`, :func:`solve_group`, :func:`solve_1d`,
:func:`dop`) and the ``.pos`` I/O are the JAX package's numpy/scipy
functions, reused by import; that module imports jax only inside its
batched solver, which the port never calls.

:func:`solve_groups_batched` is the batched multi-start
Levenberg-Marquardt solver in torch, float64 throughout, on an explicit
``device``: the JAX solver (``pos.py:291-383``) step for step.  Groups
are padded to the largest pair count only: eager torch has no compiled
program per shape, so the JAX power-of-two shape buckets are dropped
(padding pairs and groups do not change a result; tested).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from thrifty_tpu.pipeline import tdoa as tdoa_mod
from thrifty_tpu.pipeline.pos import (  # noqa: F401  (re-exported)
    MAX_DIST, SPEED_OF_LIGHT, EstimationError, _dop_batched,
    _missing_receivers, dop, load_positions, position_dtype, save_positions,
    solve, solve_1d, solve_group)
from thrifty_tpu_torch.device import DEVICES, resolve_device


def solve_groups_batched(tdoa_padded, mask, rx0_pos, rx1_pos, bounds,
                         iters=25, damping=1e-2, weights=None,
                         device="cpu"):
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
                               iters, damping, weights, torch.device(device))
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
                  verbose=True, device="cpu"):
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
