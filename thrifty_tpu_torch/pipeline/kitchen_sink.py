"""In-process full pipeline on the port: detect everything, then
identify -> match -> tdoa -> pos (counterpart of
``thrifty_tpu.pipeline.kitchen_sink``, reference
thrifty/kitchen_sink.py:42-87).

:func:`detect_all` drives the port's ``BatchDetector`` through
:func:`detect_blocks` (one batch in flight, each ``PendingBatch``
resolved where it is copied back); :func:`postdetect`
runs the port's numpy stages (copies of the JAX package's) and its
``pos``.  Every stage is injectable; pass
``pos_estimator=functools.partial(pos.solve_batched, device=...)`` for
the batched solver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from thrifty_tpu_torch.io import card, toad
from thrifty_tpu_torch.pipeline import identify as identify_mod
from thrifty_tpu_torch.pipeline import matchmaker as matchmaker_mod
from thrifty_tpu_torch.pipeline import tdoa as tdoa_mod
from thrifty_tpu_torch.pipeline import pos as pos_mod


@dataclasses.dataclass
class PostdetectSettings:
    freqmap: Optional[dict]
    match_window: float
    tdoa_est_window: float
    rx_pos: dict
    beacon_pos: dict
    sample_rate: float
    # txids already assigned upstream (detect_all's txid_from_template,
    # a code-division template bank): keep them and dedup across codes
    # instead of re-classifying by carrier bin.
    keep_txid: bool = False


@dataclasses.dataclass
class PostdetectResult:
    toads: np.ndarray
    matches: list
    tdoas: list
    pos: np.ndarray


def detect_blocks(detector, blocks, batch_size: int = 256):
    """The detector's outputs for every block of ``blocks`` [B, N], as
    numpy arrays [B].

    Complex blocks go to the detector's device in fixed-size batches,
    the tail padded with silence (dropped from the output); one batch
    stays in flight and is resolved (``PendingBatch.result()``) and
    copied back while the next is queued.  The detector treats each
    block on its own, so the outputs are those of one call on all of
    ``blocks``.
    """
    blocks = np.asarray(blocks, dtype=np.complex64)
    parts = []
    pending = None
    for i in range(0, len(blocks), batch_size):
        chunk = blocks[i:i + batch_size]
        n = len(chunk)
        if n < batch_size:
            chunk = np.concatenate([chunk, np.zeros(
                (batch_size - n, blocks.shape[1]), np.complex64)])
        batch = detector.submit(chunk)
        if pending is not None:
            parts.append(_copy_back(*pending))
        pending = (batch, n)
    if pending is not None:
        parts.append(_copy_back(*pending))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _copy_back(batch, n):
    return {k: v.cpu().numpy()[:n] for k, v in batch.result().items()}


def detect_all(cards, detector, batch_size: int = 256,
               txid_from_template: bool = False):
    """Detect on several receivers' captures with the port's detector.

    ``cards``: {rxid: .card path | (timestamps, indices, blocks)}, each
    through :func:`detect_blocks`.  Returns the merged detections; txids
    are unassigned unless ``txid_from_template`` maps the winning bank
    template to the txid.
    """
    parts = []
    for rxid, capture in cards.items():
        if isinstance(capture, str):
            ts, idx, blocks = card.read_card_blocks(capture)
        else:
            ts, idx, blocks = capture
        if not len(ts):
            continue
        out = detect_blocks(detector, blocks, batch_size)
        soa = detector.soa(idx, out["corr_sample"], out["corr_offset"])
        parts.append(toad.from_detector_output(
            ts, idx, soa, out, rxid=rxid,
            txid_from_template=txid_from_template))
    if not parts:
        return toad.empty(0)
    return np.concatenate(parts)


def postdetect(
    detections,
    settings: PostdetectSettings,
    integrator: Callable = identify_mod.integrate,
    matcher: Callable = matchmaker_mod.match_detections,
    tdoa_estimator: Callable = tdoa_mod.estimate_tdoas,
    pos_estimator: Callable = pos_mod.solve,
):
    """Identify, match, estimate TDOAs, estimate positions."""
    if settings.keep_txid and integrator is identify_mod.integrate:
        toads = integrator(detections, settings.freqmap,
                           keep_txid=True, dedup_any_tx=True)
    else:
        toads = integrator(detections, settings.freqmap)
    matches, _, _ = matcher(toads, settings.match_window)
    tdoas, _ = tdoa_estimator(
        toads, matches, settings.tdoa_est_window,
        settings.beacon_pos, settings.rx_pos, settings.sample_rate)
    positions = pos_estimator(tdoas, settings.rx_pos)
    return PostdetectResult(
        toads=toads, matches=matches, tdoas=tdoas, pos=positions)
