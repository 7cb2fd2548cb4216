"""Sharded detection over an (rx, time) grid of ranks (counterpart of
thrifty_tpu.parallel.sharded), on ``torch.distributed``.

Two levels of parallel execution, replacing the reference's
process/machine-level distribution (SURVEY.md section 2.4):

1. :func:`batch_detect_sharded` -- blocks already carry their history
   halo (e.g. read from a .card file), so the batch axis is
   embarrassingly parallel: each rank detects its slice of [B, N] and
   the outputs are all-gathered.

2. :func:`make_stream_detector` -- each rank holds a *contiguous chunk
   of new samples* of its receivers' streams; the 4920-sample history
   halo comes from the rank holding the previous stretch of time in one
   ``dist.batch_isend_irecv`` (the JAX package's ``lax.ppermute``, the
   collective analog of fastcard's memcpy of the previous block's tail,
   fastcard/raw_reader.c:22-30), then each rank unfolds its chunk into
   overlapped blocks on its device and runs the port's batched detector
   there (the power/peak kernel on a card).  Detections can be
   all-gathered for matchmaking (the reference ships .toad files to a
   server; here it is two collectives).

Every rank runs the same program on its own chunk.  The detection table
travels as one int32 tensor (each field's 4-byte words; bools as 0/1),
so a gather is one collective per mesh axis.  NCCL moves the halo and
the table between cards.  Gloo's ``all_gather`` takes CUDA tensors, but
its point-to-point ops read them as host memory (torch 2.11: gloo aborts
with "writev: Bad address"), so over gloo the halo is staged through a
host copy (:func:`_p2p_wire`); the detect stays on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from thrifty_tpu_torch.dsp import unfold as unfold_mod
from thrifty_tpu_torch.parallel.mesh import AXIS_RX, AXIS_TIME


def _coords(mesh):
    """(r, t) of this rank; raises for a rank outside the mesh or a
    mesh of several ranks without a world to reach them."""
    here = mesh.coords()
    if here is None:
        raise ValueError("rank {} is not in the mesh {}".format(
            mesh.rank, mesh.grid.ravel().tolist()))
    if mesh.size > 1 and (mesh.time_group is None or mesh.rx_group is None):
        raise ValueError("a mesh of {} ranks needs the torch.distributed "
                         "world it was made in".format(mesh.size))
    return here


def _p2p_wire(group, x):
    """``x`` as the group's backend sends and receives it point to
    point: over gloo a CUDA tensor is staged through a host copy; NCCL
    and CPU tensors move as they are."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def _exchange_halo(tail, mesh):
    """The previous time rank's ``tail`` [rx_local, history], sent as
    this rank sends its own to the next one in one batch of
    point-to-point ops (every rank posts both of its ops together, so
    no ordering can deadlock).  Time rank 0 gets zeros, as
    ``lax.ppermute`` leaves them."""
    r, t = _coords(mesh)
    num_time = mesh.shape[AXIS_TIME]
    halo = torch.zeros_like(tail)
    if num_time == 1 or tail.numel() == 0:
        return halo
    group = mesh.time_group
    send = torch.view_as_real(_p2p_wire(group, tail.contiguous()))
    recv = _p2p_wire(group, halo)
    ops = []
    if t + 1 < num_time:
        ops.append(dist.P2POp(dist.isend, send, int(mesh.grid[r, t + 1]),
                              group))
    if t > 0:
        ops.append(dist.P2POp(dist.irecv, torch.view_as_real(recv),
                              int(mesh.grid[r, t - 1]), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(tail.device)


def _local_detect(detector, chunk, halo, t, blocks_per_shard):
    """One rank's detect: ``chunk`` [rx_local, blocks_per_shard*new_len]
    new samples of time rank ``t``, ``halo`` [rx_local, history] the
    samples before them -> output dict of [rx_local, blocks_per_shard]
    tensors with the global ``block_idx``.  The gate's overflow flag is
    resolved here (``PendingBatch.result()``), before any collective."""
    cfg = detector.config
    n = cfg.block_len
    rx_local = chunk.shape[0]
    full = torch.cat([halo, chunk], dim=1)
    # Overlap-save unfold on the rank's device (dsp/unfold.overlap_rows).
    blocks = unfold_mod.overlap_rows(full, n, cfg.history_len)
    out = detector.submit(
        blocks.reshape(rx_local * blocks_per_shard, n)).result()
    out = {k: v.reshape(rx_local, blocks_per_shard) for k, v in out.items()}
    # Global block index of each local block.
    block_idx = t * blocks_per_shard + torch.arange(
        blocks_per_shard, dtype=torch.int32, device=chunk.device)
    out["block_idx"] = block_idx.expand(rx_local, blocks_per_shard).clone()
    return out


def _pack(out):
    """Output dict of [a, b] tensors -> (names, dtypes, int32 [F, a, b])."""
    names = list(out)
    words = []
    for k in names:
        v = out[k]
        if v.dtype == torch.bool:
            words.append(v.to(torch.int32))
        elif v.element_size() == 4:
            words.append(v.contiguous().view(torch.int32))
        else:
            raise TypeError("{} is {}: the table moves 4-byte words".format(
                k, v.dtype))
    return names, [out[k].dtype for k in names], torch.stack(words)


def _unpack(names, dtypes, packed):
    return {k: packed[i] != 0 if dt == torch.bool else packed[i].view(dt)
            for i, (k, dt) in enumerate(zip(names, dtypes))}


def _all_gather(x, group, ranks, dim):
    """Concatenate every rank's ``x`` along ``dim`` in the order of
    ``ranks`` (global ranks along the mesh axis)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x, group=group)
    return torch.cat([parts[dist.get_group_rank(group, int(g))]
                      for g in ranks], dim=dim)


def _gather_table(out, mesh):
    """Every rank's [a, b] output dict -> the [R*a, T*b] table on every
    rank: all-gather over time (dim 1), then over rx (dim 0)."""
    r, t = _coords(mesh)
    names, dtypes, packed = _pack(out)
    if mesh.time_group is not None:
        packed = _all_gather(packed, mesh.time_group, mesh.grid[r], 2)
        packed = _all_gather(packed, mesh.rx_group, mesh.grid[:, t], 1)
    return _unpack(names, dtypes, packed)


def batch_detect_sharded(detector, mesh):
    """Detection with the block axis sharded over every rank of the mesh.

    Returns a function blocks [B, N] -> output dict of [B] tensors on
    the detector's device.  Every rank passes the same ``blocks``
    (numpy or tensor); rank ``k = r*T + t`` detects rows ``k*B/W`` to
    ``(k+1)*B/W`` (JAX's ``P((rx, time))`` order, W ranks) and the
    outputs are all-gathered, so every rank returns the whole batch.
    Each block carries its own halo: no other communication.
    """
    num_time = mesh.shape[AXIS_TIME]

    def fn(blocks):
        r, t = _coords(mesh)
        total = blocks.shape[0]
        if total % mesh.size:
            raise ValueError("batch of {} blocks does not split over {} "
                             "ranks".format(total, mesh.size))
        per = total // mesh.size
        slot = r * num_time + t
        out = detector.submit(blocks[slot * per:(slot + 1) * per]).result()
        table = _gather_table({k: v[None] for k, v in out.items()}, mesh)
        return {k: v.reshape(-1) for k, v in table.items()}

    return fn


def make_stream_detector(detector, num_rx, blocks_per_shard, mesh,
                         gather=False):
    """Build the halo-exchange streaming detector for this rank.

    The returned function takes this rank's chunk (:func:`shard_stream`)
    of the raw contiguous sample streams ``[R, T*blocks_per_shard*
    new_len]`` complex64 (new samples only, no halos): ``[R/num_rx,
    blocks_per_shard*new_len]``, so a rank may hold several receivers'
    rows.  It returns the detector's output dict of ``[R/num_rx,
    blocks_per_shard]`` tensors with the global ``block_idx``, or with
    ``gather=True`` the ``[R, T*blocks_per_shard]`` table on every rank
    (the detect->server edge).  Every rank of the mesh must call it
    once per chunk, in step.
    """
    cfg = detector.config
    n = cfg.block_len
    history = cfg.history_len
    new_len = n - history
    if mesh.shape[AXIS_RX] != num_rx:
        raise ValueError("mesh rx axis ({}) != num_rx ({})".format(
            mesh.shape[AXIS_RX], num_rx))
    if blocks_per_shard < 1:
        raise ValueError("blocks_per_shard must be >= 1")
    if history > new_len:
        # (This also guarantees history <= the per-shard chunk, since
        # chunk_len = blocks_per_shard * new_len >= new_len.)
        raise ValueError(
            "history ({}) exceeds new samples per block ({}): the "
            "unique-lag window would be empty".format(history, new_len))
    chunk_len = blocks_per_shard * new_len

    def fn(chunk):
        _, t = _coords(mesh)
        chunk = torch.as_tensor(chunk).to(detector.device, torch.complex64)
        if chunk.dim() != 2 or chunk.shape[1] != chunk_len:
            raise ValueError("chunk must be [rx_local, {}], got {}".format(
                chunk_len, tuple(chunk.shape)))
        # Explicit start offset: `[:, -history:]` with history 0 would
        # select the WHOLE chunk as the halo.
        tail = chunk[:, chunk.shape[1] - history:]
        halo = _exchange_halo(tail, mesh)
        out = _local_detect(detector, chunk, halo, t, blocks_per_shard)
        return _gather_table(out, mesh) if gather else out

    return fn


def make_stream_detector_gspmd(detector, total_blocks, mesh):
    """The streaming detector under the JAX GSPMD variant's signature.

    JAX writes this program as one global jit with sharding annotations
    and lets XLA's SPMD partitioner insert the halo exchange.  PyTorch
    has no such partitioner, so this is :func:`make_stream_detector`'s
    rank program with ``blocks_per_shard = total_blocks / T`` and the
    ``gather=False`` layout: each rank passes its chunk of the
    ``[R, total_blocks*new_len]`` streams and gets its ``[R/num_rx,
    total_blocks/T]`` slice of the output (``block_idx`` global).

    Under a gate (``gate_capacity``) the capacity then applies to each
    rank-local batch, where XLA applies it to the global batch; the
    decisions are the same either way, because a batch that overflows
    its capacity re-runs its correlation in full.
    """
    num_time = mesh.shape[AXIS_TIME]
    if total_blocks % num_time:
        raise ValueError("total_blocks ({}) does not split over the time "
                         "axis ({})".format(total_blocks, num_time))
    # make_stream_detector raises for history > new_len, as JAX's does.
    return make_stream_detector(detector, mesh.shape[AXIS_RX],
                                total_blocks // num_time, mesh)


def shard_stream(streams, mesh):
    """This rank's contiguous ``[R/num_rx, L/T]`` slice of the global
    ``[R, L]`` streams (numpy or tensor) that every rank holds, as
    complex64 on the mesh's device (the pod dataflow: each host feeds
    the receivers it serves; the full array stands in for deterministic
    streams)."""
    r, t = _coords(mesh)
    num_rx, num_time = mesh.shape[AXIS_RX], mesh.shape[AXIS_TIME]
    rows, length = streams.shape
    if rows % num_rx or length % num_time:
        raise ValueError("streams {} do not split over the mesh {}".format(
            tuple(streams.shape), mesh.shape))
    rr, ll = rows // num_rx, length // num_time
    part = streams[r * rr:(r + 1) * rr, t * ll:(t + 1) * ll]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part,
                                                     dtype=np.complex64))
    return part.to(mesh.device, torch.complex64)
