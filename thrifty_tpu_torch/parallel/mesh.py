"""An (rx, time) grid of ranks for sharded detection (counterpart of
thrifty_tpu.parallel.mesh).

The workload's two parallel axes (SURVEY.md section 2.4):

- ``rx``: receivers are independent until matchmaking -- a pure data
  parallel axis (the reference runs receivers on separate machines).
- ``time``: the sample stream is split into overlap-save blocks; blocks
  are independent given a history halo -- the time axis shards across
  ranks with a halo exchange (the reference's block decomposition,
  thrifty/block_data.py:70-98).

Where the JAX package lays out devices, the port lays out the ranks of a
``torch.distributed`` world, one process each: rank ``r*T + t`` of the
mesh's rank list sits at ``(r, t)``, rx outer, so the time-halo exchange
(the frequent collective) stays between neighbouring ranks, which a
launcher puts on one host.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from thrifty_tpu_torch.device import as_device

AXIS_RX = "rx"
AXIS_TIME = "time"


def rank_grid(num_rx, num_time, ranks):
    """The [num_rx, num_time] grid of ``ranks`` (rx outer); ``num_time``
    None takes every rank.  Raises the JAX ``make_mesh``'s errors."""
    n = len(ranks)
    if num_time is None:
        if n % num_rx:
            raise ValueError("device count not divisible by num_rx")
        num_time = n // num_rx
    if num_rx * num_time > n:
        raise ValueError(
            "mesh ({} x {}) larger than device count {}".format(
                num_rx, num_time, n))
    return np.asarray(ranks[: num_rx * num_time], dtype=np.int64).reshape(
        num_rx, num_time)


class RankMesh:
    """An (rx, time) grid of ``torch.distributed`` ranks.

    ``shape`` is ``{"rx": R, "time": T}`` as the JAX mesh's; ``grid`` the
    [R, T] global ranks; ``rank`` this process's rank (0 without a world);
    ``device`` the device this rank computes on.  ``time_group`` is the
    process group of this rank's rx row (its time axis) and ``rx_group``
    that of its time column; both are None without a world or for a rank
    outside the mesh.
    """

    def __init__(self, grid, rank, device, time_group=None, rx_group=None):
        self.grid = grid
        self.rank = rank
        self.device = device
        self.time_group = time_group
        self.rx_group = rx_group

    @property
    def shape(self):
        return {AXIS_RX: self.grid.shape[0], AXIS_TIME: self.grid.shape[1]}

    @property
    def size(self):
        return self.grid.size

    def coords(self, rank=None):
        """(r, t) of ``rank`` (default: this process's), None for a rank
        outside the mesh."""
        rank = self.rank if rank is None else rank
        hit = np.argwhere(self.grid == rank)
        return None if not len(hit) else (int(hit[0][0]), int(hit[0][1]))

    @property
    def member(self):
        """Is this process one of the mesh's ranks?"""
        return self.coords() is not None


def make_mesh(num_rx: int = 1, num_time: int = None, devices=None,
              device="cuda") -> RankMesh:
    """Build an (rx, time) mesh over ranks.

    ``devices``: the ranks to lay out (default every rank of the
    initialised world, or ``[0]`` without one); the mesh takes the first
    ``num_rx * num_time`` of them.  ``num_time`` defaults to
    ``len(devices) // num_rx``.  The rx axis is the outer axis.
    ``device``: where this rank computes (``"cuda"`` is the card that
    ``torch.cuda.set_device`` chose, see ``distributed.initialize``).

    In a world, every rank must call this with the same arguments: each
    creates every row's and column's process group, in the same order
    (``dist.new_group``), and keeps those it belongs to.  A rank outside
    the mesh keeps none and never joins the mesh's collectives.
    """
    world = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size())) if world else [0]
    grid = rank_grid(num_rx, num_time, list(devices))
    rank = dist.get_rank() if world else 0
    mesh = RankMesh(grid, rank, as_device(device))
    if world:
        if grid.max() >= dist.get_world_size() or grid.min() < 0:
            raise ValueError("mesh ranks {} outside the world of {}".format(
                grid.ravel().tolist(), dist.get_world_size()))
        here = mesh.coords()
        for r in range(grid.shape[0]):
            group = dist.new_group(grid[r].tolist())
            if here is not None and here[0] == r:
                mesh.time_group = group
        for t in range(grid.shape[1]):
            group = dist.new_group(grid[:, t].tolist())
            if here is not None and here[1] == t:
                mesh.rx_group = group
    return mesh
