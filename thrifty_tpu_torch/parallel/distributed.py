"""Multi-process runtime initialisation and the pod-level mesh
(counterpart of thrifty_tpu.parallel.distributed), on
``torch.distributed``.

The JAX package runs one process per host, each holding several chips;
PyTorch runs one process per card.  :func:`initialize` joins this
process to the world (the coordinator's address, the world size and
this process's rank, or torchrun's environment) and picks its card;
:func:`pod_mesh` lays the world out with one rx row per host, so the
frequent collective -- the 4920-sample history halo between
time-neighbouring ranks -- stays between the cards of one host, while
the rx axis crosses hosts only for the final detection all-gather.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from thrifty_tpu_torch.device import resolve_device
from thrifty_tpu_torch.parallel.mesh import make_mesh

# The messages torch.distributed has used for a second initialisation
# of the default process group.
_REPEAT_INIT = ("twice", "already initialized")


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, device="cuda", **kwargs):
    """Join the ``torch.distributed`` world (idempotent wrapper).

    ``coordinator_address`` ``"host:port"`` becomes ``tcp://host:port``;
    an ``init_method`` (e.g. ``file://...``) may be passed instead.
    ``num_processes`` is the world size and ``process_id`` this rank;
    with no arguments torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) is read.

    ``device="cuda"`` (the default) computes on a card: the backend
    defaults to ``nccl`` and this rank's card is ``LOCAL_RANK`` (modulo
    the cards present, so ranks may share one); a missing card raises.
    ``device="cpu"`` defaults the backend to ``gloo``.  ``backend`` is
    never switched quietly: ``gloo`` with ``device="cuda"`` computes on
    the card (several ranks may share one; NCCL refuses that) and stages
    the halo through host memory (``sharded._p2p_wire``).

    Returns at once when the world is already initialised; a repeat
    initialisation by a racing caller is swallowed, any other failure
    raised.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = process_id if process_id is not None \
                else os.environ.get("RANK", 0)
        card = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            # NCCL binds the rank to its card up front instead of
            # guessing it from the rank.
            kwargs.setdefault("device_id", card)
    if coordinator_address is not None:
        if "init_method" in kwargs:
            raise ValueError("pass coordinator_address or init_method, "
                             "not both")
        kwargs["init_method"] = "tcp://" + coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (RuntimeError, ValueError) as e:
        # Only repeat-initialisation is ok.
        if not any(phrase in str(e) for phrase in _REPEAT_INIT):
            raise  # genuinely failed


def pod_mesh(num_rx=None, device="cuda"):
    """Build the (rx, time) mesh over every rank of the world.

    By default one rx row per host (receivers feed hosts): the world
    size over ``LOCAL_WORLD_SIZE``, the ranks of one host (torchrun sets
    it; without it the world is one host).  Each host's ranks form the
    time axis.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_rx is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_rx = max(world // per_host, 1)
    return make_mesh(num_rx=num_rx, device=device)


def is_coordinator() -> bool:
    """True on the process that should write merged outputs: rank 0, or
    the only process when no world is initialised."""
    return not dist.is_initialized() or dist.get_rank() == 0
