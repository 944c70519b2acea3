"""Multi-process slices over ``torch.distributed``.

The reference system scales like volunteers do: many independent clients.
A slice is several processes that act as ONE very large volunteer:
process 0 alone talks to the server, every process cracks its share of
each work unit on its own device, and the processes agree through a few
host-side collectives.

Every collective of a slice carries host data only — a hits-gate scalar,
lengths, JSON bytes, hit columns and candidate bytes — so a slice runs on
the ``gloo`` backend, with a ``timeout`` so that a stranded peer fails
instead of hanging.  No device tensor crosses processes: each process
fetches what it shares to the host first.  That also lets two processes
share one card (NCCL cannot put two ranks on one device).

``process_count()`` / ``process_index()`` are the slice's size and this
process's rank: 1 and 0 when no group is initialized.  The ``*_host``
helpers are the fixed-shape collectives on numpy arrays that the engine,
the client and ``obs.multihost`` build on; every process must reach each
of them with equal shapes, in the same order.
"""

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device

#: Seconds a collective (or the rendezvous) waits for a peer before it
#: raises.  Long enough for process 0's server calls and dict downloads
#: between two collectives; a peer that died never answers, so the
#: others fail within it rather than hang.
SLICE_TIMEOUT_S = 1800.0

#: environment variables an ``env://`` rendezvous (``--multihost``) reads
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Slice:
    """This process's place in a slice: its rank, the slice's size and
    the device this process cracks on."""

    rank: int
    size: int
    device: torch.device


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in this slice (1 without an initialized group)."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank in the slice (0 without a group)."""
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def multihost_mesh(coordinator: str = None, num_processes: int = None,
                   process_id: int = None, auto_init: bool = False,
                   device=None, timeout_s: float = SLICE_TIMEOUT_S) -> Slice:
    """Join (once) the slice's process group and describe this process.

    ``coordinator`` (``host:port``) with ``num_processes`` and
    ``process_id`` joins through ``tcp://`` (process 0 serves the
    rendezvous there); ``auto_init`` alone joins through ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them).  The backend is gloo: the slice's
    collectives carry host data only.  A rendezvous or a later
    collective that gets no answer within ``timeout_s`` raises; there is
    no single-process fallback.  ``device`` (default ``cuda:0``) is
    where this process cracks: compute never moves to the CPU unless
    the caller names it.
    """
    import torch.distributed as dist

    manual = (coordinator, num_processes, process_id)
    if (auto_init or any(v is not None for v in manual)) and not _initialized():
        timeout = datetime.timedelta(seconds=float(timeout_s))
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and process_id")
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=timeout)
        else:
            missing = [v for v in ENV_VARS if v not in os.environ]
            if missing:
                raise RuntimeError(
                    f"env:// rendezvous needs {', '.join(missing)} in the "
                    "environment (or pass a coordinator)")
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timeout)
    return Slice(rank=process_index(), size=process_count(),
                 device=resolve_device(device))


def leave_slice():
    """COLLECTIVE: wait for every process at a barrier, then tear the
    process group down.  Call it before a slice's process exits: a gloo
    group left to interpreter shutdown can abort the process while a
    peer still talks to it."""
    import torch.distributed as dist

    if _initialized():
        dist.barrier()
        dist.destroy_process_group()


def allgather_host(arr) -> np.ndarray:
    """COLLECTIVE: every process's equal-shaped numpy ``arr``, stacked in
    rank order -> ``[nproc, *arr.shape]`` (the ``process_allgather`` of
    the JAX package's multi-host helpers)."""
    import torch.distributed as dist

    a = np.ascontiguousarray(arr)
    if process_count() == 1:
        return a[None]
    t = _as_bytes(a)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([_from_bytes(o, a) for o in out])


def broadcast_host(arr) -> np.ndarray:
    """COLLECTIVE: process 0's numpy ``arr`` on every process (each
    passes an array of the same shape and dtype)."""
    import torch.distributed as dist

    a = np.ascontiguousarray(arr)
    if process_count() == 1:
        return a.copy()
    t = _as_bytes(a)
    dist.broadcast(t, src=0)
    return _from_bytes(t, a)


def _as_bytes(a) -> torch.Tensor:
    """``a``'s bytes as a uint8 tensor: gloo moves uint8 whatever the
    array's dtype (it has no unsigned 32-bit type)."""
    return torch.frombuffer(bytearray(a.tobytes()), dtype=torch.uint8) \
        if a.nbytes else torch.zeros(0, dtype=torch.uint8)


def _from_bytes(t, like) -> np.ndarray:
    return np.frombuffer(t.numpy().tobytes(), like.dtype).reshape(like.shape)


def allreduce_sum_host(arr) -> np.ndarray:
    """COLLECTIVE: the element-wise sum of every process's int64 ``arr``."""
    import torch.distributed as dist

    a = np.ascontiguousarray(arr, dtype=np.int64).copy()
    if process_count() == 1:
        return a
    t = torch.from_numpy(a)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()
