"""Slice-wide telemetry agreement for multi-process slices.

A multi-process slice is ONE volunteer, so its telemetry is reported
once, not once per process.  Every process records into its own
process-local registry (recording never needs a collective); at report
points the processes run ``merged_slice_snapshot`` TOGETHER — a
fixed-shape allgather of JSON snapshots — and each folds the others'
counts into a merged view.  Only process 0 then *emits* (logs, serves
``?metrics``): ``is_emitter()`` is the gate.

Collective discipline, as in the client's other agreement helpers: two
fixed-shape allgathers (lengths first, then max-padded payloads), so
every process reaches every collective with identical shapes — a raise
before either would strand the peers inside it, so callers must invoke
this from a point every process reaches.
"""

import json

import numpy as np


def is_emitter() -> bool:
    """True on the process that owns external emission: rank 0 of an
    initialized ``torch.distributed`` group, and always when no group is
    initialized (single-process by definition)."""
    from ..parallel.mesh import process_index

    return process_index() == 0


def allgather_json(obj):
    """Every process's JSON-serializable ``obj``, in rank order.

    Single-process: ``[obj]`` with no collective.  Multi-process: two
    fixed-shape allgather rounds (lengths, then padded payload bytes) —
    the equal-shape contract every process must honor."""
    from ..parallel.mesh import allgather_host, process_count

    if process_count() == 1:
        return [obj]
    data = json.dumps(obj).encode()
    lens = allgather_host(np.asarray([len(data)], np.int64)).reshape(-1)
    width = int(lens.max())
    buf = np.zeros(width, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    rows = allgather_host(buf).reshape(-1, width)
    return [json.loads(bytes(r[: int(n)]).decode()) for r, n in zip(rows, lens)]


def merged_slice_snapshot(registry):
    """COLLECTIVE: every process contributes ``registry.snapshot()``;
    each returns the slice-wide merge (counters/histograms summed,
    additive gauges summed — see ``MetricsRegistry.merge_snapshot``).
    The merge is identical on every process; emit it only where
    ``is_emitter()``."""
    from .metrics import MetricsRegistry

    snaps = allgather_json(registry.snapshot())
    merged = MetricsRegistry()
    for snap in snaps:
        merged.merge_snapshot(snap)
    return merged
