"""Which process emits telemetry in a multi-process run.

A multi-process slice is ONE volunteer, so its telemetry is reported
once, not once per process: only process 0 emits (logs, serves
``?metrics``), and ``is_emitter()`` is the gate.  The port runs one
process today; the slice-wide snapshot merge (``allgather_json``,
``merged_slice_snapshot``) comes with the multi-host slice.
"""


def is_emitter() -> bool:
    """True on the process that owns external emission: rank 0 of an
    initialized ``torch.distributed`` group, and always when no group is
    initialized (single-process by definition)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True
