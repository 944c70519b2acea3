"""Engine (``models/m22000.py``): the dispatched batches still running on
the card when the hits gate returns, the mean over the window's gates
(``dwpa_engine_gate_inflight_batches``: sum over count, window delta).
A pipeline that keeps the card fed reads ``PIPELINE_DEPTH`` (3); a gate
that drains the device reads 0."""

from port_bench.cell import histogram_sum

FAMILY = "dwpa_engine_gate_inflight_batches"


def _count(snapshot):
    return sum(s["count"] for s in snapshot.get(FAMILY, {}).get("samples", ()))


def read(w):
    gates = _count(w.metrics_after) - _count(w.metrics_before)
    if gates <= 0:
        return None
    return (histogram_sum(w.metrics_after, FAMILY)
            - histogram_sum(w.metrics_before, FAMILY)) / gates
