"""Engine (``models/m22000.py``): megabytes (1e6 bytes) a hit decode
copies to the host (the found matrix and the hit PMK columns), over the
window's units (``dwpa_engine_found_fetch_bytes_total``, window
delta)."""

from port_bench.cell import counter_sum

FAMILY = "dwpa_engine_found_fetch_bytes_total"


def read(w):
    if FAMILY not in w.metrics_after or not w.units:
        return None
    fetched = counter_sum(w.metrics_after, FAMILY) - counter_sum(w.metrics_before, FAMILY)
    return fetched / 1e6 / len(w.units)
