"""Rules seam (``rules/device.py``, the engine's ``_rules_flush``): the share
of (word, rule) pairs the seam sent to the host interpreter instead of
expanding them on the device, over the window, in percent."""

from port_bench.cell import counter_sum

HOST, DEVICE = "dwpa_rules_host_fallback_total", "dwpa_rules_device_expanded_total"


def read(w):
    def delta(family):
        return counter_sum(w.metrics_after, family) - counter_sum(w.metrics_before, family)

    host, dev = delta(HOST), delta(DEVICE)
    return None if host + dev <= 0 else 100.0 * host / (host + dev)
