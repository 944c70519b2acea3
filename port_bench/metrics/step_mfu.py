"""Device: the instructions the window's work needs, K1's and K3's by the
frozen census, over what the card issues at most in the whole traced
window, in percent: the bound on every kernel's share, whichever kernel
runs the work."""

from port_bench import census


def read(w):
    if w.trace is None or w.peak_inst_per_s is None or w.extra.get("k3_inst") is None:
        return None
    inst = census.k1_inst_per_pmk() * w.pmks + w.extra["k3_inst"]
    return 100.0 * inst / (w.trace["window_s"] * w.peak_inst_per_s)
