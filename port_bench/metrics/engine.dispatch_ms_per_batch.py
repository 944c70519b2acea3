"""Engine (``models/m22000.py``): host milliseconds the engine spends
issuing device work (``stage_times["dispatch"]``, summed over the
window's units) per PBKDF2 batch it launched (K1 launches in the
window)."""


def read(w):
    if not w.k1_launches or len(w.results) != len(w.units):
        return None
    return 1e3 * sum(r.stage_times["dispatch"] for r in w.results) / w.k1_launches
