"""Rules seam (``models/m22000.py`` ``_rules_flush``): the share of the K1
columns the seam launched in the window that carry a candidate, a
(word, rule) pair or a valid host-tail candidate
(``dwpa_rules_k1_columns_total``, ``fill`` candidate over candidate and
pad), in percent.  None where the program counts no such columns."""

FAMILY = "dwpa_rules_k1_columns_total"


def _by_fill(snapshot):
    out = {}
    for s in snapshot.get(FAMILY, {}).get("samples", ()):
        fill = s["labels"].get("fill")
        out[fill] = out.get(fill, 0.0) + s["value"]
    return out


def read(w):
    after, before = _by_fill(w.metrics_after), _by_fill(w.metrics_before)
    cand, pad = (after.get(k, 0.0) - before.get(k, 0.0) for k in ("candidate", "pad"))
    return None if cand + pad <= 0 else 100.0 * cand / (cand + pad)
