"""Feed and dict cache (``feed/pipeline.py``, ``native/`` packer):
milliseconds a producer spends on a block after framing it (the byte
count and the native pack, or a warm block's copy out of the cache),
the mean of the window's ``feed:produce`` spans
(``dwpa_span_seconds{span="feed:produce"}``, sum over count, window
delta, every feed).  None where the window records none."""

FAMILY = "dwpa_span_seconds"


def _produce_spans(snapshot):
    """(seconds, spans) of ``feed:produce`` in ``snapshot``."""
    samples = [s for s in snapshot.get(FAMILY, {}).get("samples", ())
               if s["labels"].get("span") == "feed:produce"]
    return sum(s["sum"] for s in samples), sum(s["count"] for s in samples)


def read(w):
    (s1, n1), (s0, n0) = _produce_spans(w.metrics_after), _produce_spans(w.metrics_before)
    if n1 - n0 <= 0:
        return None
    return 1e3 * (s1 - s0) / (n1 - n0)
