"""Feed and dict cache (``feed/pipeline.py``): the share of the window
the feed's source side was busy, the window's ``feed:frame`` seconds
(``dwpa_span_seconds{span="feed:frame"}``, window delta, every feed)
over the window's seconds, in percent.  Near 100 with one producer, the
source side is the ceiling.  None where the program records no such
span."""

FAMILY = "dwpa_span_seconds"


def _frames(snapshot):
    return [s for s in snapshot.get(FAMILY, {}).get("samples", ())
            if s["labels"].get("span") == "feed:frame"]


def read(w):
    after = _frames(w.metrics_after)
    if not after:
        return None
    seconds = sum(s["sum"] for s in after) - sum(s["sum"] for s in _frames(w.metrics_before))
    return 100.0 * seconds / w.seconds
