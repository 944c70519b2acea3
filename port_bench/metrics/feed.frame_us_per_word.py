"""Feed and dict cache (``feed/pipeline.py``): microseconds the feed's
source side takes a word, the window's ``feed:frame`` spans (a block's
resume skip, its words pulled from the source, for a cold dict the
gunzip and line split, and its framing; every feed) over the words pass
2 framed (``dwpa_feed_framed_words_total{feed="pass2"}``), window
deltas.  None where the program records no such span or words."""

SPANS, WORDS = "dwpa_span_seconds", "dwpa_feed_framed_words_total"


def _frame_s(snapshot):
    return sum(s["sum"] for s in snapshot.get(SPANS, {}).get("samples", ())
               if s["labels"].get("span") == "feed:frame")


def _pass2_words(snapshot):
    return sum(s["value"] for s in snapshot.get(WORDS, {}).get("samples", ())
               if s["labels"].get("feed") == "pass2")


def read(w):
    words = _pass2_words(w.metrics_after) - _pass2_words(w.metrics_before)
    seconds = _frame_s(w.metrics_after) - _frame_s(w.metrics_before)
    if words <= 0 or seconds <= 0:
        return None
    return 1e6 * seconds / words
