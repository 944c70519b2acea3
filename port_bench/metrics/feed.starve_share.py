"""Feed and dict cache (``feed/pipeline.py``, ``feed/dictcache.py``): the
share of the window the engine waited on an empty candidate feed
(``dwpa_feed_consumer_starve_seconds``, every pass, summed over the
window), in percent."""

from port_bench.cell import histogram_sum

FAMILY = "dwpa_feed_consumer_starve_seconds"


def read(w):
    waited = histogram_sum(w.metrics_after, FAMILY) - histogram_sum(w.metrics_before, FAMILY)
    return 100.0 * waited / w.seconds
