"""Feed and dict cache (``feed/staging.py``): milliseconds the consumer
thread spends staging a block (pinning its rows and enqueuing their
H2D), the mean of the window's ``feed:stage`` spans."""


def read(w):
    spans = [s["t1"] - s["t0"] for s in w.spans if s["name"] == "feed:stage"]
    return 1e3 * sum(spans) / len(spans) if spans else None
