"""Client (``client/main.py``): milliseconds the consumer thread spends
writing the resume checkpoint after a batch (its JSON and the file and
directory fsyncs), the mean of the window's ``client:checkpoint``
spans."""


def read(w):
    spans = [s["t1"] - s["t0"] for s in w.spans if s["name"] == "client:checkpoint"]
    return 1e3 * sum(spans) / len(spans) if spans else None
