"""Process-local metrics registry: counters, gauges, histograms.

Zero dependencies beyond the stdlib, thread-safe (one lock per
registry — the server's threaded WSGI handlers and the client's main
loop both record through here), and deliberately tiny: the repo needs
numbers it can trust on the hot path, not a metrics framework.

Design constraints, in priority order:

- **No host syncs.** Recording a metric is a few dict/float ops under a
  lock; nothing here may touch a device value.  Callers compute rates
  (PMK/s) from counts they already hold host-side — the DW106 lint rule
  (analysis/linter.py) enforces that no emission call ever lands inside
  a jit-traced region.
- **Mergeable.** ``snapshot()`` emits a plain-JSON form and
  ``merge_snapshot()`` folds another host's snapshot in (counters and
  histograms add; gauges sum — the slice-wide reading for additive
  gauges like PMK/s).  The multi-host client rides this through the
  same fixed-shape collective discipline as ``_broadcast_json``
  (obs/multihost.py).
- **Prometheus text-format v0.0.4** (``render_prometheus``) for the
  server's ``?metrics`` scrape, plus ``render_json`` for tests and the
  ``?metrics=json`` wire form.

Naming conventions (documented in README "Telemetry"): metric names are
``dwpa_<subsystem>_<what>[_<unit>][_total]``; labels are lowercase
snake-case with low cardinality (endpoint, pass, direction, job, span).
"""

import json
import threading

#: default histogram buckets, in seconds — spans 1 ms kernel dispatches
#: to the 900 s work-unit pacing target.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 900.0,
)

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    # integral values render without the trailing .0 (Prometheus style)
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One labeled series of a family; all mutation under the registry
    lock (metric ops are a few float adds — contention is negligible
    next to the device work they time)."""

    __slots__ = ("_family", "_key", "value", "sum", "buckets")

    def __init__(self, family, key):
        self._family = family
        self._key = key
        self.value = 0.0
        if family.type == HISTOGRAM:
            self.sum = 0.0
            # one count per bound + the +Inf overflow slot
            self.buckets = [0] * (len(family.bucket_bounds) + 1)

    # -- counter / gauge ---------------------------------------------------

    def inc(self, amount: float = 1.0):
        with self._family._lock:
            self.value += amount

    def dec(self, amount: float = 1.0):
        if self._family.type != GAUGE:
            raise TypeError(f"{self._family.name}: dec() is gauge-only")
        self.inc(-amount)

    def set(self, value: float):
        if self._family.type != GAUGE:
            raise TypeError(f"{self._family.name}: set() is gauge-only")
        with self._family._lock:
            self.value = float(value)

    # -- histogram ---------------------------------------------------------

    def observe(self, value: float):
        fam = self._family
        if fam.type != HISTOGRAM:
            raise TypeError(f"{fam.name}: observe() is histogram-only")
        with fam._lock:
            self.value += 1          # observation count
            self.sum += float(value)
            for i, bound in enumerate(fam.bucket_bounds):
                if value <= bound:
                    self.buckets[i] += 1
                    return
            self.buckets[-1] += 1


class _Family:
    """A named metric and its labeled children."""

    def __init__(self, registry, name: str, mtype: str, help: str = "",
                 buckets=None):
        self.name = name
        self.type = mtype
        self.help = help
        self.bucket_bounds = tuple(buckets or DEFAULT_BUCKETS) \
            if mtype == HISTOGRAM else ()
        self._lock = registry._lock
        self._children = {}

    def labels(self, **labels) -> _Child:
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self, key)
            return child

    # un-labeled convenience: family.inc() == family.labels().inc()
    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0):
        self.labels().dec(amount)

    def set(self, value: float):
        self.labels().set(value)

    def observe(self, value: float):
        self.labels().observe(value)


class MetricsRegistry:
    """Create/look up metric families and render/merge the whole set.

    ``counter``/``gauge``/``histogram`` are idempotent by name: the
    first registration wins (help text included) and later calls return
    the same family, so any module can cheaply re-declare the metric it
    records to.  Re-registering a name as a different *type* is a bug
    and raises.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}

    # -- registration ------------------------------------------------------

    def _family(self, name: str, mtype: str, help: str, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    self, name, mtype, help, buckets)
            elif fam.type != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.type}, "
                    f"not {mtype}")
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, COUNTER, help)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, GAUGE, help)

    def histogram(self, name: str, help: str = "", buckets=None) -> _Family:
        return self._family(name, HISTOGRAM, help, buckets)

    # -- test/introspection helpers ---------------------------------------

    def value(self, name: str, **labels):
        """Current value of one series (histograms: observation count),
        or None when the series was never recorded."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            child = fam._children.get(_label_key(labels))
            return None if child is None else child.value

    def series(self, name: str) -> dict:
        """{label-tuple: value} for every child of ``name``."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return {}
            return {k: c.value for k, c in fam._children.items()}

    # -- snapshot / merge (the multi-host agreement form) ------------------

    def snapshot(self) -> dict:
        """JSON-serializable full state, the unit ``merge_snapshot``
        folds; also the ``?metrics=json`` wire form."""
        out = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                samples = []
                for key, c in sorted(fam._children.items()):
                    labels = {k: v for k, v in key}
                    if fam.type == HISTOGRAM:
                        samples.append({"labels": labels, "count": c.value,
                                        "sum": c.sum,
                                        "buckets": list(c.buckets)})
                    else:
                        samples.append({"labels": labels, "value": c.value})
                entry = {"type": fam.type, "help": fam.help,
                         "samples": samples}
                if fam.type == HISTOGRAM:
                    entry["bucket_bounds"] = list(fam.bucket_bounds)
                out[name] = entry
        return out

    def merge_snapshot(self, snap: dict):
        """Fold another registry's ``snapshot()`` into this one.

        Counters and histograms add; gauges SUM — the slice-wide
        reading for additive gauges (per-host PMK/s sums to slice
        PMK/s).  A gauge that must not be summed across hosts should be
        recorded only by the emitting host (process 0).
        """
        for name, entry in snap.items():
            fam = self._family(name, entry["type"], entry.get("help", ""),
                               entry.get("bucket_bounds"))
            for s in entry.get("samples", []):
                child = fam.labels(**s.get("labels", {}))
                with self._lock:
                    if fam.type == HISTOGRAM:
                        if tuple(entry.get("bucket_bounds", ())) != \
                                fam.bucket_bounds:
                            raise ValueError(
                                f"{name}: bucket bounds differ across "
                                "registries — cannot merge")
                        child.value += s["count"]
                        child.sum += s["sum"]
                        for i, b in enumerate(s["buckets"]):
                            child.buckets[i] += b
                    else:
                        child.value += s["value"]

    # -- rendering ---------------------------------------------------------

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus exposition text-format v0.0.4."""
        lines = []
        snap = self.snapshot()
        for name, entry in snap.items():
            if entry["help"]:
                lines.append(f"# HELP {name} {_escape_help(entry['help'])}")
            lines.append(f"# TYPE {name} {entry['type']}")
            for s in entry["samples"]:
                labels = s["labels"]
                if entry["type"] == HISTOGRAM:
                    cum = 0
                    bounds = entry["bucket_bounds"]
                    for i, b in enumerate(s["buckets"]):
                        cum += b
                        le = _fmt(bounds[i]) if i < len(bounds) else "+Inf"
                        lines.append("%s_bucket%s %s" % (
                            name, _label_str(labels, le=le), _fmt(cum)))
                    lines.append("%s_sum%s %s" % (
                        name, _label_str(labels), _fmt(s["sum"])))
                    lines.append("%s_count%s %s" % (
                        name, _label_str(labels), _fmt(s["count"])))
                else:
                    lines.append("%s%s %s" % (
                        name, _label_str(labels), _fmt(s["value"])))
        return "\n".join(lines) + "\n"


def _label_str(labels: dict, **extra) -> str:
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{%s}" % body


#: the process-wide default registry — what every subsystem records to
#: unless handed an explicit one (tests inject fresh registries).
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
