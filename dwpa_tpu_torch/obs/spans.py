"""Span tracer: named, nested wall-clock timings over ``perf_counter``.

The crack loop's phases (challenge, get_work, dict download, pass 1,
pass 2, put_work) and bench.py's timed regions all publish through one
span API, so the benchmark JSON and live telemetry can never disagree
about what a region took.

**The device-sync rule.** ``time.perf_counter()`` reads the HOST clock;
on a GPU, a kernel launch returns long before the kernel completes, so a
span that stops its clock while device work is still in flight lies by
orders of magnitude.  Every span that covers device work must force a
device→host sync before the clock stops:

- the engine's ``crack*`` methods sync internally (their hits-gate
  fetches the result), so a span wrapping a whole crack call is sound;
- raw device launches need an explicit ``.cpu()`` /
  ``torch.cuda.synchronize()`` inside the span, or a ``sync=`` value
  passed to ``stop()``/the context manager, which is fetched *before*
  the clock is read.

Timings are recorded twice: into the owning registry as a
``dwpa_span_seconds{span=...}`` histogram (scrapeable), and into a
bounded in-memory ring of finished-span records (name, parent, start,
stop, depth) that tests use to assert well-nestedness.
"""

import contextlib
import threading
import time


def _force_fetch(sync):
    """Materialize ``sync`` on the host: callables are invoked, a tensor
    is copied to the host (which waits for the work that produces it),
    anything else is already host data."""
    if sync is None:
        return
    if callable(sync):
        sync()
        return
    import torch

    if isinstance(sync, torch.Tensor):
        sync.cpu()


class Span:
    """One live timing region.  Created by ``SpanTracer.start``/``span``;
    ``seconds`` is valid after ``stop()``."""

    __slots__ = ("tracer", "name", "parent", "depth", "t0", "t1")

    def __init__(self, tracer, name, parent, depth):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        self.depth = depth
        self.t0 = time.perf_counter()
        self.t1 = None

    @property
    def seconds(self) -> float:
        """Duration; live reading while the span is still open."""
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    def elapsed(self) -> float:
        return self.seconds

    def stop(self, sync=None) -> float:
        """Close the span; ``sync`` (device value or callable) is
        fetched/invoked BEFORE the clock is read — the device-sync rule
        above.  Idempotent: a second stop returns the recorded time."""
        if self.t1 is not None:
            return self.seconds
        _force_fetch(sync)
        self.t1 = time.perf_counter()
        self.tracer._finish(self)
        return self.seconds


class SpanTracer:
    """Per-subsystem tracer; records into ``registry`` (default: the
    process-wide one) and keeps the last ``keep`` finished spans."""

    def __init__(self, registry=None, keep: int = 1024):
        from .metrics import default_registry

        self.registry = registry or default_registry()
        self._hist = self.registry.histogram(
            "dwpa_span_seconds", "span durations by name")
        self._lock = threading.Lock()
        self._keep = keep
        self.finished = []  # ring of record dicts, oldest first
        self._local = threading.local()

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def start(self, name: str) -> Span:
        st = self._stack()
        parent = st[-1].name if st else None
        sp = Span(self, name, parent, len(st))
        st.append(sp)
        return sp

    def _finish(self, sp: Span):
        st = self._stack()
        # pop sp and anything abandoned above it (an exception may have
        # skipped a child's stop; the stack must never wedge)
        if sp in st:
            del st[st.index(sp):]
        self._hist.labels(span=sp.name).observe(sp.seconds)
        with self._lock:
            self.finished.append({
                "name": sp.name, "parent": sp.parent, "depth": sp.depth,
                "t0": sp.t0, "t1": sp.t1,
            })
            if len(self.finished) > self._keep:
                del self.finished[: len(self.finished) - self._keep]

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Context-managed span.  The body must sync its own device work
        (engine ``crack*`` calls do) or pass ``sync=`` to be fetched at
        exit — see the module docstring."""
        sp = self.start(name)
        try:
            yield sp
        finally:
            sp.stop(sync=sync)

    def records(self, name: str = None) -> list:
        """Finished-span records, optionally filtered by name."""
        with self._lock:
            recs = list(self.finished)
        return [r for r in recs if name is None or r["name"] == name]


_DEFAULT_TRACER = None
_DEFAULT_TRACER_LOCK = threading.Lock()


def default_tracer() -> SpanTracer:
    """Lazy singleton bound to the default registry."""
    global _DEFAULT_TRACER
    with _DEFAULT_TRACER_LOCK:
        if _DEFAULT_TRACER is None:
            _DEFAULT_TRACER = SpanTracer()
        return _DEFAULT_TRACER
