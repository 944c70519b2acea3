"""Span tracer: named, nested wall-clock timings over ``perf_counter``.

The client's crack loop (challenge, get_work, dict download, pass 1,
pass 2, put_work, and inside a pass the consumer loop's ``feed:next``,
``feed:stage``, ``engine:dispatch``, ``engine:collect`` > ``engine:gate``
/ ``engine:decode`` and ``client:checkpoint``), the feed's producers and
the server's jobs all publish through one span API, so a scrape, the
port bench's per-layer metrics and a profiler's trace can never disagree
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

A span named for the host's launch of device work (``engine:dispatch``,
``feed:stage``) times the launch, not the work it enqueues.

Timings are recorded twice: into the owning registry as a
``dwpa_span_seconds{span=...}`` histogram (scrapeable), and into a ring
of the last ``RING`` finished-span records (name, parent, depth, start,
stop) that tests use to assert well-nestedness and the port bench reads
a window's spans from.  The ring holds about five bench windows of the
consumer loop (six spans a batch) in a few MB.

**The profiler's clock.**  While a ``torch.profiler`` runs, every span
also opens a ``torch.profiler.record_function`` range under its own name
and closes it when the span stops, so the spans sit in the profiler's
trace on the clock its kernels are stamped with.  With no profiler
running that costs one flag read a span, and this module never imports
``torch``: it looks the profiler up in ``sys.modules``.
"""

import collections
import contextlib
import sys
import threading
import time

#: finished-span records a tracer keeps, oldest dropped first
RING = 16384


def _force_fetch(sync):
    """Materialize ``sync`` on the host: callables are invoked, a tensor
    is copied to the host (which waits for the work that produces it),
    anything else is already host data."""
    if sync is None:
        return
    if callable(sync):
        sync()
        return
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(sync, torch.Tensor):
        sync.cpu()


def _profiler_range(name):
    """A ``record_function`` range entered under ``name`` while a torch
    profiler runs; None otherwise."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One live timing region.  Created by ``SpanTracer.start``/``span``;
    ``seconds`` is valid after ``stop()``."""

    __slots__ = ("tracer", "name", "parent", "depth", "t0", "t1", "_range")

    def __init__(self, tracer, name, parent, depth):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        self.depth = depth
        self.t0 = time.perf_counter()
        self.t1 = None
        # inside the clock: what the bridge costs (a range's op may hand
        # the GIL to another thread) is the span's own time
        self._range = _profiler_range(name)

    @property
    def seconds(self) -> float:
        """Duration; live reading while the span is still open."""
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    def stop(self, sync=None) -> float:
        """Close the span; ``sync`` (device value or callable) is
        fetched/invoked BEFORE the clock is read — the device-sync rule
        above.  Idempotent: a second stop returns the recorded time."""
        if self.t1 is not None:
            return self.seconds
        _force_fetch(sync)
        self.tracer._close_ranges(self)
        self.t1 = time.perf_counter()
        self.tracer._finish(self)
        return self.seconds

    def _close_range(self):
        with self.tracer._lock:   # a range is exited once
            rf, self._range = self._range, None
        if rf is not None:
            rf.__exit__(None, None, None)


class SpanTracer:
    """Per-subsystem tracer; records into ``registry`` (default: the
    process-wide one) and keeps the last ``RING`` finished spans."""

    def __init__(self, registry=None):
        from .metrics import default_registry

        self.registry = registry or default_registry()
        self._hist = self.registry.histogram(
            "dwpa_span_seconds", "span durations by name")
        self._lock = threading.Lock()
        self.finished = collections.deque(maxlen=RING)  # oldest first
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

    def _close_ranges(self, sp: Span):
        """End the profiler ranges of ``sp`` and of the children it
        abandons (an exception may have skipped a child's stop),
        innermost first, so the profiler's range stack never wedges."""
        st = self._stack()
        if sp in st:
            for child in reversed(st[st.index(sp) + 1:]):
                child._close_range()
        sp._close_range()

    def _finish(self, sp: Span):
        st = self._stack()
        # pop sp and anything abandoned above it: the stack must never
        # wedge
        if sp in st:
            del st[st.index(sp):]
        self._hist.labels(span=sp.name).observe(sp.seconds)
        with self._lock:
            self.finished.append({
                "name": sp.name, "parent": sp.parent, "depth": sp.depth,
                "t0": sp.t0, "t1": sp.t1,
            })

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
