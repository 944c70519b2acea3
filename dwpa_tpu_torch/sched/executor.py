"""Multi-unit executor: keep a queue of small work units ahead of the
device and crack them as fused mixed-ESSID batches.

The client's unit loop is strictly serial: fetch a unit, crack it, fetch
the next — so a stream of small ESSID-group x dict units leaves the
device idle between units AND underfilled within them.  This executor
is the scheduling half of fusion (``sched.fuse`` is the packing half): a
producer thread materializes up to ``unit_queue`` units ahead (skip
applied — deterministic resume framing carries over), and the consumer
drains them in WAVES of up to ``fuse_max_units``, handing each wave to
``M22000Engine.crack_fused``, which packs the units' candidates into
full device batches with a per-lane salt gather.

Failure containment: a wave whose crack raises ``RuntimeError`` — a
failed kernel launch, ``torch.cuda.OutOfMemoryError`` on an oversized
fused width — is retried ONCE at half the batch size on a fresh engine;
if it fails again its units are requeued with exponential backoff, and
a unit that keeps failing lands in ``failed`` instead of wedging the
stream.  No other error is caught.

One device: every wave runs on the executor's ``device``.  Per-device
streams are not ported (ROADMAP later slice 6), so ``streams=True`` on a
host with more than one CUDA device raises instead of running lockstep;
``"auto"`` and ``False`` run lockstep on the one device.

Observability: ``dwpa_fused_units_per_batch`` (histogram),
``dwpa_fused_fill_fraction`` / ``dwpa_unit_queue_depth`` (gauges),
``dwpa_fused_retries_total`` (counter), plus the engine's
``sched:fuse`` / ``sched:demux`` spans when a tracer is wired.
"""

import queue
import threading
import time
from dataclasses import dataclass, field

import torch

from ..feed.framing import frame_blocks, skip_stream
from ..models import hashline as hl
from ..parallel.device import resolve_device

#: Fused-batch histogram buckets: unit counts, not seconds (the metrics
#: registry's DEFAULT_BUCKETS are latency-oriented).
UNITS_PER_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0)


def _distinct_essids(lines) -> tuple:
    """The distinct ESSIDs of ``lines`` in first-seen order, parse-tolerant
    (unparseable lines are the engine's ``skipped`` concern, not a wave
    killer)."""
    seen = {}
    for line in lines:
        try:
            h = line if isinstance(line, hl.Hashline) else hl.parse(line)
        except ValueError:
            continue
        seen[h.essid] = True
    return tuple(seen)


@dataclass
class WorkUnit:
    """One fetchable work unit: a hashline set and a candidate stream.

    ``words`` may be any iterable; the producer thread materializes it
    (after dropping ``skip`` candidates — the resume contract: a unit
    retried or resumed at skip=k behaves exactly like the serial path's
    ``skip_stream``).  ``consumed`` is the unit's conservative resume
    floor: the minimum candidate coverage across its ESSID parts, so a
    checkpoint written from it never skips an uncracked candidate.
    """

    uid: object
    lines: list
    words: object
    skip: int = 0
    attempts: int = 0
    consumed: int = 0
    founds: list = field(default_factory=list)
    #: parsed rule list for a RULES unit: ``words`` then carries BASE
    #: words and the unit dispatches through the device rule-expansion
    #: seam (``M22000Engine.crack_rules_blocks``) instead of
    #: ``crack_fused`` — and ``skip``/``consumed`` count EXPANDED
    #: (word x rule) candidates, the rules resume domain
    rules: list = None
    # -- producer/consumer internals --
    _materialized: list = None
    _essids: tuple = None
    _done: dict = None

    def __post_init__(self):
        # Derived once, before any thread sees the unit: the executor's
        # wave assembly reads it from the consumer thread.
        self._essids = _distinct_essids(self.lines)

    def essids(self) -> tuple:
        """The unit's distinct ESSIDs, parse-tolerant."""
        return self._essids


class _End:
    """The producer's last queue item: the end of the unit stream, with
    the error that ended it early (None at a clean end).  The error
    travels through the queue, so no executor state is written from the
    producer thread."""

    __slots__ = ("error",)

    def __init__(self, error=None):
        self.error = error


class MultiUnitExecutor:
    """Pack small work units into fused device batches (see module doc).

    ``units``: iterable of ``WorkUnit`` (a generator is fine — the
    producer thread pulls lazily, so fetch latency overlaps cracking).
    ``engine_factory(lines, batch_size)``: override for tests; defaults
    to building an ``M22000Engine`` on this executor's device and store.
    ``device``: the torch device every wave cracks on (``None`` is
    ``cuda:0``).
    """

    def __init__(self, units, *, batch_size=4096, unit_queue=4,
                 fuse_max_units=8, nc=8, device=None, pmk_store=None,
                 registry=None, tracer=None, max_retries=2,
                 backoff_s=1.0, sleep=time.sleep, engine_factory=None,
                 streams="auto"):
        if streams not in ("auto", True, False):
            raise ValueError(f"streams must be 'auto', True or False, not {streams!r}")
        if streams is True and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "streams=True: per-device streams are not ported yet "
                "(ROADMAP later slice 6)")
        self.units = iter(units)
        self.batch_size = int(batch_size)
        self.unit_queue = max(1, int(unit_queue))
        self.fuse_max_units = max(1, int(fuse_max_units))
        self.nc = nc
        self.device = resolve_device(device)
        self.pmk_store = pmk_store
        self.registry = registry
        self.tracer = tracer
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.sleep = sleep
        self._engine_factory = engine_factory or self._default_engine
        self.done = []     # units that completed (possibly after retry)
        self.failed = []   # units abandoned after max_retries
        self._q = queue.Queue(maxsize=self.unit_queue)
        self._deferred = []  # essid-collision holdovers, next-wave first
        if registry is not None:
            self._m_units = registry.histogram(
                "dwpa_fused_units_per_batch",
                "Work units packed into each fused device batch",
                buckets=UNITS_PER_BATCH_BUCKETS)
            self._m_fill = registry.gauge(
                "dwpa_fused_fill_fraction",
                "Real-candidate fraction of the last fused batch")
            self._m_depth = registry.gauge(
                "dwpa_unit_queue_depth",
                "Prefetched work units waiting in the executor queue")
            self._m_retries = registry.counter(
                "dwpa_fused_retries_total",
                "Fused wave crack attempts retried after an engine error")
        else:
            self._m_units = self._m_fill = self._m_depth = None
            self._m_retries = None

    # -- producer ----------------------------------------------------------

    def _produce(self):
        """Materialize units ahead of the consumer (bounded queue).

        Pure host work — candidate IO and skip framing — so it overlaps
        device compute exactly like the feed's producer threads."""
        end = _End()
        try:
            for u in self.units:
                words = iter(u.words)
                if u.skip and u.rules is None:
                    # a rules unit's skip is EXPANDED pairs — the
                    # engine's O(1) block-drop applies it, not the
                    # base-word stream
                    skip_stream(words, u.skip)  # consumes in place
                u._materialized = list(words)
                self._q.put(u)
                self._gauge_depth()
        except BaseException as e:  # re-raised by run() on the consumer side
            end = _End(e)
        finally:
            self._q.put(end)

    def _gauge_depth(self):
        if self._m_depth is not None:
            self._m_depth.set(self._q.qsize())

    # -- consumer ----------------------------------------------------------

    def _default_engine(self, lines, batch_size):
        from ..models.m22000 import M22000Engine

        return M22000Engine(lines, nc=self.nc, batch_size=batch_size,
                            device=self.device, pmk_store=self.pmk_store)

    def _next_wave(self, end):
        """Assemble the next wave: deferred holdovers first, then fresh
        units from the queue, stopping at ``fuse_max_units`` or at an
        ESSID collision (two units sharing an ESSID cannot share a
        fused batch's salt table — the collider waits one wave).  The
        producer's ``_End`` lands in ``end``."""
        wave, taken = [], set()

        def try_add(u):
            if wave and (u.rules is not None or wave[0].rules is not None):
                # rules units run as singleton waves: their dispatch is
                # the device-expansion seam, not the fused salt table
                return False
            es = u.essids()
            if any(e in taken for e in es):
                return False
            wave.append(u)
            taken.update(es)
            return True

        held, self._deferred = self._deferred, []
        for u in held:
            if len(wave) >= self.fuse_max_units or not try_add(u):
                self._deferred.append(u)
        while len(wave) < self.fuse_max_units and not end:
            try:
                u = self._q.get(block=not wave and not self._deferred)
            except queue.Empty:
                break
            if isinstance(u, _End):
                end.append(u)
                break
            self._gauge_depth()
            if not try_add(u):
                self._deferred.append(u)
                break  # keep wave assembly cheap; collider leads next wave
        return wave

    def _run_wave(self, wave, batch_size):
        """Crack one wave through a fresh engine's fused path."""
        if len(wave) == 1 and wave[0].rules is not None:
            return self._run_wave_rules(wave[0], batch_size)
        lines = [ln for u in wave for ln in u.lines]
        engine = self._engine_factory(lines, batch_size)
        by_essid = {}
        for u in wave:
            u._done = {}
            for e in u.essids():
                by_essid[e] = u
        parts = [(e, u._materialized) for u in wave for e in u.essids()]

        def on_batch(essid, consumed, founds):
            u = by_essid.get(essid)
            if u is None:
                return
            u._done[essid] = u._done.get(essid, 0) + consumed
            # Conservative resume floor across the unit's ESSID parts.
            u.consumed = u.skip + min(u._done.values())
            for f in founds:
                if all(f.line is not g.line or f.psk != g.psk
                       for g in u.founds):
                    u.founds.append(f)

        def on_fused(fb):
            if self._m_units is not None:
                self._m_units.observe(len(fb.units))
                self._m_fill.set(fb.fill)

        engine.crack_fused(parts, on_batch=on_batch,
                           max_units=self.fuse_max_units,
                           tracer=self.tracer, on_fused=on_fused)

    def _run_wave_rules(self, u, batch_size):
        """Crack one RULES unit through the device-expansion seam — the
        same ``crack_rules_blocks`` entry as the serial client path, not
        a third regime.  ``u.consumed`` advances in EXPANDED candidates."""
        engine = self._engine_factory(u.lines, batch_size)
        u.consumed = u.skip

        def on_batch(consumed, founds):
            u.consumed += consumed
            for f in founds:
                if all(f.line is not g.line or f.psk != g.psk
                       for g in u.founds):
                    u.founds.append(f)

        blocks = frame_blocks(iter(u._materialized), engine.batch_size)
        engine.crack_rules_blocks(
            blocks, u.rules, on_batch=on_batch, skip=u.skip,
            registry=self.registry, tracer=self.tracer)

    def run(self) -> list:
        """Drain every unit; returns the completed units in finish order.

        Engine errors are contained per wave: one retry at half batch,
        then requeue-with-backoff, then ``failed`` (module doc)."""
        producer = threading.Thread(target=self._produce, daemon=True,
                                    name="sched-unit-producer")
        producer.start()
        end = []
        while True:
            wave = self._next_wave(end)
            if not wave:
                if end and not self._deferred:
                    break
                continue
            try:
                self._run_wave(wave, self.batch_size)
            except RuntimeError:
                # One in-process retry at half batch (an out-of-memory on
                # the fused width usually fits at W/2; a transient device
                # error just needs the re-dispatch).
                if self._m_retries is not None:
                    self._m_retries.inc()
                try:
                    self._run_wave(wave, max(1, self.batch_size // 2))
                except RuntimeError:
                    requeued = False
                    for u in wave:
                        u.attempts += 1
                        if u.attempts > self.max_retries:
                            self.failed.append(u)
                        else:
                            self._deferred.append(u)
                            requeued = True
                    if requeued:
                        self.sleep(self.backoff_s * 2 ** (wave[0].attempts - 1))
                    continue
            self.done.extend(wave)
        producer.join(timeout=5)
        if end[0].error is not None:
            raise end[0].error
        return self.done
