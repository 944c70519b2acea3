"""HTTP/JSON transport for the dwpa volunteer protocol.

Speaks the exact wire protocol of the reference server so this client can
work against an unmodified dwpa deployment (endpoints and schemas per the
reference: ?get_work / ?put_work / ?prdict routing at web/index.php:146-163,
request/response shapes at web/content/get_work.php and
web/content/put_work.php; client-side counterpart help_crack.py:404-426,
727-735):

- ``get_work``: POST ``{"dictcount": N}`` to ``?get_work=<api-ver>`` ->
  ``{hkey, dicts:[{dhash,dpath}...], hashes:[...], rules?, prdict?}``;
  sentinel body ``Version`` (client too old) or ``No nets``.
- ``put_work``: POST ``{"hkey":…, "type":"bssid", "cand":[{k,v}...]}`` to
  ``?put_work`` -> ``OK`` / anything else = rejected.
- ``prdict``: GET ``?prdict=<hkey>`` -> gzip dictionary stream.
- static artifacts (dicts) by URL with md5 manifests.

Retry behavior departs from the reference client's flat infinite loop
(help_crack.py:80-87,104-126) in three ways, all knob-compatible with it:

- ``RetryPolicy``: exponential backoff with decorrelated jitter between
  ``backoff`` (base) and ``retry_cap``, optional per-call ``deadline``
  budget.  The defaults (base == cap == 123 s, retry forever) reproduce
  the reference cadence exactly.
- error classification: transient failures (connection refused/reset,
  timeout, HTTP 5xx) retry; permanent ones (HTTP 4xx, the ``Version``
  sentinel, malformed JSON after ``validation_retries`` re-fetches) raise
  immediately instead of spinning forever.
- a circuit breaker: after ``CircuitBreaker.threshold`` consecutive
  transient failures the transport goes OPEN and a down server is probed
  once per ``cooldown`` instead of hammered.  Callers with a bounded
  ``max_tries`` fail fast with ``CircuitOpenError`` while OPEN; unbounded
  callers sleep until the next probe slot (reference parity: they still
  block until the server returns).  ``TpuCrackClient`` keys its degraded
  mode off :attr:`ServerAPI.circuit_open`.

The single raw HTTP hop lives in :meth:`ServerAPI._transport`; everything
above it (retry, classification, breaker, telemetry) is pure host logic.
Tests and the chaos harness (``dwpa_tpu_torch.chaos``) replace ``_transport``
to inject faults underneath the real retry stack.
"""

import contextlib
import gzip
import hashlib
import json
import random
import time
import urllib.error
import urllib.parse
import urllib.request

HC_VER = "2.2.0"  # protocol level spoken (server gates on MIN_HC_VER)


class VersionRejected(RuntimeError):
    """Server refused our protocol version."""


class NoNets(RuntimeError):
    """Server has no work to hand out."""


class PermanentError(ConnectionError):
    """Classified non-retryable failure (HTTP 4xx, persistent bad JSON).

    Subclasses ``ConnectionError`` so existing call sites that catch the
    old give-up error keep working; new code can match it specifically.
    """


class CircuitOpenError(ConnectionError):
    """Transport circuit is OPEN and the probe window hasn't arrived."""


def classify_error(exc) -> tuple:
    """Map a transport exception to ``(kind, reason)``.

    ``kind`` is ``"permanent"`` (fail fast) or ``"transient"`` (retry);
    ``reason`` is the low-cardinality label recorded in
    ``dwpa_client_retries_total{reason=...}``.  Order matters:
    ``HTTPError`` is a ``URLError`` subclass — the very bug this fixes:
    the old flat loop caught ``URLError`` and retried a 404 forever.
    """
    if isinstance(exc, urllib.error.HTTPError):
        if exc.code == 429:
            # Admission control, not rejection: the server is up and
            # explicitly asking us to come back (Retry-After).
            return "transient", "http_429"
        kind = "permanent" if 400 <= exc.code < 500 else "transient"
        return kind, f"http_{exc.code // 100}xx"
    if isinstance(exc, TimeoutError):
        return "transient", "timeout"
    if isinstance(exc, urllib.error.URLError):
        reason = getattr(exc, "reason", None)
        if isinstance(reason, TimeoutError):
            return "transient", "timeout"
        if isinstance(reason, ConnectionRefusedError):
            return "transient", "refused"
        if isinstance(reason, ConnectionResetError):
            return "transient", "reset"
        return "transient", "unreachable"
    if isinstance(exc, ConnectionRefusedError):
        return "transient", "refused"
    if isinstance(exc, ConnectionResetError):
        return "transient", "reset"
    if isinstance(exc, (ConnectionError, OSError)):
        return "transient", "conn"
    return "transient", "error"


def retry_after_floor(exc) -> float:
    """Server-requested minimum backoff from a Retry-After header, or
    0.0 when the response carried none (or carried garbage).  Only the
    delta-seconds form is parsed — HTTP-date Retry-After is not worth a
    date parser here; a malformed value must never break the retry loop.
    """
    headers = getattr(exc, "headers", None)
    if headers is None:
        return 0.0
    try:
        value = headers.get("Retry-After")
    except AttributeError:
        return 0.0
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return 0.0


class RetryPolicy:
    """Exponential backoff with decorrelated jitter, cap and deadline.

    Each delay is drawn uniformly from ``[base, 3 * previous]`` and
    clamped to ``cap`` ("decorrelated jitter": successive clients don't
    synchronize their retries into thundering herds).  ``base == cap``
    degenerates to the reference client's flat interval.  ``deadline``
    (seconds) bounds the total time a single call may spend retrying;
    ``rng``/``clock`` are injectable so tests replay exact schedules.
    """

    def __init__(self, base: float = 123.0, cap: float = None,
                 deadline: float = None, rng=None, clock=time.monotonic):
        self.base = base
        self.cap = base if cap is None else max(cap, base)
        self.deadline = deadline
        self.rng = rng if rng is not None else random.Random()
        self.clock = clock

    def start(self, max_tries: int) -> "_RetryState":
        return _RetryState(self, max_tries)


class _RetryState:
    """Per-call retry bookkeeping (attempt count, jitter chain, budget)."""

    def __init__(self, policy: RetryPolicy, max_tries: int):
        self.policy = policy
        self.max_tries = max_tries  # 0 = unbounded (reference behavior)
        self.tries = 0
        self._prev = policy.base
        self._t0 = policy.clock()

    def next_delay(self):
        """Delay before the next attempt, or None when the call must
        give up (tries exhausted or deadline budget spent)."""
        p = self.policy
        self.tries += 1
        if self.max_tries and self.tries >= self.max_tries:
            return None
        delay = min(p.cap, p.rng.uniform(p.base, self._prev * 3))
        self._prev = max(delay, p.base)
        if p.deadline is not None:
            left = p.deadline - (p.clock() - self._t0)
            if left <= 0:
                return None
            delay = min(delay, left)
        return delay


class CircuitBreaker:
    """Three-state breaker over consecutive transient transport failures.

    CLOSED (normal) -> OPEN after ``threshold`` consecutive failures;
    while OPEN, ``allow()`` admits exactly one probe per ``cooldown``
    window (HALF_OPEN); a success anywhere resets to CLOSED.  Permanent
    failures (4xx) never trip it — the server answered, it's reachable.
    """

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(self, threshold: int = 5, cooldown: float = 30.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown = cooldown
        self.clock = clock
        self.state = self.CLOSED
        self.failures = 0
        self._opened_at = 0.0

    def allow(self) -> bool:
        if self.state != self.OPEN:
            return True
        if self.clock() - self._opened_at >= self.cooldown:
            self.state = self.HALF_OPEN  # one probe in flight
            return True
        return False

    def remaining(self) -> float:
        """Seconds until the next probe slot (0 when not OPEN)."""
        if self.state != self.OPEN:
            return 0.0
        return max(0.0, self.cooldown - (self.clock() - self._opened_at))

    def record_success(self):
        self.state = self.CLOSED
        self.failures = 0

    def record_failure(self):
        self.failures += 1
        if self.failures >= self.threshold:
            self.state = self.OPEN
            self._opened_at = self.clock()


#: query parameters that name protocol endpoints (metric label values)
_ENDPOINT_PARAMS = ("get_work", "put_work", "prdict")


def _endpoint_label(url: str) -> str:
    """Low-cardinality endpoint label for retry metrics."""
    query = urllib.parse.urlparse(url).query
    for name in _ENDPOINT_PARAMS:
        if name in urllib.parse.parse_qs(query, keep_blank_values=True):
            return name
    return "download"


class ServerAPI:
    def __init__(self, base_url: str, hc_ver: str = HC_VER, timeout: float = 120.0,
                 max_tries: int = 0, backoff: float = 123.0, sleep=time.sleep,
                 retry_cap: float = None, deadline: float = None,
                 rng=None, breaker: CircuitBreaker = None):
        self.base_url = base_url.rstrip("/") + "/"
        self.hc_ver = hc_ver
        self.timeout = timeout
        self.max_tries = max_tries  # 0 = retry forever (reference behavior)
        self.backoff = backoff      # retry base; also the idle (No nets) nap
        self.sleep = sleep
        self.retry = RetryPolicy(base=backoff, cap=retry_cap,
                                 deadline=deadline, rng=rng)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # get_work re-fetches a syntactically-bad body this many times
        # before classifying it permanent (a flaky proxy can truncate one
        # response; a server that always returns garbage is down for us).
        self.validation_retries = 2
        # Telemetry binding (bind_obs): every protocol op counts into
        # dwpa_client_requests_total{endpoint=...} and opens a span, so
        # server-conversation time is visible next to crack time.  Unbound
        # (bare ServerAPI uses) stays zero-overhead.
        self._obs_requests = None
        self._obs_retries = None
        self._obs_backoff = None
        self._obs_circuit = None
        self._obs_tracer = None

    def bind_obs(self, registry, tracer=None):
        """Attach a metrics registry (and optional SpanTracer): done by
        TpuCrackClient so transport ops land in the client's registry."""
        self._obs_requests = registry.counter(
            "dwpa_client_requests_total",
            "client->server protocol operations by endpoint")
        self._obs_retries = registry.counter(
            "dwpa_client_retries_total",
            "transport retries by endpoint and classified failure reason")
        self._obs_backoff = registry.histogram(
            "dwpa_client_backoff_seconds",
            "backoff sleeps between transport retries")
        self._obs_circuit = registry.gauge(
            "dwpa_client_circuit_state",
            "transport circuit state (0 closed / 1 half-open / 2 open)")
        self._obs_circuit.set(self.breaker.state)
        self._obs_tracer = tracer
        return self

    def _observed(self, endpoint: str):
        """Count + span one protocol op (no-op context when unbound)."""
        if self._obs_requests is not None:
            self._obs_requests.labels(endpoint=endpoint).inc()
        if self._obs_tracer is not None:
            return self._obs_tracer.span(endpoint)
        return contextlib.nullcontext()

    def _note_retry(self, endpoint: str, reason: str, delay: float):
        if self._obs_retries is not None:
            self._obs_retries.labels(endpoint=endpoint, reason=reason).inc()
        if self._obs_backoff is not None:
            self._obs_backoff.observe(delay)

    def _note_circuit(self):
        if self._obs_circuit is not None:
            self._obs_circuit.set(self.breaker.state)

    @property
    def circuit_open(self) -> bool:
        """True while the breaker is OPEN (degraded-mode signal)."""
        return self.breaker.state == CircuitBreaker.OPEN

    # -- low level ---------------------------------------------------------

    def _transport(self, url: str, body: bytes = None, headers: dict = None) -> bytes:
        """One raw HTTP exchange — the fault-injection seam.

        The chaos harness and loopback tests replace this attribute; the
        retry/classification/breaker stack above it stays the real one.
        """
        req = urllib.request.Request(url, data=body, headers=headers or {})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return r.read()

    def fetch(self, url: str, data: dict = None, max_tries: int = None) -> bytes:
        """GET (or POST json) with classified retry/backoff.

        ``max_tries`` overrides the instance default for callers that
        must fail fast (e.g. the optional self-update artifacts, which
        must never park the crack loop in the infinite-retry backoff).
        Transient failures retry per ``RetryPolicy``; permanent ones
        raise :class:`PermanentError` on the first occurrence; an OPEN
        circuit raises :class:`CircuitOpenError` for bounded callers and
        sleeps until the probe slot for unbounded ones.
        """
        limit = self.max_tries if max_tries is None else max_tries
        body = None
        headers = {}
        if data is not None:
            body = json.dumps(data).encode()
            headers["Content-Type"] = "application/json"
        endpoint = _endpoint_label(url)
        state = self.retry.start(limit)
        while True:
            if not self.breaker.allow():
                if limit:
                    raise CircuitOpenError(
                        f"transport circuit open; next probe of "
                        f"{self.base_url} in {self.breaker.remaining():.1f}s")
                # Unbounded caller: block until the probe slot — the
                # reference client would be asleep here anyway.
                self.sleep(self.breaker.remaining())
                continue
            try:
                out = self._transport(url, body, headers)
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                kind, reason = classify_error(e)
                if kind == "permanent":
                    # The server answered; a reachable server must not
                    # trip the breaker even when it rejects the request.
                    self.breaker.record_success()
                    self._note_circuit()
                    raise PermanentError(f"giving up on {url}: {e}") from e
                self.breaker.record_failure()
                self._note_circuit()
                delay = state.next_delay()
                if delay is None:
                    raise ConnectionError(f"giving up on {url}: {e}") from e
                # A 429/503 Retry-After is a floor, not a replacement:
                # jittered exponential backoff still applies above it.
                delay = max(delay, retry_after_floor(e))
                self._note_retry(endpoint, reason, delay)
                if self._obs_tracer is not None:
                    with self._obs_tracer.span("transport:retry"):
                        self.sleep(delay)
                else:
                    self.sleep(delay)
            else:
                self.breaker.record_success()
                self._note_circuit()
                return out

    def _endpoint(self, query: str) -> str:
        return self.base_url + "?" + query

    # -- protocol ops ------------------------------------------------------

    def get_work(self, dictcount: int, max_tries: int = None) -> dict:
        attempts = 0
        while True:
            with self._observed("get_work"):
                raw = self.fetch(
                    self._endpoint("get_work=" + self.hc_ver),
                    {"dictcount": dictcount},
                    max_tries=max_tries,
                )
            text = raw.decode("utf-8", "replace").strip()
            if text == "Version":
                raise VersionRejected(
                    f"server requires newer client than {self.hc_ver}")
            if text == "No nets":
                raise NoNets()
            try:
                work = json.loads(raw)
                for field in ("hkey", "dicts", "hashes"):
                    if field not in work:
                        raise ValueError(
                            f"malformed work unit: missing {field}")
                # mask shards are optional; when present each entry must
                # carry the full -s/-l frame (a truncated shard would
                # silently shrink the searched keyspace)
                for m in work.get("masks") or []:
                    missing = {"mask", "skip", "limit"} - set(m)
                    if missing:
                        raise ValueError(
                            f"malformed mask shard: missing "
                            f"{sorted(missing)}")
            except ValueError as e:
                # Truncated/garbage body: re-fetch a bounded number of
                # times (a proxy can mangle one response), then classify
                # permanent — an always-garbage server is down for us.
                attempts += 1
                if attempts > self.validation_retries:
                    raise PermanentError(
                        f"malformed get_work response after "
                        f"{attempts} attempts: {e}") from e
                self._note_retry("get_work", "bad_json", 0.0)
                continue
            return work

    def put_work(self, hkey: str, candidates: list, max_tries: int = None,
                 epoch: int = None) -> bool:
        """``candidates``: [{"k": bssid-12hex, "v": psk-hex}, ...].

        ``epoch`` echoes the lease epoch from the issuing get_work; a
        stale holder (its lease reaped and the unit reissued) then fails
        the keyed release instead of double-crediting.  None (drained
        outbox records from before the epoch era, or old servers) lets
        the server resolve the live epoch itself.
        """
        payload = {"hkey": hkey, "type": "bssid", "cand": candidates,
                   "epoch": epoch}
        if epoch is None:
            del payload["epoch"]  # byte-compatible with reference servers
        with self._observed("put_work"):
            raw = self.fetch(
                self._endpoint("put_work"),
                payload,
                max_tries=max_tries,
            )
        return raw.decode("utf-8", "replace").strip() == "OK"

    def get_prdict(self, hkey: str) -> list:
        """Fetch + gunzip the dynamic PROBEREQUEST dictionary."""
        with self._observed("prdict"):
            raw = self.fetch(
                self._endpoint("prdict=" + urllib.parse.quote(hkey)))
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        return [w for w in raw.split(b"\n") if w]

    def remote_version(self) -> str:
        """The server-published client version (self-update probe).

        Reference: GET ``hc/help_crack.py.version`` (help_crack.py:162);
        here the artifact is the package archive, so the manifest is
        ``hc/dwpa_tpu.version``.  Returns '' when the server doesn't
        publish one (non-updating deployments) — a single non-retrying
        probe, unlike ``fetch`` (a missing manifest must not spin the
        infinite-retry loop).
        """
        url = urllib.parse.urljoin(self.base_url, "hc/dwpa_tpu.version")
        try:
            return self._transport(url).decode("utf-8", "replace").strip()
        except (urllib.error.URLError, OSError, TimeoutError):
            return ""

    def download(self, url: str, dest: str, expected_md5: str = None,
                 max_tries: int = None) -> str:
        if not urllib.parse.urlparse(url).scheme:
            url = urllib.parse.urljoin(self.base_url, url)
        with self._observed("dict_download"):
            data = self.fetch(url, max_tries=max_tries)
        if expected_md5 is not None:
            got = hashlib.md5(data).hexdigest()
            if got != expected_md5:
                raise ValueError(f"md5 mismatch for {url}: {got} != {expected_md5}")
        with open(dest, "wb") as f:
            f.write(data)
        return dest
