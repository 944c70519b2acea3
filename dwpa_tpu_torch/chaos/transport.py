"""Fault-injecting and loopback raw transports.

Both classes implement the :meth:`ServerAPI._transport` callable shape —
``(url, body=None, headers=None) -> bytes``, raising the same exception
taxonomy as the real urllib hop — so they slot under the genuine
retry/classification/circuit-breaker stack rather than around it.
"""

import io
import urllib.error
import urllib.parse


class VirtualClock:
    """Deterministic time source: ``sleep`` advances ``now`` instantly.

    Wire ``now`` into ``CircuitBreaker``/``RetryPolicy`` clocks and
    ``sleep`` into ``ServerAPI.sleep`` and a chaos run consumes zero
    wall-clock on backoff while still exercising every cooldown path.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float):
        self._now += max(0.0, float(seconds))


class ChaosTransport:
    """Wrap a raw transport; inject whatever the plan schedules.

    Pre-exchange kinds (drop/timeout/http_*) raise without touching the
    inner transport — the request never "happened", matching a fault on
    the wire.  Post-exchange kinds (truncate/garbage/reject/slow) let
    the exchange complete and corrupt only the response, matching a
    fault between server and client — the server HAS processed the
    request, which is exactly the double-submission hazard the outbox
    exists for.
    """

    def __init__(self, inner, plan, sleep=None, slow_s: float = 0.05):
        self.inner = inner
        self.plan = plan
        self.sleep = sleep if sleep is not None else (lambda s: None)
        self.slow_s = slow_s

    def __call__(self, url: str, body: bytes = None, headers: dict = None) -> bytes:
        from ..client.protocol import _endpoint_label

        kind = self.plan.next_fault(_endpoint_label(url))
        if kind == "drop":
            raise ConnectionResetError("chaos: connection dropped")
        if kind == "timeout":
            raise TimeoutError("chaos: request timed out")
        if kind == "http_4xx":
            raise urllib.error.HTTPError(
                url, 404, "chaos: injected 404", None, io.BytesIO(b""))
        if kind == "http_429":
            raise urllib.error.HTTPError(
                url, 429, "chaos: injected 429",
                {"Retry-After": "2"}, io.BytesIO(b"overloaded"))
        if kind == "http_5xx":
            raise urllib.error.HTTPError(
                url, 503, "chaos: injected 503", None, io.BytesIO(b""))
        out = self.inner(url, body, headers)
        if kind == "truncate":
            return out[:len(out) // 2]
        if kind == "garbage":
            return b"\x00chaos{not-json"
        if kind == "reject":
            return b"chaos: rejected"
        if kind == "slow":
            self.sleep(self.slow_s)
        return out


class WsgiTransport:
    """Raw transport bridged to an in-process WSGI app (loopback server).

    Unlike the test-suite ``LoopbackAPI`` (which swaps out ``fetch``
    wholesale and with it the whole retry stack), this sits at the
    ``_transport`` seam: non-2xx statuses raise ``urllib.error.HTTPError``
    exactly like the real urllib hop, so classification, backoff and the
    circuit breaker run for real against an in-memory server.
    """

    def __init__(self, app):
        self.app = app
        self.requests = []  # (method, path, query) per exchange

    def __call__(self, url: str, body: bytes = None, headers: dict = None) -> bytes:
        parts = urllib.parse.urlsplit(url)
        method = "POST" if body is not None else "GET"
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": parts.path or "/",
            "QUERY_STRING": parts.query,
            "CONTENT_TYPE": (headers or {}).get("Content-Type", ""),
            "CONTENT_LENGTH": str(len(body or b"")),
            "REMOTE_ADDR": "127.0.0.1",
            "wsgi.input": io.BytesIO(body or b""),
        }
        self.requests.append((method, environ["PATH_INFO"], parts.query))
        captured = {}

        def start_response(status, headers_out):
            captured["status"] = status
            captured["headers"] = dict(headers_out)

        chunks = self.app(environ, start_response)
        data = b"".join(chunks)
        code = int(captured["status"].split()[0])
        if not 200 <= code < 300:
            # headers ride along so Retry-After reaches the retry stack
            raise urllib.error.HTTPError(
                url, code, captured["status"], captured["headers"],
                io.BytesIO(data))
        return data
