"""HTTP front controller (WSGI) — the web/index.php + web/content/* layer.

Routes by query-string key exactly like the reference front controller
(web/index.php:146-163), with the four machine interfaces bypassing any
HTML chrome:

- ``?get_work=<ver>``  POST {"dictcount": N} -> work-unit JSON,
  or sentinel bodies ``Version`` / ``No nets`` (get_work.php:25-27,77-81);
- ``?put_work``        POST candidate JSON -> ``OK`` / ``Nope``;
- ``?prdict=<hkey>``   gzip dynamic dictionary stream (prdict.php);
- ``?api``             cookie-keyed potfile export (api.php);
- ``?stats``           JSON stats (the machine-readable face of stats.php);
- ``?metrics``         Prometheus text-format v0.0.4 scrape of the live
  telemetry registry (``?metrics=json`` for the JSON form) — request
  counters + per-endpoint latency histograms recorded by this layer,
  scheduler/claim counters from core.py, cron-job durations from
  jobs.py, and scrape-time lease/net gauges (core.observe_metrics);
- POST file upload     capture submission (index.php:4-11 besside path /
  content/submit.php) — accepts m22000 text, gz, or pcap/pcapng captures;
- ``dict/<name>``      static dictionary downloads.

Serve with ``wsgiref.simple_server`` (tests, small sites) or any WSGI
container.
"""

import json
import gzip
import os
import re
import sqlite3
import time
import urllib.parse

from .core import OVERLOAD_RETRY_AFTER_S, Overloaded, ServerCore
from .capture import extract_hashlines

MIN_HC_VER = "2.1.1"  # oldest client protocol accepted (conf.php:29)

#: machine endpoints + UI pages a request is attributed to in
#: dwpa_http_requests_total{endpoint=...}; query keys win over paths so
#: the label set stays closed (unknown paths all land in "other").
_ENDPOINT_KEYS = ("metrics", "get_work", "put_work", "prdict", "api",
                  "stats", "home", "get_key", "my_nets", "submit", "nets",
                  "dicts", "search")


def _endpoint_label(environ, qs) -> str:
    for key in _ENDPOINT_KEYS:
        if key in qs:
            return key
    path = environ.get("PATH_INFO", "/")
    if path.startswith("/dict/"):
        return "dict"
    if path.startswith("/hc/"):
        return "hc"
    if path in ("", "/"):
        return ("capture" if environ.get("REQUEST_METHOD") == "POST"
                else "home")
    return "other"


def _version_ok(ver: str) -> bool:
    def parts(v):
        return [int(x) for x in re.findall(r"\d+", v)][:3]

    try:
        return parts(ver) >= parts(MIN_HC_VER)
    except ValueError:
        return False


class BodyTooLarge(Exception):
    """Request body exceeds the cap — reject, never silently truncate."""


def make_wsgi_app(core: ServerCore, registry=None):
    """WSGI front; every request lands in the telemetry registry
    (default: the core's — one registry per deployment) as a
    ``dwpa_http_requests_total{endpoint,status}`` count and a
    ``dwpa_http_request_seconds{endpoint}`` latency observation, and
    ``?metrics`` scrapes that same registry."""
    from ..obs import is_emitter

    registry = registry or getattr(core, "registry", None)
    if registry is None:
        from ..obs import default_registry

        registry = default_registry()
    req_count = registry.counter(
        "dwpa_http_requests_total", "HTTP requests, by endpoint and status")
    req_seconds = registry.histogram(
        "dwpa_http_request_seconds", "HTTP request latency, by endpoint")

    def app(environ, start_response):
        t0 = time.perf_counter()
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""),
                                   keep_blank_values=True)
        try:
            # root-path only, like every other query route: unknown
            # paths must stay 404 even when a ?metrics key rides along
            if "metrics" in qs and environ.get("PATH_INFO", "/") in ("", "/"):
                out = _metrics_response(core, registry, qs)
            else:
                out = _route(core, environ)
        except BodyTooLarge:
            out = ("413 Content Too Large", "text/plain", b"capture too large")
        except ValueError as e:
            out = ("400 Bad Request", "text/plain", str(e).encode())
        except Overloaded as e:
            # Admission control (core.max_inflight): shed with 429 + a
            # Retry-After the client RetryPolicy honors as its backoff
            # floor — overload composes with retries, not against them.
            out = ("429 Too Many Requests", "text/plain", b"overloaded",
                   [("Retry-After", str(max(1, round(e.retry_after))))])
        except sqlite3.OperationalError:
            # Transient DB-layer refusal ("database is locked", disk I/O):
            # the request may retry once the writer drains — a 503, not a
            # crash page, so the client classifies it transient.
            out = ("503 Service Unavailable", "text/plain", b"database busy",
                   [("Retry-After", str(OVERLOAD_RETRY_AFTER_S))])
        status, ctype, body = out[:3]
        extra_headers = list(out[3]) if len(out) > 3 else []
        endpoint = _endpoint_label(environ, qs)
        req_count.labels(endpoint=endpoint, status=status.split()[0]).inc()
        req_seconds.labels(endpoint=endpoint).observe(
            time.perf_counter() - t0)
        start_response(status, [("Content-Type", ctype),
                                ("Content-Length", str(len(body)))]
                       + extra_headers)
        return [body]

    def _metrics_response(core, registry, qs):
        # Multi-host gate: on a multi-host mesh only process 0 owns
        # emission (obs.multihost) — peers answer 404 so a fleet scrape
        # config can point at every host without double counting.
        if not is_emitter():
            return ("404 Not Found", "text/plain",
                    b"metrics served by process 0 only")
        core.observe_metrics()
        if qs["metrics"][0] == "json":
            return ("200 OK", "application/json",
                    registry.render_json().encode())
        return ("200 OK", "text/plain; version=0.0.4; charset=utf-8",
                registry.render_prometheus().encode())

    return app


def _set_key_cookie(key: str):
    return [("Set-Cookie", f"key={key}; Max-Age=2147483647; HttpOnly")]


def _clear_key_cookie():
    return [("Set-Cookie", "key=; Max-Age=0; HttpOnly")]


# Capture uploads get a much tighter body cap than the JSON/form routes:
# the reference runs behind PHP upload limits (typically single-digit MiB),
# and a 64 MiB cap x 16 concurrent workers would bound worst-case hostile
# upload memory at 1 GiB.  8 MiB holds any real-world capture; deployments
# with longer captures raise it per-core (ServerCore(capture_cap=...),
# ``serve --capture-cap``) without patching this default.
CAPTURE_BODY_CAP = 8 * 1024 * 1024


def _capture_cap(core) -> int:
    cap = getattr(core, "capture_cap", None)
    return CAPTURE_BODY_CAP if cap is None else int(cap)


def _parse_multipart(body: bytes, ctype: str):
    """Minimal multipart/form-data parser (RFC 7578 subset) for the
    browser submit form (web/content/submit.php:18-31 accepts $_FILES).

    Returns ``(fields, files)``: text fields as {name: str} and file
    parts as {name: (filename, bytes)}.  Strict on structure (missing
    boundary or malformed part -> ValueError -> 400), tolerant on
    charset (latin1 headers).
    """
    m = re.search(r'boundary="?([^";,\s]+)"?', ctype)
    if not m:
        raise ValueError("multipart body without boundary")
    delim = b"--" + m.group(1).encode("latin1")
    fields, files = {}, {}
    chunks = body.split(delim)
    if len(chunks) < 2:
        raise ValueError("multipart body without parts")
    for chunk in chunks[1:]:
        if chunk[:2] == b"--":
            break  # closing delimiter
        head, sep, content = chunk.partition(b"\r\n\r\n")
        if not sep:
            raise ValueError("malformed multipart part")
        if content.endswith(b"\r\n"):
            content = content[:-2]
        headers = head.decode("latin1")
        # Anchor ``name=`` to a parameter boundary: a bare name="..."
        # search would also match the tail of ``filename="..."``, so a
        # part ordered ``filename= ... name=`` would lose its real name.
        mname = re.search(r'(?:^|[;\s])name="([^"]*)"', headers)
        if not mname:
            continue
        mfile = re.search(r'(?:^|[;\s])filename="([^"]*)"', headers)
        if mfile:
            files[mname.group(1)] = (mfile.group(1), content)
        else:
            fields[mname.group(1)] = content.decode("utf-8", "replace")
    return fields, files


def _read_body(environ, cap=64 * 1024 * 1024) -> bytes:
    # Cached: the UI router may parse the body as a form and fall through
    # to the capture path — re-reading a socket-backed wsgi.input past the
    # request body would block the worker.  The cap still applies to the
    # cached body: the capture path's tighter limit must hold even when
    # an urlencoded route already slurped the body at the default cap.
    if "dwpa.body" in environ:
        body = environ["dwpa.body"]
        if len(body) > cap:
            raise BodyTooLarge(len(body))
        return body
    try:
        n = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        n = 0
    if n < 0:
        n = 0  # a negative length would make read() slurp the stream
    if n > cap:
        raise BodyTooLarge(n)
    body = environ["wsgi.input"].read(n) if n else b""
    environ["dwpa.body"] = body
    return body


def _route(core: ServerCore, environ):
    qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
    path = environ.get("PATH_INFO", "/")

    if path.startswith("/dict/") and core.dictdir:
        name = os.path.basename(path)
        full = os.path.join(core.dictdir, name)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                return "200 OK", "application/octet-stream", f.read()
        return "404 Not Found", "text/plain", b"no such dict"

    if path.startswith("/hc/"):
        # Client-distribution artifacts (version manifest + archive), the
        # web/hc/ static dir of the reference (help_crack.py:162,173).
        name = os.path.basename(path)
        full = os.path.join(getattr(core, "hcdir", None) or "", name)
        if getattr(core, "hcdir", None) and os.path.isfile(full):
            with open(full, "rb") as f:
                return "200 OK", "application/octet-stream", f.read()
        return "404 Not Found", "text/plain", b"no such artifact"

    if path not in ("", "/"):
        # Unknown paths must 404, not render the home page: the client's
        # update probe treats any 200 body as a version manifest.
        return "404 Not Found", "text/plain", b"not found"

    if "get_work" in qs:
        ver = qs["get_work"][0]
        if not _version_ok(ver):
            return "200 OK", "text/plain", b"Version"
        try:
            req = json.loads(_read_body(environ) or b"{}")
        except ValueError:
            req = {}
        raw_dc = req.get("dictcount", 1) if isinstance(req, dict) else 1
        try:
            dictcount = int(raw_dc)
        except (TypeError, ValueError):
            # client-supplied JSON: a non-numeric dictcount (string,
            # list, object) must get a clean 400, not a traceback —
            # int() raises TypeError on containers, which the generic
            # ValueError->400 net would NOT catch.
            return "400 Bad Request", "text/plain", b"bad dictcount"
        work = core.get_work(dictcount)
        if work is None:
            return "200 OK", "text/plain", b"No nets"
        return "200 OK", "application/json", json.dumps(work).encode()

    if "put_work" in qs:
        try:
            data = json.loads(_read_body(environ) or b"{}")
        except ValueError:
            return "200 OK", "text/plain", b"Nope"
        data.setdefault("ip", environ.get("REMOTE_ADDR", ""))
        ok = core.put_work(data)
        return "200 OK", "text/plain", b"OK" if ok else b"Nope"

    if "prdict" in qs:
        words = core.prdict_words(qs["prdict"][0])
        blob = gzip.compress(b"\n".join(words) + b"\n")
        return "200 OK", "application/octet-stream", blob

    if "api" in qs:
        key = qs.get("key", [""])[0] or _cookie_key(environ)
        lines = core.user_potfile(key)
        return "200 OK", "text/plain", ("\n".join(lines) + "\n").encode()

    if "stats" in qs and "text/html" not in environ.get("HTTP_ACCEPT", ""):
        rows = core.db.q("SELECT name, value FROM stats")
        return (
            "200 OK", "application/json",
            json.dumps({r["name"]: r["value"] for r in rows}).encode(),
        )

    # ---- browser surface (HTML CMS + user-key actions) -------------------
    resp = _route_ui(core, environ, qs)
    if resp is not None:
        return resp

    if environ["REQUEST_METHOD"] == "POST":
        # Capture submission.  Two wire shapes, one pipeline:
        # - raw body (the besside-ng direct upload, index.php:4-11);
        # - multipart/form-data from the browser submit form
        #   (content/submit.php:18-31) — the capture is the first file
        #   part (the form names it "file").
        blob = _read_body(environ, cap=_capture_cap(core))
        userkey = qs.get("key", [None])[0]
        ctype = environ.get("CONTENT_TYPE", "")
        if ctype.startswith("multipart/form-data"):
            fields, files = _parse_multipart(blob, ctype)
            part = files.get("file") or next(iter(files.values()), None)
            if part is None:
                return "400 Bad Request", "text/plain", b"no file part"
            blob = part[1]
            userkey = fields.get("key", userkey)
        if not blob:
            return "400 Bad Request", "text/plain", b"empty submission"
        report = submit_capture(core, blob,
                                ip=environ.get("REMOTE_ADDR", ""),
                                userkey=userkey)
        return "200 OK", "application/json", json.dumps(report).encode()

    return "200 OK", "text/plain", b"dwpa_tpu server"


UI_KEYS = ("home", "get_key", "my_nets", "submit", "nets", "dicts", "stats",
           "search")


def _route_ui(core: ServerCore, environ, qs):
    """The human-facing CMS (web/index.php:12-163 + web/content/*.php).

    Returns a response tuple, or None to fall through to the machine
    catch-alls.  POST bodies here are urlencoded forms; raw/multipart
    bodies stay on the capture-upload path.
    """
    from . import ui
    from .core import valid_email, valid_key

    method = environ["REQUEST_METHOD"]
    if method == "POST" and environ.get("CONTENT_TYPE", "").startswith(
        "multipart/form-data"
    ):
        # The ?submit form posts its multipart body back to /?submit
        # (content/submit.php:18-31 handles $_FILES on the same URL);
        # fall through to the capture-upload handler instead of
        # re-rendering the page over the discarded body.
        return None
    form = {}
    if method == "POST" and environ.get("CONTENT_TYPE", "").startswith(
        "application/x-www-form-urlencoded"
    ):
        form = {
            k: v[0]
            for k, v in urllib.parse.parse_qs(
                _read_body(environ).decode("utf-8", "replace"),
                keep_blank_values=True,
            ).items()
        }

    # -- key set / remove (index.php:109-142) --
    if "key" in form:
        k = form["key"].lower()
        if valid_key(k) and (
            (core.bosskey and k == core.bosskey) or core.user_key_exists(k)
        ):
            return ("302 Found", "text/plain", b"",
                    [("Location", "/")] + _set_key_cookie(k))
        return ("302 Found", "text/plain", b"",
                [("Location", "/")] + _clear_key_cookie())
    if "remkey" in form:
        return ("302 Found", "text/plain", b"",
                [("Location", "/")] + _clear_key_cookie())

    # -- key issue (index.php:14-102): optional captcha seam, then mail --
    if "mail" in form:
        ip = environ.get("REMOTE_ADDR", "")
        if core.captcha and not core.captcha(
            form.get("g-recaptcha-response", ""), ip
        ):
            return ("200 OK", "text/html",
                    ui.render(ui.page_get_key("Captcha validation failed.")))
        mail = form["mail"].strip()
        if not (core.email_check or valid_email)(mail):
            return ("200 OK", "text/html",
                    ui.render(ui.page_get_key("No valid e-mail provided!")))
        status, key = core.issue_user_key(mail, ip=ip)
        if status == "issued":
            return ("200 OK", "text/html",
                    ui.render(ui.page_get_key(
                        "User key issued. Make sure you keep it to access "
                        "the results.")),
                    _set_key_cookie(key))
        if status == "reset":
            return ("200 OK", "text/html",
                    ui.render(ui.page_get_key(
                        "New key request was submitted. Please check your "
                        "e-mail to confirm.")))
        return ("200 OK", "text/html",
                ui.render(ui.page_get_key(
                    "User key request was already submitted. Please try "
                    "again tomorrow.")))

    # -- linkkey confirmation (get_key.php:11-31) --
    if "get_key" in qs and valid_key(qs["get_key"][0].lower()):
        lk = qs["get_key"][0].lower()
        if core.confirm_linkkey(lk):
            return ("302 Found", "text/plain", b"",
                    [("Location", "/")] + _set_key_cookie(lk))
        return ("200 OK", "text/html",
                ui.render(ui.page_get_key("User key NOT set.")))

    page = next((k for k in UI_KEYS if k in qs), None)
    if page is None:
        return None

    viewer = ui.resolve_viewer(core, _cookie_key(environ))

    # -- crowdsourced PSK guesses on nets/search/my_nets (build_cand,
    #    common.php:39-53; nets.php:6-8) --
    cand = [{"k": k, "v": v} for k, v in form.items()
            if valid_key(k) and v.strip()]
    if cand:
        core.put_work({"type": "hash", "cand": cand,
                       "ip": environ.get("REMOTE_ADDR", "")})

    if page == "nets":
        body = ui.page_nets(core, viewer)
    elif page == "search":
        # ?search&search=<term>: the page key and the term share the name
        # (PHP keeps the last duplicate, search.php:13-15)
        body = ui.page_search(core, viewer, qs.get("search", [""])[-1])
    elif page == "my_nets":
        try:
            pageno = int(qs.get("page", ["1"])[0])
        except ValueError:
            pageno = 1
        body = ui.page_my_nets(core, viewer, pageno)
    elif page == "stats":
        body = ui.page_stats(core)
    elif page == "dicts":
        body = ui.page_dicts(core)
    elif page == "submit":
        body = ui.page_submit()
    elif page == "get_key":
        body = ui.page_get_key(has_key=bool(viewer.key))
    else:
        body = ui.page_home()
    return "200 OK", "text/html", ui.render(body)


def _cookie_key(environ) -> str:
    cookies = environ.get("HTTP_COOKIE", "")
    for part in cookies.split(";"):
        k, _, v = part.strip().partition("=")
        if k == "key":
            return v
    return ""


def submit_capture(core: ServerCore, blob: bytes, ip: str = "",
                   userkey: str = None) -> dict:
    """Ingest one uploaded capture (pcap/pcapng/gz or m22000 text).

    The reference shells out to hcxpcapngtool here (common.php:481); we
    parse captures natively (capture.py) and also accept pre-extracted
    hashline text so converted archives ingest directly.
    """
    if blob[:2] == b"\x1f\x8b":
        # Bounded decompression: an 8 MiB gzip bomb inflates ~1000x, so
        # an unbounded gzip.decompress would defeat the capture cap's
        # whole point (the hostile-upload memory bound).  The cap applies
        # to the decompressed capture too — no real pcap needs more.
        import io

        cap = _capture_cap(core)
        try:
            with gzip.GzipFile(fileobj=io.BytesIO(blob)) as gf:
                blob = gf.read(cap + 1)
        except (OSError, EOFError):
            raise ValueError("bad gzip")
        if len(blob) > cap:
            raise BodyTooLarge(len(blob))
    s_id = core.add_submission(blob, ip=ip)
    if blob[:4].lstrip()[:3] == b"WPA":
        lines = blob.decode("utf-8", "replace").splitlines()
        probes = []
    else:
        lines, probes = extract_hashlines(blob)
    report = core.add_hashlines(lines, s_id=s_id, ip=ip, userkey=userkey)
    if probes:
        core.add_probe_requests(probes, s_id)
        report["probes"] = len(probes)
    return report
