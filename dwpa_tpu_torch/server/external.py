"""Outward-facing HTTP/DNS integrations, behind the existing seams.

The reference ships live API clients for wigle geolocation
(web/wigle.php:30-53), the 3wifi PSK database (web/3wifi.php:27-66),
Google reCAPTCHA verification (web/index.php:16-35), and a DNS MX probe
inside validEmail (web/common.php:981-992).  This module provides the
same adapters as urllib-based callables matching the pluggable seam
shapes already used by the jobs/API layers:

- :class:`WigleClient`     -> ``jobs.geolocate``'s ``lookup(mac) -> dict|None``
- :class:`ThreeWifiClient` -> ``jobs.psk_lookup``'s ``lookup(macs) -> {mac: psk}``
- :class:`RecaptchaVerifier` -> ``ServerCore.captcha``'s ``(response, ip) -> bool``
- :func:`mx_email_validator` -> wraps ``core.valid_email`` with an MX probe

Every adapter takes a ``url`` override and an injectable ``opener`` /
``resolver`` / ``sleep`` so the full request/response path is testable
against a local stub server (this build environment has zero egress; the
defaults point at the real services).  Failure semantics mirror the
reference's: a transport/parse error or service refusal raises
``jobs.LookupUnavailable`` so the cron layer leaves the rows unmarked
for retry (wigle.php only stamps ``wiglets`` after a parsed successful
response), while a successful-but-empty answer is a definitive
"not found"; the captcha verifier fails closed.
"""

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

WIGLE_URL = "https://api.wigle.net/api/v2/network/search"
WIFI3_URL = "https://3wifi.stascorp.com/api/apiquery"
RECAPTCHA_URL = "https://www.google.com/recaptcha/api/siteverify"
USER_AGENT = "wpa-sec"  # the reference identifies itself as wpa-sec


def _fetch(req, opener=None, timeout=30):
    """GET/POST ``req`` and parse the JSON body.

    Transport and parse failures raise :class:`jobs.LookupUnavailable`
    so the cron layer retries the same rows next tick instead of
    marking them attempted — the reference only stamps its
    wiglets/wifi3ts timestamps after a parsed, successful response
    (wigle.php:33-49, 3wifi.php:50-79)."""
    from .jobs import LookupUnavailable

    opener = opener or urllib.request.urlopen
    try:
        with opener(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise LookupUnavailable(str(e))


class _Throttle:
    """Min-interval limiter (wigle.php:53 sleeps 1 s between queries)."""

    def __init__(self, interval_s, sleep=time.sleep, clock=time.monotonic):
        self.interval_s = interval_s
        self._sleep = sleep
        self._clock = clock
        self._last = None

    def wait(self):
        now = self._clock()
        if self._last is not None:
            remaining = self.interval_s - (now - self._last)
            if remaining > 0:
                self._sleep(remaining)
                now = self._clock()
        self._last = now


class WigleClient:
    """wigle.net network-search geolocation (wigle.php:30-53).

    ``__call__(mac: bytes) -> dict | None`` — the ``jobs.geolocate``
    lookup seam.  GET ``?netid=AA:BB:CC:DD:EE:FF`` with Basic auth; a
    unique result (resultCount == 1) maps to the bssids-row fields, any
    other answer is None (the reference then only refreshes the
    attempt timestamp).
    """

    def __init__(self, api_key: str, url: str = WIGLE_URL, *,
                 throttle_s: float = 1.0, opener=None, sleep=time.sleep):
        self.api_key = api_key
        self.url = url
        self.opener = opener
        self.throttle = _Throttle(throttle_s, sleep=sleep)

    def __call__(self, mac: bytes):
        self.throttle.wait()
        netid = ":".join("%02x" % b for b in mac)
        req = urllib.request.Request(
            self.url + "?" + urllib.parse.urlencode({"netid": netid}),
            headers={
                "Content-Type": "application/json",
                "User-Agent": USER_AGENT,
                "Authorization": "Basic " + self.api_key,
            },
        )
        data = _fetch(req, self.opener)
        if not data or not data.get("success"):
            # service-side refusal (quota, auth): retryable, not "no hit"
            from .jobs import LookupUnavailable

            raise LookupUnavailable("wigle answered without success=true")
        if data.get("resultCount") != 1 or not data.get("results"):
            return None
        r = data["results"][0]
        return {
            "lat": r.get("trilat"),
            "lon": r.get("trilong"),
            "country": r.get("country"),
            "region": r.get("region"),
            "city": r.get("city"),
        }


class ThreeWifiClient:
    """3wifi batch PSK lookup (3wifi.php:40-66).

    ``__call__(macs: list[bytes]) -> {mac_bytes: psk_bytes}`` — the
    ``jobs.psk_lookup`` seam; answers flow through the normal put_work
    re-verification, exactly like the reference submits them.
    """

    def __init__(self, api_key: str, url: str = WIFI3_URL, *, opener=None):
        self.api_key = api_key
        self.url = url
        self.opener = opener

    def __call__(self, macs):
        if not macs:
            return {}
        payload = json.dumps({
            "key": self.api_key,
            "bssid": [mac.hex() for mac in macs],
        }).encode()
        req = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json",
                     "User-Agent": USER_AGENT},
        )
        data = _fetch(req, self.opener)
        if not data or not data.get("result"):
            from .jobs import LookupUnavailable

            raise LookupUnavailable("3wifi answered without result=true")
        out = {}
        entries = data.get("data") or {}
        # the reference iterates data values, each a list of candidate
        # rows, and takes the first row's bssid/key (3wifi.php:52-58)
        if isinstance(entries, dict):
            entries = entries.values()
        for d in entries:
            try:
                row = d[0] if isinstance(d, list) else d
                mac = bytes.fromhex(row["bssid"].replace(":", "").lower())
                key = row["key"]
            except (KeyError, TypeError, ValueError, IndexError,
                    AttributeError):
                continue  # empty list / malformed row (e.g. numeric bssid)
            if len(mac) == 6 and key:
                out[mac] = key.encode() if isinstance(key, str) else key
        return out


class RecaptchaVerifier:
    """Google reCAPTCHA siteverify (index.php:16-35).

    ``__call__(response, ip) -> bool`` — the ``ServerCore.captcha`` seam.
    POSTs the urlencoded secret/response/remoteip form and accepts only
    an explicit ``success: true``.
    """

    def __init__(self, secret: str, url: str = RECAPTCHA_URL, *, opener=None):
        self.secret = secret
        self.url = url
        self.opener = opener

    def __call__(self, response: str, ip: str = "") -> bool:
        body = urllib.parse.urlencode({
            "secret": self.secret,
            "response": response or "",
            "remoteip": ip or "",
        }).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/x-www-form-urlencoded",
                     "User-Agent": USER_AGENT},
        )
        from .jobs import LookupUnavailable

        try:
            data = _fetch(req, self.opener)
        except LookupUnavailable:
            return False  # unreachable verifier: fail closed, like the reference
        return bool(data and data.get("success") is True)


def mx_email_validator(resolver=None):
    """Build a ``valid_email``-shaped callable with the reference's MX
    probe (validEmail, common.php:981-992): format check first, then
    ``checkdnsrr(domain., 'MX')``.

    ``resolver(domain: str) -> bool`` answers "does this domain have an
    MX record".  The stdlib cannot issue MX queries; the default
    resolver shells out to ``getent``-independent ``nslookup -type=MX``
    if available and otherwise accepts the domain (fail-open, so an
    airgapped deployment does not lock every user out).
    """
    from .core import valid_email as format_ok

    if resolver is None:
        resolver = _nslookup_mx

    def check(mail: str) -> bool:
        if not format_ok(mail):
            return False
        domain = mail.rsplit("@", 1)[1]
        try:
            return bool(resolver(domain))
        except Exception:
            return True  # resolver trouble must not block key issuance

    return check


def _nslookup_mx(domain: str) -> bool:
    import shutil
    import subprocess

    exe = shutil.which("nslookup")
    if exe is None:
        return True  # no resolver tooling: fail open
    # LANG/LC_ALL=C: _parse_mx_output matches English resolver strings
    # ("can't find", "non-existent domain") — under a non-English locale
    # the negatives would never match and every probe would fail open.
    out = subprocess.run(
        [exe, "-type=MX", domain + "."],
        capture_output=True, text=True, timeout=10,
        env={**os.environ, "LANG": "C", "LC_ALL": "C"},
    )
    return _parse_mx_output(out.stdout + out.stderr)


def _parse_mx_output(text: str) -> bool:
    """Decide MX presence from resolver output.

    Only an affirmative "domain does not resolve" rejects the address;
    anything else (busybox nslookup without -type support, odd output
    formats) fails open — a present-but-incompatible resolver must not
    silently lock every user out of key issuance.
    """
    text = text.lower()
    if "mail exchanger" in text:
        return True
    negatives = ("nxdomain", "can't find", "no servers could be reached",
                 "server can't", "non-existent domain")
    return not any(n in text for n in negatives)
