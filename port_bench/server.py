"""The dwpa server side of a cell, in process: a ``ServerAPI`` with no HTTP.

Only the raw exchange (``_transport``) is replaced, so the client's
retry, classification and telemetry stack is the real one.  It answers:

- ``?get_work``: the cell's next pre-generated unit, with its dicts'
  rules as dwpa attaches them (the first is the
  set-up's warm unit; the second opens the measured window), and once
  the window has lasted ``seconds``, ``No nets``;
- a unit's dict at its ``dpath``, as gzip bytes;
- ``?put_work``: ``OK``, with the submission recorded for the
  reference to judge once the window has closed;
- the client's update probe: no version published.

The client naps after ``No nets``; that nap ends the run
(:class:`WindowClosed`).  Like ``get_work.php`` the server hands out at
most the dicts the client asks for (its ``dictcount``, which the
client's 900 s pacing raises to 15 on any card whose units end sooner):
the window's units carry the configuration's dictcount, and a client
that asks for fewer stops the run rather than be served another unit
than the cell's.
"""

import base64
import json
import time
import urllib.parse

from dwpa_tpu_torch.client.protocol import ServerAPI

URL = "http://port-bench/"


class WindowClosed(Exception):
    """The client asked to nap after the window's ``No nets``."""


class BenchServer(ServerAPI):
    """``units[0]`` is the warm unit; ``units[1:]`` serve the window.
    ``on_open()`` runs when the window's first ``get_work`` arrives,
    before the unit is handed out."""

    def __init__(self, units, seconds, on_open=None):
        super().__init__(URL, max_tries=1, sleep=self._nap)
        self.units = units
        self.seconds = seconds
        self.on_open = on_open
        self.issued = 0
        self.t_open = None
        self.ran_out = False
        self.submissions = {}   # hkey -> [cand list of each put_work]
        self._bodies = {d.dpath: d.gz for u in units for d in u.dicts}

    def _nap(self, seconds):
        if self.t_open is not None and (self.ran_out or self.window_over()):
            raise WindowClosed
        raise RuntimeError(f"the client asked the bench server to wait {seconds} s")

    def window_over(self) -> bool:
        return time.perf_counter() - self.t_open >= self.seconds

    def _transport(self, url, body=None, headers=None):
        query = urllib.parse.urlparse(url).query
        if query.startswith("get_work="):
            return self._get_work(json.loads(body)["dictcount"])
        if query == "put_work":
            sub = json.loads(body)
            self.submissions.setdefault(sub["hkey"], []).append(sub["cand"])
            return b"OK"
        if url.endswith("hc/dwpa_tpu.version"):
            return b""
        path = urllib.parse.urlparse(url).path.lstrip("/")
        if path in self._bodies:
            return self._bodies[path]
        raise ConnectionError(f"bench server: no route to {url}")

    def _get_work(self, dictcount):
        if self.issued == 1 and self.t_open is None:
            self.t_open = time.perf_counter()
            if self.on_open is not None:
                self.on_open()
        if self.t_open is not None and self.window_over():
            return b"No nets"
        if self.issued == len(self.units):
            self.ran_out = True
            return b"No nets"
        u = self.units[self.issued]
        if len(u.dicts) > dictcount:
            raise RuntimeError(f"the client asked for {dictcount} dicts; the cell's units "
                               f"carry {len(u.dicts)}")
        self.issued += 1
        work = {"hkey": u.hkey, "epoch": 1, "hashes": u.lines,
                "dicts": [{"dhash": d.dhash, "dpath": d.dpath} for d in u.dicts]}
        if u.rules:
            work["rules"] = base64.b64encode("\n".join(u.rules).encode()).decode()
        return json.dumps(work).encode()

    def units_in_window(self):
        """The units handed out inside the window."""
        return self.units[1:self.issued]
