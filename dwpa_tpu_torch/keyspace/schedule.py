"""Server-side smart-keyspace helpers.

The scheduler pieces that live above the compiler: the compiled-mask
cache keyed by pass_regex, ssid-regex matching against net ESSIDs,
first-gap coverage math over ``n2m`` shard intervals, and the keyspace
progress totals shared by maintenance stats and ``observe_metrics``.
Pure functions over the Database plus one small cache object — the
ServerCore owns the locking and transactions.
"""

import re
import threading

from ..obs import get_logger
from .compiler import KeyspaceError, compile_pass_regex

_log = get_logger(__name__)


class MaskCache:
    """Compiled-mask cache keyed by pass_regex.

    Compilation is pure and deterministic, so entries never invalidate.
    Uncompilable patterns cache as misses (logged once) so a bad ks row
    costs one compile attempt, not one per get_work — ``ks_add``
    validates loudly at admin time, this cache only has to stay robust
    against rows inserted behind its back.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._ok = {}
        self._bad = set()
        self.compiles = 0  # cold compile count (warm lookups leave it flat)

    def get(self, pass_regex):
        """CompiledKeyspace for ``pass_regex``, or None if uncompilable."""
        with self._lock:
            hit = self._ok.get(pass_regex)
            if hit is not None:
                return hit
            if pass_regex in self._bad:
                return None
        try:
            ck = compile_pass_regex(pass_regex)
        except KeyspaceError as e:
            _log.warning("skipping uncompilable ks row: %s", e)
            with self._lock:
                self._bad.add(pass_regex)
            return None
        with self._lock:
            self.compiles += 1
            self._ok[pass_regex] = ck
        return ck

    def keyspace(self, pass_regex):
        ck = self.get(pass_regex)
        return ck.keyspace if ck is not None else 0


def ks_matches(ks_rows, ssid):
    """The ks rows whose ssid_regex matches ``ssid`` (latin1-decoded,
    ``re.search`` semantics — admins anchor with ``^...$`` when they
    mean whole-ESSID), in the given order.  Rows with a broken
    ssid_regex are skipped (``ks_add`` rejects them up front; this
    guards rows edited behind the API)."""
    text = (ssid.decode("latin1")
            if isinstance(ssid, (bytes, bytearray)) else str(ssid))
    out = []
    for r in ks_rows:
        try:
            if re.search(r["ssid_regex"], text):
                out.append(r)
        except re.error:
            continue
    return out


def next_uncovered(rows, keyspace, span, extra=()):
    """First uncovered ``(skip, limit)`` range of at most ``span``
    candidates, or None when ``[0, keyspace)`` is fully covered.

    ``rows`` are n2m coverage rows (mappings with ``skip``/``span``);
    ``extra`` carries ``(skip, span)`` pairs allocated earlier in the
    same planning pass but not yet inserted.  Reaped ranges are DELETEd
    rather than flagged, so abandoned work reappears here as a gap and
    gets re-issued.
    """
    ivals = sorted([(r["skip"], r["span"]) for r in rows] + list(extra))
    pos = 0
    for s, n in ivals:
        if s > pos:
            return pos, min(span, s - pos)
        pos = max(pos, s + n)
    if pos < keyspace:
        return pos, min(span, keyspace - pos)
    return None


def mask_keyspace_totals(db, cache):
    """(total, done) scheduled-mask keyspace counters.

    ``total``: summed compiled keyspace of every enabled ks row matched
    against every uncracked net's ESSID — the mask analog of
    ``uncracked × Σ wcount``.  ``done``: summed span of completed
    (lease-released, ``hkey IS NULL``) n2m coverage rows; rows of
    cracked nets are deleted by ``_mark_cracked``, so done tracks work
    retired against still-open nets.
    """
    ks_rows = db.q("SELECT * FROM ks WHERE enabled = 1")
    total = 0
    if ks_rows:
        per_ssid = {}
        for net in db.q("SELECT ssid FROM nets WHERE n_state = 0"):
            ssid = net["ssid"]
            if ssid not in per_ssid:
                per_ssid[ssid] = sum(cache.keyspace(r["pass_regex"])
                                     for r in ks_matches(ks_rows, ssid))
            total += per_ssid[ssid]
    done = db.q1(
        "SELECT COALESCE(SUM(span), 0) c FROM n2m WHERE hkey IS NULL")["c"]
    return total, done
