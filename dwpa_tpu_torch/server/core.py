"""Server business logic: ingestion, scheduling, result acceptance.

The functional equivalent of the reference's core library (web/common.php)
and work API (web/content/get_work.php, put_work.php), re-homed on sqlite:

- ``add_hashlines`` / ``submit_capture``: the ingestion pipeline
  (submission(), common.php:470-718): dedup by net identity, zero-PMK
  probe, cross-crack against already-cracked siblings, batch insert,
  PROBEREQUEST bookkeeping, user association;
- ``get_work``: the scheduler (get_work.php): pick the least-tried oldest
  released net, its untried smallest dicts, group every uncracked same-SSID
  net into the unit, lease coverage rows in n2d under a fresh hkey;
- ``put_work``: result acceptance (common.php:849-959): every claimed PSK
  is independently re-verified (oracle.check_key_m22000, full-width NC),
  then the cracked PMK is replayed against siblings sharing ssid/bssid/
  mac_sta without re-running PBKDF2; an ESSID-mismatched sibling (a
  "broken essid" net that verifies with the wrong ESSID's PMK) is
  cascade-deleted;
- maintenance & keygen jobs live in jobs.py.

Every verify loop routes through ``precrack.verify_batch`` (lint rule
DW115): PBKDF2 for a whole claim/sibling wave derives in one batched
dispatch, and each verdict is finished by the pure-Python oracle with the
derived PMK injected — bit-identical to the per-candidate oracle, on host
or device.
"""

import base64
import hashlib
import os
import re
import secrets
import sqlite3
import threading
import time

from ..keyspace import MaskCache, compile_pass_regex
from ..keyspace.schedule import ks_matches, mask_keyspace_totals, next_uncovered
from ..models import hashline as hl
from ..oracle import m22000 as oracle
from ..utils.fsio import fsync_replace
from .db import Database, mac2long, now
from .precrack import PmkBatcher, verify_batch

MAX_CANDS_PER_PUT = 200     # put_work cap (reference: common.php:937)
MAX_DICTCOUNT = 15          # dictcount clamp (get_work.php:41-46)
LEASE_REAP_S = 3 * 3600     # stale work-unit reclaim (maint.php:36)
SERVER_NC = 128             # server-side NC search width (common.php:157)
MAX_INFLIGHT = 4096         # default bound on live work-unit leases
MASK_SHARD_SPAN = 2_000_000  # candidates per mask shard (~8 s/chip @264k/s)
OVERLOAD_RETRY_AFTER_S = 2  # Retry-After hint handed to shed clients
LEASE_RETENTION_S = 7 * 86400  # released/reaped lease rows kept this long


class Overloaded(Exception):
    """get_work admission control refused: the live-lease count is at the
    in-flight cap.  The WSGI layer answers 429 + ``Retry-After`` (which
    the client RetryPolicy honors as a backoff floor)."""

    def __init__(self, retry_after: float = OVERLOAD_RETRY_AFTER_S):
        super().__init__(f"work-unit leases at capacity; "
                         f"retry after {retry_after:.0f}s")
        self.retry_after = retry_after


class WorkQueue:
    """Precomputed issuable-target queue with sharded-lock pop.

    The materializer (inline on miss, or the background refill thread /
    jobs tick) runs the scheduling scan ONCE for a batch of targets;
    ``get_work`` then pops candidate net_ids in O(1) instead of
    re-running the ORDER BY hits,ts scan per request.  Entries are
    hints, not reservations — every pop is revalidated (net still
    uncracked/released, untried dicts remain) inside the issuing
    transaction, so staleness costs a retry, never correctness.

    Push/pop distribute round-robin over ``shards`` deques, each behind
    its own lock, so concurrent poppers do not serialize on one mutex;
    ordering is approximately FIFO (exact enough for the scheduler,
    whose order is a heuristic to begin with).
    """

    def __init__(self, shards: int = 8):
        self._shards = [[] for _ in range(max(1, int(shards)))]
        self._locks = [threading.Lock() for _ in self._shards]
        self._push = 0  # monotonic counters; races only skew round-robin
        self._pop = 0

    def __len__(self):
        return sum(len(s) for s in self._shards)

    def push_many(self, items):
        for it in items:
            i = self._push % len(self._shards)
            self._push += 1
            with self._locks[i]:
                self._shards[i].append(it)

    def pop(self):
        n = len(self._shards)
        start = self._pop
        self._pop += 1
        for off in range(n):
            i = (start + off) % n
            with self._locks[i]:
                if self._shards[i]:
                    return self._shards[i].pop(0)
        return None

    def discard(self, items):
        """Drop queued hints (e.g. every member of a just-leased SSID
        group): a sibling hint left behind would out-rank a never-tried
        net on the next pop, diverging from the scan's min-hits order."""
        drop = set(items)
        for i in range(len(self._shards)):
            with self._locks[i]:
                self._shards[i] = [x for x in self._shards[i]
                                   if x not in drop]

    def clear(self):
        for i in range(len(self._shards)):
            with self._locks[i]:
                self._shards[i].clear()


def gen_key() -> str:
    """16 random bytes hex — hkey/userkey format (common.php:976-978)."""
    return secrets.token_hex(16)


VALID_KEY_RE = re.compile(r"^[a-f0-9]{32}$")

#: scheduler locks keyed by absolute DB path: every ServerCore over the
#: same file database (e.g. the serving core and the --with-jobs cron
#: core) must share ONE mutex, or their n2d mutations could interleave
#: across connections.  :memory: handles are distinct databases, so each
#: gets its own lock.
_SCHED_LOCKS = {}


class _SchedLock:
    """Scheduler mutex for file-backed DBs: thread RLock + fcntl flock.

    The reference's lockfile is cross-*process* (create_lock,
    common.php:320-332) and the documented deployment here runs ``serve``
    and ``jobs`` as separate processes, so a thread lock alone leaves the
    n2d lease/delete interleaving unsynchronized between them.  The flock
    on ``<db>.getwork.lock`` extends the critical section across
    processes; the RLock keeps it reentrant and thread-safe within one.
    The OS drops a flock automatically if the holder dies — no 60 s
    staleness heuristic needed (the reference's TODO at common.php:319
    asked for exactly this).
    """

    def __init__(self, db_path: str):
        self._tl = threading.RLock()
        self._path = db_path + ".getwork.lock"
        self._fd = None
        self._depth = 0  # mutated only while holding _tl

    def __enter__(self):
        self._tl.acquire()
        self._depth += 1
        if self._depth == 1:
            try:
                import fcntl
            except ImportError:
                return self  # no fcntl (Windows): thread-only, like r2
            try:
                self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(self._fd, fcntl.LOCK_EX)
            except BaseException:
                # A failed open/flock (read-only dir, ENOSPC) must error
                # this one request, not leave the RLock held forever.
                self._depth -= 1
                if self._fd is not None:
                    os.close(self._fd)
                    self._fd = None
                self._tl.release()
                raise
        return self

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0 and self._fd is not None:
            import fcntl

            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
        self._tl.release()
        return False


def valid_key(key: str) -> bool:
    """32 lowercase-hex chars (web/index.php:105-107)."""
    return isinstance(key, str) and bool(VALID_KEY_RE.match(key.lower()))


def valid_email(mail: str) -> bool:
    """Format check (the reference adds a DNS MX probe, common.php:981-992;
    that needs egress, so it stays out of the core path)."""
    return isinstance(mail, str) and bool(
        re.match(r"^[^@\s]+@[^@\s.]+(\.[^@\s.]+)+$", mail)
    )


class ServerCore:
    def __init__(self, db: Database, dictdir: str = None, capdir: str = None,
                 mailer=None, bosskey: str = None, captcha=None,
                 base_url: str = "", hcdir: str = None,
                 capture_cap: int = None, registry=None,
                 max_inflight: int = None, use_queue: bool = True,
                 queue_batch: int = 256):
        from ..obs import default_registry

        self.db = db
        # Admission control: get_work sheds load (Overloaded -> HTTP 429)
        # once this many work-unit leases are live.  None -> MAX_INFLIGHT;
        # 0 disables the cap.
        self.max_inflight = MAX_INFLIGHT if max_inflight is None else max_inflight
        # Precomputed issuable-target queue (None = legacy per-request
        # scheduling scan; bench:server_load compares the two paths).
        self.queue = WorkQueue() if use_queue else None
        self.queue_batch = queue_batch
        # Telemetry sink shared by the WSGI front (api.make_wsgi_app
        # reuses it), the scheduler counters below, and the cron jobs
        # (jobs.py); injectable so tests get isolated registries.
        self.registry = registry or default_registry()
        self._m_issued = self.registry.counter(
            "dwpa_server_work_issued_total", "work units handed to volunteers")
        self._m_claims = self.registry.counter(
            "dwpa_server_claims_total",
            "put_work candidate claims, by verification verdict")
        self._m_overload = self.registry.counter(
            "dwpa_server_overload_rejects_total",
            "get_work requests shed by the in-flight lease cap (HTTP 429)")
        # The batched-verify seam (precrack.verify_batch) every accept /
        # ingest / replay verdict goes through.  Store-less and host-mode
        # by default: claim verdicts stay bit-identical to the scalar
        # oracle with no cache trust involved.
        self.verifier = PmkBatcher(device="off")
        # Optional PrecrackEngine (server/__main__ wires it when the
        # pre-crack job is enabled): when set, add_hashlines sweeps
        # freshly ingested nets immediately after the commit.
        self.precrack = None
        self.dictdir = dictdir
        self.capdir = capdir
        # Upload size bound for captures (raw AND gzip-decompressed);
        # None -> api.CAPTURE_BODY_CAP's 8 MiB default.  The reference's
        # analog is the PHP upload limit — deployment-tunable, so this
        # is too (serve --capture-cap).
        self.capture_cap = capture_cap
        # Smart keyspace (ROADMAP 4): compiled-mask cache keyed by
        # pass_regex (compilation is pure, so one cache serves every
        # request thread) and the per-shard candidate budget — each
        # mask shard occupies one dictcount slot in a work unit.
        self._ks_cache = MaskCache()
        self.mask_shard_span = MASK_SHARD_SPAN
        self.hcdir = hcdir            # client-distribution dir (web/hc/)
        self.mailer = mailer          # mail.Mailer or None (delivery skipped)
        self.bosskey = bosskey        # 32-hex superuser key (conf.php)
        self.captcha = captcha        # callable(response, ip) -> bool, or None
        self.base_url = base_url      # public URL for mailed links
        # Optional e-mail validator override (e.g. external.mx_email_validator
        # adds the reference's DNS MX probe); None -> plain format check.
        self.email_check = None
        # Global mutex around the scheduler's shared state, the
        # reference's SHM lockfile (create_lock('get_work.lock'),
        # get_work.php:49): get_work's target-select + lease-record must
        # be atomic vs other volunteers AND vs the n2d-mutating crack
        # paths (_mark_cracked/_delete_net), or a concurrent accept
        # could interleave with the lease inserts and orphan rows for a
        # cracked net.  RLock semantics: accept paths may nest.  Shared
        # across every core on the same file DB (_SCHED_LOCKS) and — via
        # an fcntl flock — across separate serve/jobs processes.
        if db.path == ":memory:":
            self._getwork_lock = threading.RLock()
        else:
            self._getwork_lock = _SCHED_LOCKS.setdefault(
                os.path.abspath(db.path), _SchedLock(os.path.abspath(db.path))
            )

    # ------------------------------------------------------------------
    # Ingestion
    # ------------------------------------------------------------------

    def add_submission(self, blob: bytes, ip: str = "") -> int:
        """Record a capture file (md5-dedup); returns s_id."""
        md5 = hashlib.md5(blob).digest()
        row = self.db.q1("SELECT s_id FROM submissions WHERE hash = ?", (md5,))
        if row:
            return row["s_id"]
        localfile = None
        if self.capdir:
            # Dated archive layout CAP/Y/m/d/<md5> (common.php:492-494,
            # 507-514); flat legacy dirs migrate via the reorder-captures
            # CLI (the reference's misc/reorder_by_date.sh).
            day = time.strftime("%Y/%m/%d")
            os.makedirs(os.path.join(self.capdir, day), exist_ok=True)
            localfile = os.path.join(self.capdir, day, md5.hex())
            # tmp + fsync + rename (fsio): the DB row inserted below must
            # never point at a torn capture file after a crash — the
            # final name either holds the complete blob or nothing.
            tmp = "%s.tmp.%d.%x" % (localfile, os.getpid(),
                                    threading.get_ident())
            with open(tmp, "wb") as f:
                f.write(blob)
            fsync_replace(tmp, localfile)
        # OR IGNORE + re-select: under the threaded server two identical
        # uploads can both pass the dedup SELECT; the UNIQUE(hash) row
        # must win quietly, not 500 the second client.
        self.db.x(
            "INSERT OR IGNORE INTO submissions(localfile, hash, ip) "
            "VALUES (?, ?, ?)",
            (localfile, md5, ip),
        )
        return self.db.q1(
            "SELECT s_id FROM submissions WHERE hash = ?", (md5,)
        )["s_id"]

    def add_hashlines(self, lines, s_id: int = None, ip: str = "",
                      userkey: str = None) -> dict:
        """Ingest parsed/parsable m22000 lines; returns a report dict.

        The whole batch — per-line net inserts plus the user association
        — commits as ONE transaction: a crash mid-ingestion leaves no
        half-recorded submission (nets without their n2u rows, or a
        partial batch that would double-count on replay).  When a
        pre-crack engine is wired (``self.precrack``), fresh nets get
        their fused candidate sweep immediately after the commit — the
        sweep takes its own locks/transactions, so it must never run
        inside this one.
        """
        with self.db.tx():
            report = self._add_hashlines_tx(lines, s_id, ip, userkey)
        new_ids = report.pop("new_ids")
        if self.precrack is not None and new_ids:
            self.precrack.on_ingest(new_ids)
        return report

    def _add_hashlines_tx(self, lines, s_id, ip, userkey) -> dict:
        report = {"new": 0, "dup": 0, "bad": 0, "precracked": 0}
        new_ids = []
        for line in lines:
            try:
                h = line if isinstance(line, hl.Hashline) else hl.parse(line)
            except ValueError:
                report["bad"] += 1
                continue
            if h.hash_type == hl.TYPE_EAPOL and h.keyver not in (1, 2, 3):
                report["bad"] += 1
                continue
            key_id = h.key_id()
            if self.db.q1("SELECT 1 FROM nets WHERE hash = ?", (key_id,)):
                report["dup"] += 1
                continue

            n_state, passb, pmk, algo, nc, endian = 0, None, None, None, None, None
            # zero-PMK probe: some broken APs derive everything from an
            # all-zero PMK (ingest-time check, common.php:592-600)
            z = verify_batch([(h, [b""], b"\x00" * 32)], nc=SERVER_NC,
                             batcher=self.verifier)[0]
            if z:
                n_state, passb, pmk, algo = 1, b"", z[3], "ZeroPMK"
                nc, endian = z[1] or 0, z[2] or ""
                report["precracked"] += 1
            else:
                # cross-crack: replay PMKs of cracked siblings (same ssid /
                # bssid / mac_sta) before volunteers ever see this net —
                # every sibling hash verified in ONE batched dispatch
                sibs = [s for s in self._handshakes_like(h, n_state=1)
                        if s["pmk"] is not None]
                checks = verify_batch(
                    [(h, [s["pass"] or b""], s["pmk"]) for s in sibs],
                    nc=SERVER_NC, batcher=self.verifier)
                for sib, r in zip(sibs, checks):
                    if r:
                        n_state = 1
                        passb, nc, endian, pmk = sib["pass"], r[1] or 0, r[2] or "", r[3]
                        report["precracked"] += 1
                        break

            cur = self.db.x(
                """INSERT OR IGNORE INTO nets
                   (s_id, bssid, mac_sta, ssid, pass, pmk, algo, hash, struct,
                    message_pair, keyver, nc, endian, sip, n_state)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (s_id, mac2long(h.mac_ap), mac2long(h.mac_sta), h.essid,
                 passb, pmk, algo, key_id, h.raw, h.message_pair, h.keyver,
                 nc, endian, ip, n_state),
            )
            if cur.rowcount:
                report["new"] += 1
                new_ids.append(cur.lastrowid)
        if userkey and new_ids:
            self.associate_user(userkey, new_ids)
        # internal: popped by add_hashlines before the report leaves the
        # core (feeds the post-commit pre-crack ingestion sweep)
        report["new_ids"] = new_ids
        return report

    def add_probe_requests(self, ssids, s_id: int):
        """PROBEREQUEST ssids -> prs/p2s (source of the dynamic dict)."""
        with self.db.tx():
            for ssid in ssids:
                if not ssid or len(ssid) > 32:
                    continue
                self.db.x("INSERT OR IGNORE INTO prs(ssid) VALUES (?)", (ssid,))
                p = self.db.q1("SELECT p_id FROM prs WHERE ssid = ?", (ssid,))
                self.db.x(
                    "INSERT OR IGNORE INTO p2s(p_id, s_id) VALUES (?, ?)",
                    (p["p_id"], s_id),
                )

    def associate_user(self, userkey: str, net_ids):
        u = self.db.q1("SELECT u_id FROM users WHERE userkey = ?", (userkey,))
        if not u:
            return
        with self.db.tx():
            for nid in net_ids:
                self.db.x(
                    "INSERT OR IGNORE INTO n2u(net_id, u_id) VALUES (?, ?)",
                    (nid, u["u_id"]),
                )

    def _handshakes_like(self, h: hl.Hashline, n_state: int):
        """Nets sharing ssid OR bssid OR mac_sta (PMK-reuse candidates,
        common.php:335-351)."""
        return self.db.q(
            """SELECT * FROM nets
               WHERE (ssid = ? OR bssid = ? OR mac_sta = ?) AND n_state = ?""",
            (h.essid, mac2long(h.mac_ap), mac2long(h.mac_sta), n_state),
        )

    # ------------------------------------------------------------------
    # Dictionaries
    # ------------------------------------------------------------------

    def add_dict(self, dpath: str, dname: str, dhash: str, wcount: int,
                 rules: str = None) -> int:
        cur = self.db.x(
            "INSERT INTO dicts(dpath, dname, dhash, rules, wcount) VALUES (?,?,?,?,?)",
            (dpath, dname, dhash, rules, wcount),
        )
        return cur.lastrowid

    # ------------------------------------------------------------------
    # Smart keyspace: the ks table
    # ------------------------------------------------------------------

    def ks_add(self, ssid_regex: str, pass_regex: str, priority: int = 0,
               enabled: bool = True) -> int:
        """Register an ssid-regex -> pass-regex keyspace row.

        Validation is loud and up-front: a broken ssid_regex raises
        ``re.error`` and an uncompilable pass_regex raises
        :class:`..keyspace.KeyspaceError` — a row never lands in ks
        unless the scheduler can actually turn it into mask shards.
        """
        re.compile(ssid_regex)
        compile_pass_regex(pass_regex)
        cur = self.db.x(
            "INSERT INTO ks(ssid_regex, pass_regex, priority, enabled) "
            "VALUES (?, ?, ?, ?)",
            (ssid_regex, pass_regex, int(priority), 1 if enabled else 0),
        )
        return cur.lastrowid

    def ks_rows(self, enabled_only: bool = True):
        """ks rows in scheduling order (priority DESC, then insertion)."""
        where = "WHERE enabled = 1 " if enabled_only else ""
        return self.db.q(
            f"SELECT * FROM ks {where}ORDER BY priority DESC, ks_id")

    # ------------------------------------------------------------------
    # The scheduler: get_work
    # ------------------------------------------------------------------

    def get_work(self, dictcount: int) -> dict:
        """Build one work unit or return None ("No nets").

        Held under the global get_work mutex (the reference's SHM lock,
        get_work.php:49,138) AND inside one ``db.tx()``: target selection
        and lease recording are atomic with respect to other volunteers,
        and a kill at any statement boundary either issues the whole
        unit (lease row + every coverage row) or nothing.
        Raises :class:`Overloaded` when live leases hit ``max_inflight``.
        """
        with self._getwork_lock:
            with self.db.tx():
                if self.max_inflight:
                    live = self.db.q1(
                        "SELECT COUNT(*) c FROM leases WHERE state = 0")["c"]
                    if live >= self.max_inflight:
                        self._m_overload.inc()
                        raise Overloaded()
                work = self._get_work_locked(dictcount)
        if work is not None:
            self._m_issued.inc()
        return work

    def _get_work_locked(self, dictcount: int) -> dict:
        dictcount = max(1, min(MAX_DICTCOUNT, int(dictcount)))
        for target in self._targets():
            work = self._lease_unit(target, dictcount)
            if work is not None:
                return work
        return None

    def _targets(self):
        """Candidate scheduling targets, best first.

        Queue path: pop precomputed net_ids (each revalidated against the
        live row — pops are hints) and refill inline at most once when
        the queue runs dry, so correctness never depends on the
        background materializer being alive.  Scan path (queue is None):
        the legacy per-request ORDER BY hits,ts scan.
        """
        if self.queue is None:
            target = self.db.q1(
                """SELECT net_id, ssid FROM nets
                   WHERE n_state = 0 AND algo = ''
                   ORDER BY hits, ts LIMIT 1"""
            )
            if target:
                yield target
            return
        refilled = False
        while True:
            net_id = self.queue.pop()
            if net_id is None:
                if refilled:
                    return
                refilled = True
                self.materialize_queue()
                continue
            row = self.db.q1(
                """SELECT net_id, ssid FROM nets
                   WHERE net_id = ? AND n_state = 0 AND algo = ''""",
                (net_id,),
            )
            if row is not None:
                yield row

    def materialize_queue(self, limit: int = None) -> int:
        """Run the scheduling scan once and queue a batch of issuable
        targets (uncracked, released, with at least one untried dict) in
        scheduler order.  Called inline when the queue runs dry and by
        the background materializer (jobs tick / serve refill thread).
        Returns the number of targets queued."""
        if self.queue is None:
            return 0
        if len(self.queue) > 0:
            return 0  # refill only from empty: stale entries age out fast
        batch = limit or self.queue_batch
        rows = self.db.q(
            """SELECT net_id FROM nets
               WHERE n_state = 0 AND algo = ''
                 AND hits < (SELECT COUNT(*) FROM dicts)
               ORDER BY hits, ts LIMIT ?""",
            (batch,),
        )
        ids = [r["net_id"] for r in rows]
        if len(ids) < batch:
            # dict-exhausted nets stay issuable while a matching ks row
            # has uncovered mask keyspace (entries are hints — the
            # pop-side revalidation and _plan_mask_shards' coverage walk
            # keep staleness from double-issuing)
            ids += self._mask_eligible(batch - len(ids), exclude=ids)
        self.queue.push_many(ids)
        return len(ids)

    def _mask_eligible(self, limit: int, exclude=()) -> list:
        """net_ids whose dicts are exhausted but whose matching ks rows
        still have uncovered mask keyspace, scheduler order."""
        ks = self.db.q("SELECT * FROM ks WHERE enabled = 1 "
                       "ORDER BY priority DESC, ks_id")
        if not ks:
            return []
        out, skip = [], set(exclude)
        for r in self.db.q(
            """SELECT net_id, ssid FROM nets
               WHERE n_state = 0 AND algo = ''
                 AND hits >= (SELECT COUNT(*) FROM dicts)
               ORDER BY hits, ts"""
        ):
            if len(out) >= limit:
                break
            if r["net_id"] in skip:
                continue
            total = sum(self._ks_cache.keyspace(k["pass_regex"])
                        for k in ks_matches(ks, r["ssid"]))
            if total == 0:
                continue
            covered = self.db.q1(
                "SELECT COALESCE(SUM(span), 0) c FROM n2m WHERE net_id = ?",
                (r["net_id"],))["c"]
            if covered < total:
                out.append(r["net_id"])
        return out

    def _lease_unit(self, target, dictcount: int) -> dict:
        """Issue one epoch-leased unit for ``target``, or None when the
        target has neither untried dicts nor uncovered mask keyspace
        left (caller moves to the next target).  Runs inside the
        caller's transaction (tx() nests).

        Dict shards fill first (smallest wordlists, the reference's
        ``ORDER BY wcount``); leftover dictcount slots carry mask
        shards from matching ks rows — up to a pure-mask unit with
        ``dicts: []`` when every dictionary is already covered.
        """
        dicts = self.db.q(
            """SELECT * FROM dicts WHERE d_id NOT IN
                 (SELECT d_id FROM n2d WHERE net_id = ?)
               ORDER BY wcount, dname LIMIT ?""",
            (target["net_id"], dictcount),
        )
        mask_entries, mask_rows = self._plan_mask_shards(
            target["net_id"], target["ssid"], dictcount - len(dicts))
        if not dicts and not mask_entries:
            return None
        d_ids = [d["d_id"] for d in dicts]
        if d_ids:
            ph = ",".join("?" * len(d_ids))
            # every uncracked net sharing the SSID, not yet covered by
            # these dicts
            nets = self.db.q(
                f"""SELECT net_id, struct FROM nets
                    WHERE ssid = ? AND n_state = 0 AND algo = ''
                      AND net_id NOT IN
                        (SELECT net_id FROM n2d WHERE d_id IN ({ph}))""",
                (target["ssid"], *d_ids),
            )
        else:
            # pure-mask unit: the whole uncracked SSID group rides along
            # (INSERT OR IGNORE leaves already-covered shards untouched)
            nets = self.db.q(
                """SELECT net_id, struct FROM nets
                   WHERE ssid = ? AND n_state = 0 AND algo = ''""",
                (target["ssid"],),
            )
        if not nets:
            return None
        hkey = gen_key()
        with self.db.tx():
            epoch = self.db.q1(
                "SELECT COALESCE(MAX(epoch), 0) + 1 e FROM leases")["e"]
            self.db.x(
                "INSERT INTO leases(hkey, epoch, issued) VALUES (?, ?, ?)",
                (hkey, epoch, now()),
            )
            for n in nets:
                for d in d_ids:
                    self.db.x(
                        "INSERT OR IGNORE INTO n2d(net_id, d_id, hkey, epoch) "
                        "VALUES (?,?,?,?)",
                        (n["net_id"], d, hkey, epoch),
                    )
                for ks_id, mask_i, skip, span in mask_rows:
                    self.db.x(
                        "INSERT OR IGNORE INTO "
                        "n2m(net_id, ks_id, mask_i, skip, span, hkey, epoch) "
                        "VALUES (?,?,?,?,?,?,?)",
                        (n["net_id"], ks_id, mask_i, skip, span, hkey, epoch),
                    )
        if self.queue is not None:
            self.queue.discard(n["net_id"] for n in nets)
        # merged, deduped per-dict rules (get_work.php:84-92)
        seen, merged = set(), []
        for d in dicts:
            for ln in (d["rules"] or "").splitlines():
                if ln and ln not in seen:
                    seen.add(ln)
                    merged.append(ln)
        work = {
            "hkey": hkey,
            "epoch": epoch,
            "dicts": [{"dhash": d["dhash"], "dpath": d["dpath"]} for d in dicts],
            "hashes": [n["struct"] for n in nets],
        }
        if merged:
            work["rules"] = base64.b64encode("\n".join(merged).encode()).decode()
        if mask_entries:
            work["masks"] = mask_entries
        if self._prdict_available(hkey):
            work["prdict"] = True
        return work

    def _plan_mask_shards(self, net_id: int, ssid: bytes, budget: int):
        """Pick up to ``budget`` uncovered mask shards for ``net_id``.

        Returns ``(entries, rows)``: wire entries
        ``{mask, custom, skip, limit}`` for the work unit, and matching
        ``(ks_id, mask_i, skip, span)`` tuples for the n2m lease
        inserts.  ks rows are tried best-priority first; within a row,
        masks smallest-keyspace first (the compiler pre-sorts — the
        mask analog of ``ORDER BY wcount``).  Every skip/limit comes
        from first-gap coverage walks bounded by the compiled
        ``mask_keyspace`` (reaped ranges reappear as gaps and are
        re-issued); runs inside the caller's scheduler lock.
        """
        entries, rows = [], []
        if budget <= 0:
            return entries, rows
        ks = self.db.q("SELECT * FROM ks WHERE enabled = 1 "
                       "ORDER BY priority DESC, ks_id")
        for k in ks_matches(ks, ssid):
            ck = self._ks_cache.get(k["pass_regex"])
            if ck is None:
                continue
            for mask_i, m in enumerate(ck.masks):
                cov = self.db.q(
                    "SELECT skip, span FROM n2m "
                    "WHERE net_id = ? AND ks_id = ? AND mask_i = ?",
                    (net_id, k["ks_id"], mask_i),
                )
                taken = []
                while len(entries) < budget:
                    shard = next_uncovered(cov, m.keyspace,
                                           self.mask_shard_span, taken)
                    if shard is None:
                        break
                    skip, span = shard
                    taken.append((skip, span))
                    entries.append({"mask": m.mask, "custom": dict(m.custom),
                                    "skip": skip, "limit": span})
                    rows.append((k["ks_id"], mask_i, skip, span))
                if len(entries) >= budget:
                    return entries, rows
        return entries, rows

    def _prdict_available(self, hkey: str) -> bool:
        """PROBEREQUEST dict availability for a work unit: prs rows joined
        through p2s -> submissions -> nets -> n2d.hkey (prdict.php:17-29)."""
        row = self.db.q1(
            """SELECT 1 FROM prs p
               JOIN p2s ON p.p_id = p2s.p_id
               JOIN nets n ON n.s_id = p2s.s_id
               JOIN n2d ON n2d.net_id = n.net_id
               WHERE n2d.hkey = ? LIMIT 1""",
            (hkey,),
        )
        return row is not None

    def prdict_words(self, hkey: str) -> list:
        rows = self.db.q(
            """SELECT DISTINCT p.ssid FROM prs p
               JOIN p2s ON p.p_id = p2s.p_id
               JOIN nets n ON n.s_id = p2s.s_id
               JOIN n2d ON n2d.net_id = n.net_id
               WHERE n2d.hkey = ?""",
            (hkey,),
        )
        out = []
        for r in rows:
            ssid = r["ssid"]
            try:
                printable = ssid.decode("ascii").isprintable()
            except UnicodeDecodeError:
                printable = False
            out.append(ssid if printable else b"$HEX[%s]" % ssid.hex().encode())
        return out

    # ------------------------------------------------------------------
    # Result acceptance: put_work
    # ------------------------------------------------------------------

    def put_work(self, data: dict) -> bool:
        """Accept one submission: verify claims, then release the lease.

        The whole call — every accept cascade plus the lease release —
        runs under the scheduler mutex and ONE transaction, so a kill at
        any statement boundary leaves no half-accepted net.  The release
        is keyed by ``(hkey, epoch, state=live)``: a stale holder whose
        unit was reaped and re-issued matches nothing, and a duplicate
        submit is an idempotent no-op (the lease state only leaves
        "live" once).
        """
        cands = data.get("cand") or []
        ctype = data.get("type", "bssid")
        hkey = data.get("hkey")
        epoch = data.get("epoch")
        if not isinstance(epoch, int) or isinstance(epoch, bool):
            epoch = None  # absent/garbage epoch: resolve from the live lease
        if not isinstance(cands, list):
            return False
        with self._getwork_lock:
            with self.db.tx():
                claims = []
                for pair in cands[:MAX_CANDS_PER_PUT]:
                    k, v = pair.get("k"), pair.get("v")
                    if not isinstance(k, str) or not isinstance(v, str) or v == "":
                        continue
                    # Candidate encoding depends on the claim type (common.php:
                    # 874-898): bssid/ssid claims carry hex2bin'd PSKs, while
                    # 'hash' claims carry raw text (hc_unhex'd by the verifier) —
                    # a raw all-digit PSK must NOT be hex-decoded here.
                    if ctype in ("bssid", "ssid"):
                        try:
                            psk = bytes.fromhex(v)
                        except ValueError:
                            continue
                    else:
                        psk = oracle.hc_unhex(v)
                    claims.append((k, psk))
                # Pre-derive the claim x net PBKDF2 superset in ONE
                # batched dispatch.  The accept cascade below re-queries
                # per claim, and accepts only REMOVE nets from n_state=0,
                # so its queries return subsets of this snapshot — a
                # superset pair costs one spare derivation, never a
                # verdict change (verify_batch single-derives any gap).
                self.verifier.prewarm(
                    [(net["ssid"], oracle.hc_unhex(psk))
                     for k, psk in claims
                     for net in self._nets_for_claim(ctype, k)])
                for k, psk in claims:
                    for net in self._nets_for_claim(ctype, k):
                        self._try_accept(net, psk, submitter=data.get("ip", ""))
                if hkey:
                    self._release_lease(hkey, epoch)
        return True

    def _release_lease(self, hkey: str, epoch: int = None) -> int:
        """Release a live lease keyed by (hkey, epoch); returns released
        row count (0 = stale holder / already released / reaped).  Legacy
        clients send no epoch — it resolves from the live lease record,
        which preserves the stale-holder guard (a reaped lease has no
        live record to resolve)."""
        with self.db.tx():
            if epoch is None:
                row = self.db.q1(
                    "SELECT epoch FROM leases WHERE hkey = ? AND state = 0",
                    (hkey,),
                )
                if row is None:
                    return 0
                epoch = row["epoch"]
            cur = self.db.x(
                """UPDATE leases SET state = 1, released = ?
                   WHERE hkey = ? AND epoch = ? AND state = 0""",
                (now(), hkey, epoch),
            )
            if cur.rowcount:
                self.db.x(
                    "UPDATE n2d SET hkey = NULL WHERE hkey = ? AND epoch = ?",
                    (hkey, epoch),
                )
                # mask shards release identically: hkey NULL = range done.
                # A reaped unit's n2m rows were DELETEd, so the stale
                # holder's keyed release above matched no lease and never
                # reaches here — a re-issued range cannot double-credit.
                self.db.x(
                    "UPDATE n2m SET hkey = NULL WHERE hkey = ? AND epoch = ?",
                    (hkey, epoch),
                )
            return cur.rowcount

    def _nets_for_claim(self, ctype: str, key: str):
        if ctype == "bssid":
            try:
                b = int(key, 16)
            except ValueError:
                return []
            return self.db.q(
                "SELECT * FROM nets WHERE bssid = ? AND n_state = 0", (b,)
            )
        if ctype == "ssid":
            # The ssid claim key arrives hex-encoded (common.php:886-887).
            try:
                essid = bytes.fromhex(key)
            except ValueError:
                return []
            return self.db.q(
                "SELECT * FROM nets WHERE ssid = ? AND n_state = 0", (essid,)
            )
        if ctype == "hash":
            try:
                hh = bytes.fromhex(key)
            except ValueError:
                return []
            return self.db.q(
                "SELECT * FROM nets WHERE hash = ? AND n_state = 0", (hh,)
            )
        return []

    def _try_accept(self, net, psk: bytes, submitter: str = ""):
        """Independent re-verification + PMK-reuse sweep, both through
        the batched verify seam (verdicts bit-identical to the scalar
        oracle: verify_batch finishes every verdict with the oracle
        itself, PMK injected)."""
        h = hl.parse(net["struct"])
        r = verify_batch([(h, [psk], None)], nc=SERVER_NC,
                         batcher=self.verifier)[0]
        if not r:
            self._m_claims.labels(verdict="rejected").inc()
            return False
        self._m_claims.labels(verdict="accepted").inc()
        psk_b, nc, endian, pmk = r
        self._mark_cracked(net["net_id"], psk_b, pmk, nc or 0, endian or "")
        # replay this PMK against uncracked siblings (common.php:916-932)
        # — every sibling hash checked in ONE verify dispatch
        sibs = self._handshakes_like(h, n_state=0)
        parsed = [hl.parse(s["struct"]) for s in sibs]
        replays = verify_batch([(sh, [psk_b], pmk) for sh in parsed],
                               nc=SERVER_NC, batcher=self.verifier)
        for sib, sh, rr in zip(sibs, parsed, replays):
            if not rr:
                continue
            if sh.essid == h.essid:
                self._mark_cracked(sib["net_id"], psk_b, pmk, rr[1] or 0, rr[2] or "")
            else:
                # MIC verifies with a PMK derived from a different ESSID:
                # the stored ESSID is broken -> cascade delete
                self._delete_net(sib["net_id"])
        return True

    def _mark_cracked(self, net_id: int, psk: bytes, pmk: bytes, nc: int, endian: str):
        # under the scheduler mutex: the n2d delete must not interleave
        # with a get_work lease loop for the same net (see __init__).
        # Lock-ordering discipline everywhere: _getwork_lock FIRST, then
        # tx() — never open a transaction and then take the scheduler
        # mutex, or a concurrent get_work (lock held, waiting on the db
        # lock) deadlocks against us.
        with self._getwork_lock:
            with self.db.tx():
                self.db.x(
                    """UPDATE nets SET pass = ?, pmk = ?, nc = ?, endian = ?,
                                      n_state = 1, ts = ? WHERE net_id = ?""",
                    (psk, pmk, nc, endian, now(), net_id),
                )
                self.db.x("DELETE FROM n2d WHERE net_id = ?", (net_id,))
                self.db.x("DELETE FROM n2m WHERE net_id = ?", (net_id,))

    def _delete_net(self, net_id: int):
        with self._getwork_lock:
            with self.db.tx():
                row = self.db.q1("SELECT bssid FROM nets WHERE net_id = ?", (net_id,))
                self.db.x("DELETE FROM nets WHERE net_id = ?", (net_id,))
                if row and not self.db.q1(
                    "SELECT 1 FROM nets WHERE bssid = ? LIMIT 1", (row["bssid"],)
                ):
                    self.db.x("DELETE FROM bssids WHERE bssid = ?", (row["bssid"],))

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------

    def observe_metrics(self):
        """Refresh the scrape-time gauges (work-unit lease + net-state
        stats) in ``self.registry``; called by the ``?metrics`` handler
        so every scrape reads the live database, not the hourly cron
        snapshot in the stats table."""
        reg = self.registry
        leases = self.db.q1(
            "SELECT COUNT(*) c, COUNT(DISTINCT hkey) u FROM n2d "
            "WHERE hkey IS NOT NULL")
        reg.gauge("dwpa_server_leases_active",
                  "net x dict coverage rows currently leased"
                  ).set(leases["c"])
        reg.gauge("dwpa_server_work_units_in_flight",
                  "distinct work-unit keys currently leased"
                  ).set(leases["u"] or 0)
        oldest = self.db.q1(
            "SELECT MIN(ts) t FROM n2d WHERE hkey IS NOT NULL")["t"]
        reg.gauge("dwpa_server_oldest_lease_age_seconds",
                  "age of the oldest outstanding lease (reaped at "
                  "dwpa_server_lease_reap_seconds)"
                  ).set(max(0.0, now() - oldest) if oldest else 0.0)
        reg.gauge("dwpa_server_lease_reap_seconds",
                  "stale-lease reap threshold").set(LEASE_REAP_S)
        reg.gauge("dwpa_server_leases_live",
                  "live lease records (admission-control population)"
                  ).set(self.db.q1(
                      "SELECT COUNT(*) c FROM leases WHERE state = 0")["c"])
        reg.gauge("dwpa_server_inflight_limit",
                  "max live work-unit leases before get_work sheds (0 = "
                  "uncapped)").set(self.max_inflight or 0)
        reg.gauge("dwpa_server_work_queue_depth",
                  "precomputed issuable targets awaiting pop (-1 = scan "
                  "path, queue disabled)"
                  ).set(len(self.queue) if self.queue is not None else -1)
        for state, label in ((0, "uncracked"), (1, "cracked")):
            reg.gauge("dwpa_server_nets",
                      "nets by crack state").labels(state=label).set(
                self.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = ?",
                           (state,))["c"])
        mask_total, mask_done = mask_keyspace_totals(self.db, self._ks_cache)
        reg.gauge("dwpa_keyspace_mask_total",
                  "scheduled mask keyspace over uncracked nets "
                  "(candidates, summed per matching ks row)"
                  ).set(mask_total)
        reg.gauge("dwpa_keyspace_mask_done",
                  "completed mask-shard coverage (released n2m spans, "
                  "candidates)").set(mask_done)

    # ------------------------------------------------------------------
    # Users & potfile export
    # ------------------------------------------------------------------

    def create_user(self, mail: str) -> str:
        key = gen_key()
        self.db.x(
            "INSERT INTO users(userkey, mail) VALUES (?, ?) "
            "ON CONFLICT(mail) DO UPDATE SET userkey = excluded.userkey",
            (key, mail),
        )
        return key

    def issue_user_key(self, mail: str, ip: str = "") -> tuple:
        """The key-issue flow (web/index.php:48-102).

        New mail: insert user (userkey = linkkey = fresh key), send the key
        by mail, return ("issued", key) — the caller sets the cookie.
        Known mail: rotate the linkkey at most once per 24h (users.linkkeyts
        throttle, db/wpa.sql:308-320) and mail a ``?get_key=<linkkey>``
        confirmation link; return ("reset", key) or ("throttled", None).
        Mail delivery failures are swallowed like the reference's.
        """
        key = gen_key()
        inserted, updated = True, 0
        with self.db.tx():
            # Both arms inside one tx (mail delivery stays outside it):
            # the insert-or-rotate decision and the rotate itself commit
            # together, never a rotated linkkey without its timestamp.
            try:
                self.db.x(
                    "INSERT INTO users(userkey, linkkey, linkkeyts, mail, ip) "
                    "VALUES (?, ?, ?, ?, ?)",
                    (key, key, now(), mail, ip),
                )
            except sqlite3.IntegrityError:
                inserted = False
                updated = self.db.x(
                    "UPDATE users SET linkkey = ?, linkkeyts = ? "
                    "WHERE mail = ? AND (linkkeyts IS NULL OR linkkeyts < ?)",
                    (key, now(), mail, now() - 24 * 3600),
                ).rowcount
        if not inserted:
            if updated != 1:
                return ("throttled", None)
            if self.mailer:
                self.mailer.send(
                    mail, "dwpa_tpu key change",
                    "A request for a new user key was submitted. "
                    "Please follow this link to confirm: "
                    f"{self.base_url}?get_key={key}",
                )
            return ("reset", key)
        if self.mailer:
            self.mailer.send(
                mail, "dwpa_tpu key", f"Key to access results is: {key}"
            )
        return ("issued", key)

    def confirm_linkkey(self, linkkey: str) -> bool:
        """?get_key=<linkkey>: promote linkkey -> userkey
        (web/content/get_key.php:11-31)."""
        cur = self.db.x(
            "UPDATE users SET userkey = linkkey WHERE linkkey = ?", (linkkey,)
        )
        return cur.rowcount == 1

    def user_key_exists(self, key: str) -> bool:
        return (
            self.db.q1("SELECT 1 FROM users WHERE userkey = ?", (key,)) is not None
        )

    def user_potfile(self, userkey: str) -> list:
        """All of a user's cracked nets as bssid:mac_sta:ssid:pass lines
        (api.php:9-28)."""
        rows = self.db.q(
            """SELECT n.* FROM nets n JOIN n2u ON n.net_id = n2u.net_id
               JOIN users u ON u.u_id = n2u.u_id
               WHERE u.userkey = ? AND n.n_state = 1""",
            (userkey,),
        )
        out = []
        for r in rows:
            mac_ap = f"{r['bssid']:012x}"
            mac_sta = f"{r['mac_sta']:012x}"
            ssid = r["ssid"].decode("latin1")
            out.append(f"{mac_ap}:{mac_sta}:{ssid}:{(r['pass'] or b'').decode('latin1')}")
        return out
