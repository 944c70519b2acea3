"""Async maintenance jobs (the reference's cron layer, SURVEY.md §2.7).

- ``maintenance``: hourly stats recompute, stale work-unit lease reaping
  (3 h, the elastic-recovery mechanism — maint.php:36), cracked-dictionary
  regeneration ordered by password frequency (maint.php:41-77);
- ``keygen_precompute``: the rkg.php equivalent — per unprocessed net, run
  default-key generators + the "Single" bssid/ssid mutation generator,
  verify each candidate with the oracle, and finally set ``algo`` (''
  when nothing matched), which *releases* the net to the get_work
  scheduler (get_work only serves algo='' nets, get_work.php:65,101);
- ``precrack``: the batched superset of ``keygen_precompute``
  (server/precrack.py): vendor packs + IMEI sweeps + Single/Pattern +
  cracked-corpus dictionary + cross-net replay, derived as one fused
  mixed-ESSID device batch and demuxed per net;
- ``geolocate``: wigle.php/3wifi.php equivalent, behind a pluggable
  lookup function (this environment has zero egress; the reference calls
  external HTTP APIs with throttles).

Run them from a scheduler loop or one-shot (``python -m dwpa_tpu_torch.server
jobs``); they are plain functions over the Database.
"""

import gzip
import hashlib
import os
import time

from ..gen.dicts import md5_file
from ..gen.psktool import psk_candidates
from ..gen.vendors import vendor_candidates
from ..keyspace.schedule import mask_keyspace_totals
from ..models import hashline as hl
from ..obs import get_logger
from ..oracle import m22000 as oracle
from .core import LEASE_REAP_S, LEASE_RETENTION_S, SERVER_NC, ServerCore
from .db import long2mac
from .precrack import PrecrackEngine

_log = get_logger(__name__)


def _job_timer(core: ServerCore, job: str):
    """Span for one cron job, recorded into the core's registry as
    ``dwpa_span_seconds{span="job:..."}`` — the jobs are pure
    host/sqlite work (plus oracle verify), so the span needs no device
    sync."""
    from ..obs import SpanTracer

    tracer = getattr(core, "_job_tracer", None)
    if tracer is None:
        tracer = core._job_tracer = SpanTracer(core.registry)
    return tracer.span(job)


def maintenance(core: ServerCore, cracked_dict_path: str = None) -> dict:
    """Stats + lease reaping + cracked-dict regen; returns the stats."""
    with _job_timer(core, "job:maintenance"):
        return _maintenance(core, cracked_dict_path)


def _maintenance(core: ServerCore, cracked_dict_path: str = None) -> dict:
    db = core.db
    day_ago = time.time() - 86400
    if cracked_dict_path is None and core.dictdir:
        cracked_dict_path = os.path.join(core.dictdir, "cracked.txt.gz")

    s = {}
    s["nets"] = db.q1("SELECT COUNT(*) c FROM nets")["c"]
    s["cracked"] = db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1")["c"]
    s["uncracked"] = db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 0")["c"]
    s["pmkid"] = db.q1("SELECT COUNT(*) c FROM nets WHERE keyver = 100")["c"]
    s["pmkid_cracked"] = db.q1(
        "SELECT COUNT(*) c FROM nets WHERE keyver = 100 AND n_state = 1"
    )["c"]
    s["rkg"] = db.q1("SELECT COUNT(DISTINCT net_id) c FROM rkg")["c"]
    s["rkg_cracked"] = db.q1(
        "SELECT COUNT(*) c FROM nets WHERE n_state = 1 AND algo != '' AND algo IS NOT NULL"
    )["c"]
    s["geo"] = db.q1("SELECT COUNT(*) c FROM bssids WHERE lat IS NOT NULL")["c"]
    s["submissions"] = db.q1("SELECT COUNT(*) c FROM submissions")["c"]
    s["users"] = db.q1("SELECT COUNT(*) c FROM users")["c"]
    s["24sub"] = db.q1(
        "SELECT COUNT(*) c FROM submissions WHERE ts > ?", (day_ago,)
    )["c"]
    s["24founds"] = db.q1(
        "SELECT COUNT(*) c FROM nets WHERE n_state = 1 AND ts > ?", (day_ago,)
    )["c"]
    s["24getwork"] = db.q1(
        "SELECT COUNT(DISTINCT hkey) c FROM n2d WHERE ts > ?", (day_ago,)
    )["c"]
    # 24 h keyspace throughput: sum of dict wordcounts over last-day
    # leases, plus last-day mask-shard spans (the shard IS its count)
    s["24psk"] = db.q1(
        """SELECT COALESCE(SUM(d.wcount), 0) c FROM n2d
           JOIN dicts d ON d.d_id = n2d.d_id WHERE n2d.ts > ?""",
        (day_ago,),
    )["c"] + db.q1(
        "SELECT COALESCE(SUM(span), 0) c FROM n2m WHERE ts > ?", (day_ago,)
    )["c"]
    # round totals: dict words × uncracked nets plus the scheduled mask
    # keyspace of every matching enabled ks row (smart keyspace — the
    # dicts-only total undercounted the round once mask shards existed)
    total_words = db.q1("SELECT COALESCE(SUM(wcount), 0) c FROM dicts")["c"]
    mask_total, _ = mask_keyspace_totals(db, core._ks_cache)
    s["words"] = s["uncracked"] * total_words + mask_total
    s["triedwords"] = db.q1(
        """SELECT COALESCE(SUM(d.wcount), 0) c FROM n2d
           JOIN dicts d ON d.d_id = n2d.d_id
           JOIN nets n ON n.net_id = n2d.net_id WHERE n.n_state = 0"""
    )["c"] + db.q1(
        """SELECT COALESCE(SUM(m.span), 0) c FROM n2m m
           JOIN nets n ON n.net_id = m.net_id WHERE n.n_state = 0"""
    )["c"]
    s["contributors"] = db.q1(
        "SELECT COUNT(DISTINCT hkey) c FROM n2d WHERE hkey IS NOT NULL"
    )["c"]
    for name, value in s.items():
        db.set_stat(name, value)

    # Reap stale in-flight leases AFTER the stats pass, matching the
    # reference's ordering (maint.php computes its counters at 16-32 and
    # reaps at 36) — reaping first would drop just-expired work units out
    # of 24getwork/contributors for the hour they should still count.
    # One transaction under the scheduler mutex: the coverage-row clear,
    # the lease-state flip (live -> reaped, which is what blocks the
    # stale holder's later release) and the retention prune land
    # together — a kill mid-reap never leaves a reaped lease whose n2d
    # rows still look in-flight, or vice versa.
    cutoff = time.time() - LEASE_REAP_S
    with core._getwork_lock:
        with db.tx():
            reaped = db.x(
                """UPDATE n2d SET hkey = NULL
                   WHERE hkey IS NOT NULL
                     AND (ts < ? OR hkey IN (SELECT hkey FROM leases
                                             WHERE state = 0 AND issued < ?))""",
                (cutoff, cutoff),
            ).rowcount
            # Mask shards are DELETEd, not NULLed: a NULLed n2m row would
            # count as completed coverage, but an abandoned range was
            # never searched — dropping the row reopens the gap so
            # _plan_mask_shards re-issues it under a fresh epoch, while
            # the lease flip below still blocks the stale holder's
            # release (no double-credit).
            reaped += db.x(
                """DELETE FROM n2m
                   WHERE hkey IS NOT NULL
                     AND (ts < ? OR hkey IN (SELECT hkey FROM leases
                                             WHERE state = 0 AND issued < ?))""",
                (cutoff, cutoff),
            ).rowcount
            db.x(
                """UPDATE leases SET state = 2, released = ?
                   WHERE state = 0 AND issued < ?""",
                (time.time(), cutoff),
            )
            # bound the lease ledger: released/reaped records older than
            # the retention window carry no audit value
            db.x(
                """DELETE FROM leases WHERE state != 0
                   AND COALESCE(released, issued) < ?""",
                (time.time() - LEASE_RETENTION_S,),
            )
    if reaped > 0:
        core.registry.counter(
            "dwpa_server_leases_reaped_total",
            "stale work-unit leases reclaimed by maintenance").inc(reaped)

    if cracked_dict_path:
        regen_cracked_dict(core, cracked_dict_path)
    return s


def regen_cracked_dict(core: ServerCore, path: str) -> int:
    """cracked.txt.gz: distinct non-keygen passwords by frequency
    (maint.php:41-64); non-printables emitted as $HEX[...]."""
    rows = core.db.q(
        """SELECT pass, COUNT(*) c FROM nets
           WHERE n_state = 1 AND pass IS NOT NULL AND LENGTH(pass) >= 8
             AND (algo = '' OR algo IS NULL)
           GROUP BY pass ORDER BY c DESC"""
    )
    words = []
    for r in rows:
        p = r["pass"]
        try:
            printable = p.decode("ascii").isprintable()
        except UnicodeDecodeError:
            printable = False
        words.append(p if printable else b"$HEX[%s]" % p.hex().encode())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = b"\n".join(words) + (b"\n" if words else b"")
    with open(path, "wb") as f:
        # mtime=0 -> deterministic bytes, so dhash (and every client's
        # cached copy) only changes when the word list itself changes.
        with gzip.GzipFile(fileobj=f, mode="wb", compresslevel=9, mtime=0) as gz:
            gz.write(data)
    # update/insert the dict row so the scheduler hands it out
    dhash = md5_file(path)
    dname = os.path.basename(path)
    row = core.db.q1("SELECT d_id FROM dicts WHERE dname = ?", (dname,))
    if row:
        core.db.x(
            "UPDATE dicts SET dhash = ?, wcount = ? WHERE d_id = ?",
            (dhash, len(words), row["d_id"]),
        )
    else:
        core.add_dict("dict/" + dname, dname, dhash, len(words))
    return len(words)


def regen_rkg_dict(core: ServerCore, path: str) -> int:
    """rkg.txt.gz: distinct passwords of keygen-cracked nets (algo set
    and non-empty — rkg.php:178-197 regenerates this dict on any keygen
    hit so volunteers try known vendor-default keys everywhere).

    Served as a plain ``/dict/`` artifact, NOT registered in the dicts
    table — exactly the reference's arrangement: clients fetch it in
    their cracked/rkg pass 1, and registering it would double-issue the
    same words through the scheduler.  ORDER BY keeps the bytes (and so
    any cached copy) stable when the word set hasn't changed.

    Skips the gzip -9 rewrite when the word set is unchanged since the
    last regeneration: the content signature (63-bit blake2b of the
    uncompressed blob) is kept in the stats table, so every keygen hit
    on an already-known vendor key stops costing a full recompression.
    """
    rows = core.db.q(
        """SELECT DISTINCT pass FROM nets
           WHERE algo IS NOT NULL AND algo != '' AND pass IS NOT NULL
           ORDER BY pass"""
    )
    words = [r["pass"] for r in rows]
    data = b"\n".join(words) + (b"\n" if words else b"")
    # 63-bit signature: the stats table stores sqlite INTEGERs (signed
    # 64-bit); 0 is reserved for "never generated"
    sig = (int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big") >> 1) or 1
    if core.db.get_stat("rkg_dict_sig") == sig and os.path.exists(path):
        _log.info("rkg dict unchanged (%d words, sig %x) — skipping "
                  "gzip rewrite of %s", len(words), sig, path)
        return len(words)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        with gzip.GzipFile(fileobj=f, mode="wb", compresslevel=9, mtime=0) as gz:
            gz.write(data)
    core.db.set_stat("rkg_dict_sig", sig)
    return len(words)


def single_mode_candidates(bssid: bytes, ssid: bytes):
    """The "Single" generator: bssid +/-1 in 12/10/8-hex widths and ssid
    case/suffix mutations (rkg.php single_mode_generator, :48-77)."""
    b = int.from_bytes(bssid, "big")
    for delta in (0, 1, -1):
        h = f"{(b + delta) & 0xFFFFFFFFFFFF:012x}"
        for width in (12, 10, 8):
            tail = h[12 - width:]
            yield tail.encode()
            yield tail.upper().encode()
    text = ssid.decode("latin1")
    for base in (text, text.lower(), text.upper()):
        for suffix in ("", "1", "123", "!"):
            cand = (base + suffix).encode("latin1")
            if len(cand) >= 8:
                yield cand


def keygen_precompute(core: ServerCore, limit: int = 100,
                      extra_generators=None) -> dict:
    """Process up to ``limit`` nets with algo IS NULL; returns counts.

    ``extra_generators``: iterable of callables ``(bssid: bytes,
    ssid: bytes) -> iterable[tuple[str, bytes]]`` yielding (algo_name,
    candidate) pairs.  Default (None): the built-in vendor keygen
    families (gen/vendors.py — Thomson, Belkin, EasyBox, MacTail, IMEI),
    the routerkeygen-cli dispatch equivalent; pass ``[]`` to disable.
    """
    if extra_generators is None:
        extra_generators = [vendor_candidates]
    with _job_timer(core, "job:keygen_precompute"):
        return _keygen_precompute(core, limit, extra_generators)


def _keygen_precompute(core: ServerCore, limit, extra_generators) -> dict:
    db = core.db
    nets = db.q(
        "SELECT * FROM nets WHERE algo IS NULL AND n_state = 0 "
        "ORDER BY net_id LIMIT ?", (limit,)
    )
    found = 0
    for net in nets:
        h = hl.parse(net["struct"])
        bssid = long2mac(net["bssid"])
        cands = [("Single", c) for c in single_mode_candidates(bssid, h.essid)]
        cands += [("Pattern", c) for c in psk_candidates(h.essid, bssid)]
        for gen in extra_generators or []:
            cands += list(gen(bssid, h.essid))
        # Oracle verification first (pure compute, no locks held), then
        # ONE transaction per net: the rkg attempt rows, the crack mark
        # and the algo release commit together — a kill mid-net leaves
        # it fully unprocessed (algo still NULL), never half-recorded.
        # ONE oracle call per net: the oracle walks the key list with
        # identical first-match-wins semantics to the old per-candidate
        # loop, and the hit index recovers the tried prefix (the rkg
        # attempt rows the scalar loop would have recorded).
        tried, hit = list(cands), None
        keys = [c for _, c in cands]
        r = oracle.check_key_m22000(h, keys, nc=SERVER_NC) if keys else None
        if r:
            i = next(i for i, k in enumerate(keys)
                     if oracle.hc_unhex(k) == r[0])
            tried = cands[:i + 1]
            hit = (cands[i][0], cands[i][1], r)
        hit_algo = hit[0] if hit else ""
        with core._getwork_lock:
            with db.tx():
                for algo, cand in tried:
                    db.x(
                        "INSERT INTO rkg(net_id, algo, pass) VALUES (?, ?, ?)",
                        (net["net_id"], algo, cand),
                    )
                if hit:
                    _, cand, r = hit
                    core._mark_cracked(
                        net["net_id"], r[0], r[3], r[1] or 0, r[2] or ""
                    )
                    db.x(
                        "UPDATE rkg SET n_state = 1 WHERE net_id = ? AND pass = ?",
                        (net["net_id"], cand),
                    )
                    found += 1
                # setting algo (even '') releases the net to the volunteers
                db.x(
                    "UPDATE nets SET algo = ? WHERE net_id = ?",
                    (hit_algo, net["net_id"]),
                )
    if found and core.dictdir:
        # any keygen hit regenerates the vendor-key dictionary so every
        # volunteer tries known default keys everywhere (rkg.php:178-197)
        regen_rkg_dict(core, os.path.join(core.dictdir, "rkg.txt.gz"))
    return {"processed": len(nets), "cracked": found}


def precrack(core: ServerCore, limit: int = 100, batch: int = 2048,
             device: str = "auto", store=None, dict_limit: int = 64,
             imei_limit: int = None) -> dict:
    """The batched pre-crack sweep (server/precrack.py) as a cron job.

    A superset of ``keygen_precompute``: the same candidate families plus
    the cracked-corpus dictionary and cross-net replay, derived as ONE
    fused mixed-ESSID batch (on the card by default; host PBKDF2 only
    with ``device="off"``).  The engine is cached on the core (``core.precrack``) so
    the recurring job and the ingestion hook share one PMK memo/store,
    and records its own ``job:precrack`` span.
    """
    eng = core.precrack
    if eng is None:
        eng = core.precrack = PrecrackEngine(
            core, batch=batch, device=device, store=store,
            dict_limit=dict_limit, imei_limit=imei_limit)
    return eng.run(limit=limit)


class LookupUnavailable(Exception):
    """Raised by an enrichment ``lookup`` to signal a *transient* failure
    (network error, service refusal) as opposed to "queried fine, not
    found".  The batch is abandoned and no row is marked as attempted, so
    the same BSSIDs are retried next tick — matching the reference's
    wigle.php, which only stamps ``wiglets`` after a parsed, successful
    response (wigle.php:33-49)."""


def psk_lookup(core: ServerCore, lookup, batch: int = 100) -> dict:
    """External PSK-database sweep (3wifi.php equivalent).

    Batches up to ``batch`` uncracked, not-yet-queried BSSIDs through
    ``lookup(macs: list[bytes]) -> dict[mac_bytes, psk_bytes]`` and
    submits every hit through the normal put_work verification path —
    the external database is never trusted, exactly as the reference
    routes 3wifi answers through full re-verification (3wifi.php:66).
    flags bit 1 marks queried bssids (wpa.sql:16) so each is asked once.
    """
    rows = core.db.q(
        """SELECT DISTINCT n.bssid FROM nets n
           JOIN bssids b ON b.bssid = n.bssid
           WHERE n.n_state = 0 AND b.flags & 1 = 0 LIMIT ?""", (batch,)
    )
    macs = [long2mac(r["bssid"]) for r in rows]
    if not macs:
        return {"queried": 0, "submitted": 0}
    try:
        found = lookup(macs) or {}
    except LookupUnavailable:
        return {"queried": 0, "submitted": 0, "unavailable": True}
    cand = [{"k": mac.hex(), "v": psk.hex()} for mac, psk in found.items()]
    # put_work caps candidates per call (MAX_CANDS_PER_PUT, matching the
    # reference's 200-pair limit) — chunk so no hit is silently dropped.
    from .core import MAX_CANDS_PER_PUT

    for i in range(0, len(cand), MAX_CANDS_PER_PUT):
        core.put_work({"type": "bssid",
                       "cand": cand[i:i + MAX_CANDS_PER_PUT],
                       "ip": "psk_lookup"})
    with core.db.tx():
        for r in rows:
            core.db.x(
                "UPDATE bssids SET flags = flags | 1 WHERE bssid = ?",
                (r["bssid"],),
            )
    return {"queried": len(macs), "submitted": len(cand)}


def geolocate(core: ServerCore, lookup, batch: int = 5) -> int:
    """Enrich bssids rows via ``lookup(mac: bytes) -> dict|None`` with keys
    lat/lon/country/region/city (wigle.php equivalent; the reference
    throttles to 5 BSSIDs per run at 1 rps, wigle.php:37-53)."""
    rows = core.db.q(
        "SELECT bssid FROM bssids WHERE flags & 2 = 0 LIMIT ?", (batch,)
    )
    done = 0
    for r in rows:
        try:
            info = lookup(long2mac(r["bssid"]))
        except LookupUnavailable:
            break  # transient outage: leave the rest unmarked for retry
        info = info or {}
        # One statement covers both the hit and the not-found mark
        # (COALESCE keeps existing values on a miss): each row's update
        # is atomic on its own, and the lookup between rows means a
        # wider transaction would just hold the write lock across
        # network calls.
        core.db.x(
            """UPDATE bssids SET lat = COALESCE(?, lat),
                    lon = COALESCE(?, lon), country = COALESCE(?, country),
                    region = COALESCE(?, region), city = COALESCE(?, city),
                    flags = flags | 2
               WHERE bssid = ?""",
            (info.get("lat"), info.get("lon"), info.get("country"),
             info.get("region"), info.get("city"), r["bssid"]),
        )
        done += 1
    return done
