"""Data model on sqlite3.

Mirrors the reference schema's entities and invariants (db/wpa.sql: nets,
submissions, bssids, dicts, n2d, n2u, users, rkg, prs, p2s, ks, stats —
see SURVEY.md §2.6) with idiomatic-sqlite choices instead of a literal DDL
translation:

- MACs stored as INTEGER (the reference packs them into BIGINT too);
- counter maintenance (nets.hits / dicts.hits) done by triggers exactly as
  the reference pushes it into the DB (wpa.sql:107-121), so concurrent
  writers stay consistent;
- the nets.hash / submissions.hash uniqueness + INSERT OR IGNORE give the
  same idempotent-ingestion semantics;
- two tables have no reference twin: ``leases`` (epoch-numbered work-unit
  leases, the crash-safety spine) and ``n2m`` (net x compiled-mask
  shard-range coverage for the smart-keyspace vertical — ``n2d``'s analog
  for the ks table, same hkey/epoch lease discipline; a reaped range is
  DELETEd, never NULLed, because a NULL hkey row MEANS completed
  coverage);
- WAL journal + a statement-level lock on the shared connection make the
  handle thread-safe under the threaded server; the larger critical
  section the reference guards with its SHM lockfile (work-unit issue)
  is ServerCore._getwork_lock.
"""

import contextlib
import sqlite3
import threading
import time

SCHEMA = """
CREATE TABLE IF NOT EXISTS nets (
    net_id   INTEGER PRIMARY KEY,
    s_id     INTEGER REFERENCES submissions(s_id),
    u_id     INTEGER,
    bssid    INTEGER NOT NULL,
    mac_sta  INTEGER NOT NULL,
    ssid     BLOB NOT NULL,
    pass     BLOB,
    pmk      BLOB,
    algo     TEXT,              -- NULL = keygen unprocessed, '' = released
    hash     BLOB NOT NULL UNIQUE,  -- md5 net identity (hashline fields 1-7)
    struct   TEXT NOT NULL,     -- the m22000 hashline
    message_pair INTEGER,
    keyver   INTEGER NOT NULL,  -- 1|2|3|100=PMKID
    nc       INTEGER,
    endian   TEXT,
    sip      TEXT,
    sts      REAL NOT NULL DEFAULT (strftime('%s','now')),
    n_state  INTEGER NOT NULL DEFAULT 0,  -- 0 uncracked, 1 cracked, 2 uncrackable
    hits     INTEGER NOT NULL DEFAULT 0,
    ts       REAL NOT NULL DEFAULT (strftime('%s','now'))
);
CREATE INDEX IF NOT EXISTS idx_nets_sched ON nets(n_state, hits, ts, algo);
CREATE INDEX IF NOT EXISTS idx_nets_bssid ON nets(bssid);
CREATE INDEX IF NOT EXISTS idx_nets_ssid ON nets(ssid);
CREATE INDEX IF NOT EXISTS idx_nets_mac_sta ON nets(mac_sta);

CREATE TABLE IF NOT EXISTS submissions (
    s_id      INTEGER PRIMARY KEY,
    localfile TEXT,
    hash      BLOB NOT NULL UNIQUE,   -- md5 of the capture file
    ip        TEXT,
    ts        REAL NOT NULL DEFAULT (strftime('%s','now'))
);

CREATE TABLE IF NOT EXISTS bssids (
    bssid   INTEGER PRIMARY KEY,
    flags   INTEGER NOT NULL DEFAULT 0,   -- bit1 = 3wifi done, bit2 = wigle done
    lat     REAL, lon REAL,
    country TEXT, region TEXT, city TEXT,
    ts      REAL NOT NULL DEFAULT (strftime('%s','now'))
);

CREATE TABLE IF NOT EXISTS dicts (
    d_id   INTEGER PRIMARY KEY,
    dpath  TEXT NOT NULL,
    dname  TEXT NOT NULL,
    dhash  TEXT NOT NULL,
    rules  TEXT,
    wcount INTEGER NOT NULL DEFAULT 0,
    hits   INTEGER NOT NULL DEFAULT 0
);

CREATE TABLE IF NOT EXISTS n2d (
    net_id INTEGER NOT NULL REFERENCES nets(net_id) ON DELETE CASCADE,
    d_id   INTEGER NOT NULL REFERENCES dicts(d_id),
    hkey   TEXT,                -- non-NULL = in-flight work unit lease
    epoch  INTEGER NOT NULL DEFAULT 0,  -- lease generation (leases.epoch)
    ts     REAL NOT NULL DEFAULT (strftime('%s','now')),
    PRIMARY KEY (net_id, d_id)
);
CREATE INDEX IF NOT EXISTS idx_n2d_hkey ON n2d(hkey);

-- First-class work-unit leases: one row per issued hkey, carrying a
-- globally monotonic epoch (the lease generation).  Release and reap key
-- on (hkey, epoch, state), so a reaped-then-reissued unit cannot be
-- released or double-credited by the stale holder, and duplicate
-- submits are idempotent (state only moves 0 -> 1|2 once).
CREATE TABLE IF NOT EXISTS leases (
    lease_id INTEGER PRIMARY KEY,
    hkey     TEXT NOT NULL UNIQUE,
    epoch    INTEGER NOT NULL,
    issued   REAL NOT NULL DEFAULT (strftime('%s','now')),
    state    INTEGER NOT NULL DEFAULT 0,  -- 0 live, 1 released, 2 reaped
    released REAL
);
CREATE INDEX IF NOT EXISTS idx_leases_state ON leases(state, issued);

CREATE TRIGGER IF NOT EXISTS trg_n2d_ins AFTER INSERT ON n2d BEGIN
    UPDATE nets  SET hits = hits + 1 WHERE net_id = NEW.net_id;
    UPDATE dicts SET hits = hits + 1 WHERE d_id  = NEW.d_id;
END;
CREATE TRIGGER IF NOT EXISTS trg_n2d_del AFTER DELETE ON n2d
WHEN (SELECT n_state FROM nets WHERE net_id = OLD.net_id) = 0 BEGIN
    UPDATE nets  SET hits = MAX(hits - 1, 0) WHERE net_id = OLD.net_id;
    UPDATE dicts SET hits = MAX(hits - 1, 0) WHERE d_id  = OLD.d_id;
END;

CREATE TRIGGER IF NOT EXISTS trg_nets_bssids AFTER INSERT ON nets BEGIN
    INSERT OR IGNORE INTO bssids(bssid) VALUES (NEW.bssid);
END;

CREATE TABLE IF NOT EXISTS n2u (
    net_id INTEGER NOT NULL REFERENCES nets(net_id) ON DELETE CASCADE,
    u_id   INTEGER NOT NULL REFERENCES users(u_id),
    PRIMARY KEY (net_id, u_id)
);

CREATE TABLE IF NOT EXISTS users (
    u_id      INTEGER PRIMARY KEY,
    userkey   TEXT UNIQUE,
    linkkey   TEXT,
    linkkeyts REAL,
    mail      TEXT UNIQUE,
    ip        TEXT,
    ts        REAL NOT NULL DEFAULT (strftime('%s','now'))
);

CREATE TABLE IF NOT EXISTS rkg (
    net_id  INTEGER NOT NULL REFERENCES nets(net_id) ON DELETE CASCADE,
    algo    TEXT NOT NULL,
    pass    BLOB NOT NULL,
    n_state INTEGER NOT NULL DEFAULT 0
);

CREATE TABLE IF NOT EXISTS prs (
    p_id         INTEGER PRIMARY KEY,
    ssid         BLOB NOT NULL UNIQUE,
    default_ssid INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS p2s (
    p_id INTEGER NOT NULL REFERENCES prs(p_id),
    s_id INTEGER NOT NULL REFERENCES submissions(s_id),
    PRIMARY KEY (p_id, s_id)
);

-- Smart keyspace (the reference's dormant ks table, wired for real):
-- ssid_regex selects nets, pass_regex compiles to mask shards
-- (keyspace/compiler.py).  priority orders competing rows; enabled=0
-- parks a row without losing its n2m coverage history.
CREATE TABLE IF NOT EXISTS ks (
    ks_id      INTEGER PRIMARY KEY,
    ssid_regex TEXT NOT NULL,
    pass_regex TEXT NOT NULL,
    priority   INTEGER NOT NULL DEFAULT 0,
    enabled    INTEGER NOT NULL DEFAULT 1
);

-- Mask-shard coverage, mirroring n2d: one row per net x compiled mask x
-- keyspace range.  span counts candidates from offset skip (hashcat
-- -s/-l framing); hkey/epoch carry the same lease semantics as n2d
-- (non-NULL hkey = in flight; release NULLs it = done).  Reap DELETEs
-- stale rows so abandoned ranges reappear as coverage gaps and are
-- re-issued under a fresh epoch.
CREATE TABLE IF NOT EXISTS n2m (
    net_id INTEGER NOT NULL REFERENCES nets(net_id) ON DELETE CASCADE,
    ks_id  INTEGER NOT NULL REFERENCES ks(ks_id),
    mask_i INTEGER NOT NULL,    -- index into the compiled pass_regex masks
    skip   INTEGER NOT NULL,    -- keyspace offset of this shard
    span   INTEGER NOT NULL,    -- candidate count (the wire "limit")
    hkey   TEXT,
    epoch  INTEGER NOT NULL DEFAULT 0,
    ts     REAL NOT NULL DEFAULT (strftime('%s','now')),
    PRIMARY KEY (net_id, ks_id, mask_i, skip)
);
CREATE INDEX IF NOT EXISTS idx_n2m_hkey ON n2m(hkey);

CREATE TABLE IF NOT EXISTS stats (
    name  TEXT PRIMARY KEY,
    value INTEGER NOT NULL DEFAULT 0
);
"""

STAT_NAMES = [
    "nets", "cracked", "uncracked", "pmkid", "pmkid_cracked", "rkg", "rkg_cracked",
    "geo", "submissions", "users", "words", "triedwords", "24getwork", "24psk",
    "24sub", "24founds", "contributors",
]


class Database:
    """One sqlite connection with the dwpa schema applied.

    Thread-safe at statement granularity: a process-wide RLock serializes
    every q/q1/x, so the threaded WSGI server and the --with-jobs cron
    thread can share one handle.  This is the same coarse posture as the
    reference (MySQL serializes statements; the only larger critical
    section it needs is the get_work mutex, which ServerCore provides).
    """

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.RLock()
        self._tx_depth = 0  # mutated only while holding _lock
        # 30 s busy wait (default is 5 s): an ops writer holding a
        # transaction for a few seconds — migration tooling, a manual
        # sqlite session, the jobs process mid-regen — must make API
        # writes wait, not 500 them (the reference's MySQL posture).
        # isolation_level=None: sqlite3's implicit-BEGIN machinery is off;
        # statements autocommit unless tx() has opened an explicit
        # BEGIN IMMEDIATE, so transaction boundaries are exactly where
        # the code says they are.
        self.conn = sqlite3.connect(path, check_same_thread=False,
                                    timeout=30.0, isolation_level=None)
        self.conn.row_factory = sqlite3.Row
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA foreign_keys=ON")
        self.conn.executescript(SCHEMA)
        # Legacy databases predate the lease epoch column; CREATE TABLE
        # IF NOT EXISTS won't touch their n2d, so migrate in place.
        cols = [r[1] for r in self.conn.execute("PRAGMA table_info(n2d)")]
        if "epoch" not in cols:
            self.conn.execute(
                "ALTER TABLE n2d ADD COLUMN epoch INTEGER NOT NULL DEFAULT 0")
        # Legacy ks tables predate ks_id/priority/enabled; ALTER cannot
        # add a PRIMARY KEY column, so rebuild in place (rename, recreate
        # from SCHEMA, copy, drop).
        cols = [r[1] for r in self.conn.execute("PRAGMA table_info(ks)")]
        if cols and "ks_id" not in cols:
            self.conn.execute("ALTER TABLE ks RENAME TO ks_legacy")
            self.conn.executescript(SCHEMA)
            self.conn.execute(
                "INSERT INTO ks(ssid_regex, pass_regex) "
                "SELECT ssid_regex, pass_regex FROM ks_legacy")
            self.conn.execute("DROP TABLE ks_legacy")
        self.conn.executemany(
            "INSERT OR IGNORE INTO stats(name, value) VALUES (?, 0)",
            [(n,) for n in STAT_NAMES],
        )

    def close(self):
        self.conn.close()

    # -- tiny helpers ------------------------------------------------------

    def _exec(self, sql, params=()):
        """Every statement — including tx()'s BEGIN/COMMIT — funnels
        through this one call: the fault-injection seam the chaos
        harness wraps (chaos/dbfault.py)."""
        return self.conn.execute(sql, params)

    def q(self, sql, params=()):
        with self._lock:
            return self._exec(sql, params).fetchall()

    def q1(self, sql, params=()):
        with self._lock:
            return self._exec(sql, params).fetchone()

    def x(self, sql, params=()):
        # Transaction-aware: inside an open tx() the statement joins the
        # transaction and lands (or vanishes) with its COMMIT; outside,
        # autocommit makes it durable immediately — same as before.
        with self._lock:
            return self._exec(sql, params)

    @contextlib.contextmanager
    def tx(self):
        """Explicit transaction seam: ``BEGIN IMMEDIATE`` .. COMMIT, or
        ROLLBACK on any exception.  Reentrant: nested ``tx()`` blocks
        join the outermost transaction (depth-counted), so helper
        methods can declare their own atomicity and still compose into a
        caller's larger transaction.  Holds the statement lock for the
        whole block — within a process a transaction is exclusive, and
        BEGIN IMMEDIATE serializes writers across processes.
        """
        with self._lock:
            if self._tx_depth == 0:
                self._exec("BEGIN IMMEDIATE")
            self._tx_depth += 1
            try:
                yield self
            except BaseException:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    # A faulted/crashed connection may already be out of
                    # its transaction — the rollback is best-effort, the
                    # raise is not.
                    try:
                        self.conn.rollback()
                    except sqlite3.Error:
                        pass
                raise
            else:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    try:
                        self._exec("COMMIT")
                    except BaseException:
                        try:
                            self.conn.rollback()
                        except sqlite3.Error:
                            pass
                        raise

    def set_stat(self, name: str, value: int):
        self.x("INSERT OR REPLACE INTO stats(name, value) VALUES (?, ?)", (name, value))

    def get_stat(self, name: str) -> int:
        row = self.q1("SELECT value FROM stats WHERE name = ?", (name,))
        return row["value"] if row else 0


def mac2long(mac: bytes) -> int:
    """6-byte MAC -> int (MACs live as integers, like the reference's BIGINT)."""
    return int.from_bytes(mac, "big")


def long2mac(v: int) -> bytes:
    return int(v).to_bytes(6, "big")


def now() -> float:
    return time.time()
