"""Seeded fault injection at the Database statement seam.

The transport chaos kit (plan.py/transport.py) shakes the client side of
the wire; this module shakes the server's floor.  ``install`` wraps
``Database._exec`` — the single funnel every statement passes through,
inside and outside transactions — so a fault lands at an exact statement
boundary and the ``Database.tx`` machinery has to cope:

- ``op_error``   sqlite3.OperationalError("database is locked"): the
                 classic contention error; the API layer maps it to
                 HTTP 503 + Retry-After.
- ``disk_io``    sqlite3.OperationalError("disk I/O error"): a scarier
                 flavor with the same contract — the open transaction
                 rolls back, no partial multi-statement effect survives.
- ``crash``      simulated process death mid-transaction: the connection
                 is rolled back (what the OS does for us when a process
                 holding an uncommitted sqlite transaction dies) and
                 :class:`SimulatedCrash` propagates.  The Database object
                 stays usable afterwards — "the operator restarted the
                 core" — so soak tests can crash at every statement
                 boundary of every endpoint in one process.

Like :class:`dwpa_tpu_torch.chaos.plan.FaultPlan`, decisions are drawn from a
private ``random.Random(seed)`` keyed by the statement's leading SQL verb
(``insert``/``update``/``select``/...), forced faults queue FIFO per
verb, and ``schedule()`` returns the full decision log so two runs with
the same seed can be compared outright.

``sweep_invariants`` is the post-run judge: given a (re)opened Database
it checks the lease/coverage ledgers for the damage a torn multi-
statement path would leave — orphan in-flight rows, coverage under dead
leases, double-live leases, residue under cracked nets.
"""

import random
import sqlite3

# Statement-seam fault kinds understood by install():
DB_FAULT_KINDS = ("op_error", "disk_io", "crash")


class SimulatedCrash(RuntimeError):
    """The core 'process' died at a statement boundary.

    Deliberately NOT an sqlite3.Error: nothing in the stack may catch
    and absorb it — it must unwind like a kill -9 would.
    """


class DbFaultPlan:
    """Seeded schedule of statement-seam faults (FaultPlan's shape).

    Consulted once per executed statement; the key is the statement's
    lowercased first word, so ``force("insert", "crash")`` crashes the
    core at the next INSERT regardless of which endpoint issues it.
    ``begin``/``commit`` are valid keys too — faulting the commit itself
    is the nastiest torn-write case.
    """

    def __init__(self, seed: int, rate: float = 0.0, kinds=DB_FAULT_KINDS):
        self.seed = seed
        self.rate = rate
        self.kinds = tuple(kinds)
        self._rng = random.Random(seed)
        self._forced = {}  # verb -> [kind, ...] FIFO
        self._at = {}      # stmt_index -> kind
        self._log = []     # (stmt_index, verb, kind-or-None)

    def force(self, verb: str, kind: str) -> "DbFaultPlan":
        if kind not in DB_FAULT_KINDS:
            raise ValueError(f"unknown db fault kind: {kind!r}")
        self._forced.setdefault(verb.lower(), []).append(kind)
        return self

    def force_at(self, index: int, kind: str) -> "DbFaultPlan":
        """Queue ``kind`` for the ``index``-th executed statement
        (0-based) — how the consistency sweep crashes the core at EVERY
        statement boundary of an endpoint, one boundary per run."""
        if kind not in DB_FAULT_KINDS:
            raise ValueError(f"unknown db fault kind: {kind!r}")
        self._at[int(index)] = kind
        return self

    def next_fault(self, verb: str):
        queue = self._forced.get(verb)
        if len(self._log) in self._at:
            kind = self._at.pop(len(self._log))
        elif queue:
            kind = queue.pop(0)
        elif self.rate and self._rng.random() < self.rate:
            kind = self.kinds[self._rng.randrange(len(self.kinds))]
        else:
            kind = None
        self._log.append((len(self._log), verb, kind))
        return kind

    def schedule(self) -> list:
        return list(self._log)

    def kinds_injected(self) -> set:
        return {kind for _, _, kind in self._log if kind is not None}


def install(db, plan):
    """Wrap ``db._exec`` with ``plan``; returns an uninstall closure.

    The fault fires BEFORE the statement executes — the canonical torn
    write: everything earlier in the transaction happened, this
    statement and everything after did not.  On ``crash`` the open
    transaction is rolled back first (a dead process's uncommitted
    transaction never reaches the file) so the same Database object can
    keep serving as "the restarted core".
    """
    inner = db._exec

    def faulted_exec(sql, params=()):
        verb = sql.split(None, 1)[0].lower() if sql else ""
        kind = plan.next_fault(verb)
        if kind == "op_error":
            raise sqlite3.OperationalError("database is locked")
        if kind == "disk_io":
            raise sqlite3.OperationalError("disk I/O error")
        if kind == "crash":
            try:
                db.conn.rollback()
            except sqlite3.Error:
                pass
            db._tx_depth = 0
            raise SimulatedCrash(f"chaos: core died before {verb!r}")
        return inner(sql, params)

    db._exec = faulted_exec

    def uninstall():
        db._exec = inner

    return uninstall


def sweep_invariants(db) -> list:
    """Post-run consistency sweep; returns a list of violation strings
    (empty == healthy).  Every check is a property a torn multi-
    statement path would break and an atomic one cannot:

    - in-flight coverage (n2d.hkey set) must reference a LIVE lease of
      the same epoch — a released/reaped lease with coverage still
      checked out is a double-credit hazard;
    - a live lease must have coverage rows — a lease with nothing
      checked out can never be released by honest work;
    - one live lease per hkey (schema UNIQUE makes this structural, but
      the sweep re-checks in case the schema drifted);
    - cracked nets (n_state=1) must have zero n2d rows — the accept
      cascade deletes them so dict stats never count a solved net.
    """
    bad = []
    for r in db.q(
        """SELECT n.net_id, n.hkey, n.epoch FROM n2d n
           WHERE n.hkey IS NOT NULL AND NOT EXISTS
             (SELECT 1 FROM leases l
              WHERE l.hkey = n.hkey AND l.epoch = n.epoch AND l.state = 0)"""
    ):
        bad.append("orphan in-flight coverage: net %s under hkey %s epoch %s "
                   "has no live lease" % (r["net_id"], r["hkey"], r["epoch"]))
    for r in db.q(
        """SELECT l.hkey FROM leases l
           WHERE l.state = 0 AND NOT EXISTS
             (SELECT 1 FROM n2d n WHERE n.hkey = l.hkey)"""
    ):
        bad.append("hollow live lease: hkey %s holds no coverage" % r["hkey"])
    for r in db.q(
        """SELECT hkey, COUNT(*) c FROM leases
           WHERE state = 0 GROUP BY hkey HAVING c > 1"""
    ):
        bad.append("double-live lease: hkey %s live %d times"
                   % (r["hkey"], r["c"]))
    for r in db.q(
        """SELECT DISTINCT n2d.net_id FROM n2d
           JOIN nets ON nets.net_id = n2d.net_id
           WHERE nets.n_state = 1"""
    ):
        bad.append("coverage residue under cracked net %s" % r["net_id"])
    return bad
