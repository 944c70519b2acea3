"""Durable found outbox: founds survive anything between crack and ack.

A cracked PSK used to live only in process memory between the crack and a
successful ``put_work`` — a client crash, server outage, or rejected
submission lost it (the reference client has the same window,
help_crack.py:727-735).  The outbox closes the window with a CRC32-framed
append-only journal, the same framing/commit idioms as the PMK store and
dict cache:

- every found is journaled **and fsynced** before the first ``put_work``
  attempt — the journal, not the socket, is the durability point;
- a server ``OK`` appends an ``ack`` tombstone; acked keys are never
  re-submitted (a resume-replay re-crack of the same bssid would
  otherwise double-submit after a restart);
- replay at open dedups by ``(hkey, k)`` — the key field is the bssid,
  which has exactly one PSK — keeping the latest value;
- a torn tail (power loss mid-append) is truncated at the last valid
  frame and journaling continues: skip, not fatal;
- compaction rewrites pending founds + ack tombstones through
  tmp + fsync + ``os.replace`` + dir-fsync (``utils.fsio``).

``TpuCrackClient`` drains the outbox at startup and between work units;
``drain`` stops at the first transport failure (the server is down — the
next drain retries) but keeps going past per-key rejections.

The submitting crack loop owns the journal in today's wiring, but the
mutators (``record``/``ack``/``close``) and the replay all run under one
mutex anyway: the journal survives power loss, so it should not be
undone by a background drain thread interleaving ``_append`` frames or
double-creating the file — thread-safety is part of the durability
story, not an optimization (concurrency rule DW302).
"""

import binascii
import json
import os
import struct
import threading

from ..utils.fsio import fsync_dir, fsync_replace

FILE_MAGIC = b"DWOB1\n"
FRAME_MAGIC = b"OBXF"
_HDR = struct.Struct("<II")  # payload length, crc32(payload)

JOURNAL_NAME = "found_outbox.jrnl"


def _frame(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True).encode()
    return FRAME_MAGIC + _HDR.pack(len(payload), binascii.crc32(payload)) + payload


def _walk_frames(blob: bytes):
    """Yield ``(record, end_offset)`` for every valid frame; stop at the
    first bad magic / short frame / CRC mismatch (torn tail)."""
    off = len(FILE_MAGIC)
    n = len(blob)
    while off < n:
        end = off + len(FRAME_MAGIC) + _HDR.size
        if blob[off:off + len(FRAME_MAGIC)] != FRAME_MAGIC or end > n:
            return
        length, crc = _HDR.unpack(blob[off + len(FRAME_MAGIC):end])
        payload = blob[end:end + length]
        if len(payload) != length or binascii.crc32(payload) != crc:
            return
        try:
            record = json.loads(payload)
        except ValueError:
            return
        off = end + length
        yield record, off


class FoundOutbox:
    def __init__(self, dirpath: str, registry=None):
        os.makedirs(dirpath, exist_ok=True)
        self.path = os.path.join(dirpath, JOURNAL_NAME)
        # One mutex over state + journal handle: record/ack interleaved
        # from two threads must never tear a frame or double-create the
        # file (module doc).
        self._mu = threading.Lock()
        # (hkey, k) -> v, insertion-ordered: drain submits in the order
        # founds were journaled.
        self._pending = {}
        self._acked = set()
        self._m_pending = self._m_acked = None
        if registry is not None:
            self._m_pending = registry.counter(
                "dwpa_outbox_pending_total",
                "founds journaled ahead of submission")
            self._m_acked = registry.counter(
                "dwpa_outbox_acked_total",
                "outbox founds acknowledged by the server")
        self._replay()
        # Journal creation is lazy (first append): a client that never
        # cracks anything never pays the create+fsync ceremony.
        self._f = None
        if os.path.exists(self.path):
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)

    # -- journal ----------------------------------------------------------

    def _replay(self):
        """Rebuild pending/acked state; truncate any torn tail; compact
        the journal if prior sessions left dead weight behind."""
        blob = b""
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                blob = f.read()
        if not blob.startswith(FILE_MAGIC):
            # Fresh (or unrecognizable) journal: start clean.  An
            # unrecognizable one is preserved next to the new journal
            # rather than silently destroyed.  Creation of the new
            # journal is deferred to the first append.
            if blob:
                os.replace(self.path, self.path + ".corrupt")
            return
        good_end = len(FILE_MAGIC)
        frames = 0
        with self._mu:
            for record, off in _walk_frames(blob):
                good_end = off
                frames += 1
                op = record.get("op")
                key = (record.get("hkey"), record.get("k"))
                if op == "found":
                    if key not in self._acked:
                        self._pending[key] = record.get("v")  # latest wins
                elif op == "ack":
                    self._acked.add(key)
                    self._pending.pop(key, None)
        live = len(self._pending) + len(self._acked)
        if good_end < len(blob) or frames > 2 * live:
            # Torn tail, or mostly superseded/duplicate frames: rewrite
            # the live state through the durable-commit path so appends
            # never chase garbage and the file stays bounded.
            self._commit_snapshot()

    def _commit_snapshot(self):
        tmp = self.path + f".tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(FILE_MAGIC)
            for (hkey, k) in self._acked:
                f.write(_frame({"op": "ack", "hkey": hkey, "k": k}))
            for (hkey, k), v in self._pending.items():
                f.write(_frame({"op": "found", "hkey": hkey, "k": k, "v": v}))
            f.flush()
        fsync_replace(tmp, self.path)

    def _append(self, records: list):
        # Caller holds ``_mu``: the lazy create and the frame writes
        # below must not interleave across threads.
        created = self._f is None
        if created:
            self._f = open(self.path, "w+b")
            self._f.write(FILE_MAGIC)
        for record in records:
            self._f.write(_frame(record))
        self._f.flush()
        os.fsync(self._f.fileno())
        if created:
            # First frame ever: also pin the directory entry so the
            # freshly created journal survives a crash.
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    # -- API --------------------------------------------------------------

    def record(self, hkey: str, cand: list) -> list:
        """Journal founds before their first ``put_work`` attempt.

        Returns the sublist that actually needs submitting — entries
        whose ``(hkey, k)`` was already acked are dropped (the server
        has them; re-sending is the duplicate this outbox exists to
        prevent)."""
        fresh = []
        with self._mu:
            for c in cand:
                key = (hkey, c["k"])
                if key in self._acked:
                    continue
                if self._pending.get(key) == c["v"]:
                    fresh.append(c)  # already journaled, still needs sending
                    continue
                self._pending[key] = c["v"]
                fresh.append(c)
                self._append([{"op": "found", "hkey": hkey,
                               "k": c["k"], "v": c["v"]}])
                if self._m_pending is not None:
                    self._m_pending.inc()
        return fresh

    def ack(self, hkey: str, cand: list):
        """Mark founds as accepted by the server.  Idempotent."""
        acks = []
        with self._mu:
            for c in cand:
                key = (hkey, c["k"])
                if key in self._acked:
                    continue
                self._acked.add(key)
                self._pending.pop(key, None)
                acks.append({"op": "ack", "hkey": hkey, "k": c["k"]})
                if self._m_acked is not None:
                    self._m_acked.inc()
            if acks:
                self._append(acks)

    def pending(self) -> dict:
        """``{hkey: [{"k":…, "v":…}, …]}`` in journaled order."""
        out = {}
        with self._mu:
            items = list(self._pending.items())
        for (hkey, k), v in items:
            out.setdefault(hkey, []).append({"k": k, "v": v})
        return out

    def drain(self, put_work) -> int:
        """Submit every pending found through ``put_work(hkey, cand)``.

        Acks on ``True``; a ``False`` (server rejected) leaves the entry
        pending for the next drain; a ``ConnectionError`` stops the
        whole drain (transport is down — later drains retry).  Returns
        the number of founds delivered."""
        delivered = 0
        for hkey, cand in self.pending().items():
            try:
                ok = put_work(hkey, cand)
            except ConnectionError:
                break
            if ok:
                self.ack(hkey, cand)
                delivered += len(cand)
        return delivered

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)

    def close(self):
        with self._mu:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
                self._f = None
                fsync_dir(os.path.dirname(os.path.abspath(self.path)))
