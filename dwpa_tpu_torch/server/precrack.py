"""Batched server-side pre-crack: fused mixed-ESSID PMK derivation.

The reference server gates every new net behind a per-candidate host
PBKDF2 pass (rkg.php) and replays cracked PSKs one ``check_key_m22000``
call at a time (common.php:916-932).  PBKDF2 is ~99% of that cost and
the client stack already knows how to batch it: the per-lane-salt
``pmk_kernel`` (models/m22000.py) derives one PMK per lane for a
*mixed-ESSID* batch, and ``sched.fuse`` owns the static-width packing
discipline.  This module points that machinery at the server's own
workload:

- :class:`PmkBatcher` — derive PMKs for ``(essid, word)`` pairs in
  fused device batches (static widths from ``fused_width``, per-lane
  salts from ``essid_salt_lanes``) through the PBKDF2 CUDA kernel,
  backed by the persistent PMK store and an in-process memo; a
  pure-host ``pmk_from_psk`` path covers deployments that ask for it
  (``device="off"``) and device-ineligible word lengths.  Every PMK it
  returns equals ``pmk_from_psk(word, essid)`` bit-for-bit (the kernel
  computes the identical integer recurrence), so verdicts finished
  through the oracle are independent of which path derived.
- :func:`verify_batch` — the one entry point every server-side verify
  loop routes through (lint rule DW115 keeps scalar oracle loops out of
  the server package): items follow the oracle's ``(line, keys,
  pmk)`` contract, PBKDF2 for all items is batched up front, and each
  verdict is finished by ``oracle.check_key_m22000(..., pmk=...)`` —
  bit-identical to the per-candidate oracle by construction.
- :class:`PrecrackEngine` — the ingestion sweep / recurring job: per
  unprocessed net, collect the vendor packs, IMEI sweeps, Single/
  Pattern mutations, the cracked-corpus dictionary and cross-net
  replay candidates; derive the whole wave as one fused mixed-ESSID
  batch; then demux hits per net inside the existing per-net
  ``Database.tx()`` accept cascade (rkg attempt rows + crack mark +
  ``algo`` release commit together, exactly like ``keygen_precompute``).

Trust boundary: the PMK store and ``seed()`` are caches, not oracles —
a poisoned entry can only make the MIC/PMKID comparison *fail* (costing
a miss); it can never manufacture an accept.  ``put_work``'s verifier
runs store-less, so its verdicts are always bit-identical to the pure
oracle.

This module is the one sanctioned home of the scalar oracle fallback
loop (DW115) and of the store write-back seam outside the engine
(DW108(b) ``PMKSTORE_WRITEBACK_FILES``).

Device choice: ``"auto"`` and ``"on"`` mean ``cuda:0`` and raise when
there is no card — the server never carries on on the host because it
found none; ``"off"`` is the host path, chosen explicitly; any other
value names a torch device (``"cpu"`` runs the plain torch PBKDF2, for
tests).
"""

import os
import threading

from ..models import hashline as hl
from ..obs import SpanTracer
from ..oracle import m22000 as oracle
from .db import long2mac

# WPA passphrase bounds (models.m22000.MIN/MAX_PSK_LEN without importing
# the torch-backed module at server start): only these lengths are
# device-packable and store-worthy; anything else host-derives.
_MIN_LEN, _MAX_LEN = 8, 63


def _torch_device(device: str):
    """The torch device a ``PmkBatcher`` derives on, or None for the
    host path (``"off"``).  ``"auto"``/``"on"`` resolve to ``cuda:0``
    and raise without a card."""
    if device == "off":
        return None
    from ..parallel.device import resolve_device

    return resolve_device(None if device in ("auto", "on") else device)


class PmkBatcher:
    """Batched PMK derivation with store/memo reuse.

    ``device``: ``"auto"`` or ``"on"`` (``cuda:0``; raises without a
    card), ``"off"`` (pure host), or a torch device (``"cpu"`` runs the
    plain torch PBKDF2, for tests).  ``store``: an optional
    ``pmkstore.PMKStore``; hits skip PBKDF2 entirely and fresh
    derivations are written back so no PMK is ever computed twice across
    server restarts.  Words are *decoded*
    candidate bytes (post ``hc_unhex``) — callers decode exactly once,
    the same place the oracle would.
    """

    def __init__(self, store=None, device: str = "auto", batch: int = 2048,
                 registry=None, max_memo: int = 1 << 16):
        self.store = store
        self.device = device
        self._dev = _torch_device(device)
        self.batch = batch
        self.max_memo = max_memo
        self._memo = {}
        # the memo is shared between request handlers (put_work /
        # ingestion) and the cron thread — every mutation holds this
        self._lock = threading.Lock()
        self._fill = None
        if registry is not None:
            self._fill = registry.gauge(
                "dwpa_precrack_batch_fill_fraction",
                "valid-lane fraction of the last fused pre-crack derive "
                "batch (padded to the static fused widths)")

    def device_enabled(self) -> bool:
        return self._dev is not None

    def seed(self, essid: bytes, word: bytes, pmk: bytes):
        """Pre-load a known PMK (e.g. a cracked sibling's stored PMK) so
        the sweep replays it for free.  Cache-trust only: a wrong value
        costs a miss at the MIC comparison, never a false accept."""
        with self._lock:
            self._memo[(essid, word)] = pmk

    def pmk(self, essid: bytes, word: bytes) -> bytes:
        """The PMK for one pair; memo -> single host derive fallback."""
        key = (essid, word)
        with self._lock:
            p = self._memo.get(key)
        if p is None:
            p = oracle.pmk_from_psk(word, essid)
            with self._lock:
                self._memo[key] = p
        return p

    def prewarm(self, pairs) -> dict:
        """Derive PMKs for every ``(essid, word)`` pair in one wave.

        Dedups, consults the store, batches the misses through the
        fused device kernel (or host PBKDF2), writes fresh derivations
        back to the store, and fills the memo ``pmk()`` reads from.
        Returns derivation stats (for logs/benches).
        """
        with self._lock:
            if len(self._memo) > self.max_memo:
                # bounded memo: dropping entries only costs re-derivation
                self._memo.clear()
            todo, seen = [], set()
            for essid, word in pairs:
                key = (essid, word)
                if key in seen or key in self._memo:
                    continue
                seen.add(key)
                todo.append(key)
        stats = {"requested": len(pairs), "unique": len(todo),
                 "store_hits": 0, "derived": 0, "fill": 1.0}
        if self.store is not None and todo:
            by_essid = {}
            for essid, word in todo:
                by_essid.setdefault(essid, []).append(word)
            todo, hits = [], []
            for essid, words in by_essid.items():
                for word, p in zip(words, self.store.lookup(essid, words)):
                    if p is None:
                        todo.append((essid, word))
                    else:
                        hits.append(((essid, word), p))
            stats["store_hits"] = len(hits)
            with self._lock:
                self._memo.update(hits)
        packable = [(e, w) for e, w in todo
                    if _MIN_LEN <= len(w) <= _MAX_LEN]
        oddball = [(e, w) for e, w in todo
                   if not (_MIN_LEN <= len(w) <= _MAX_LEN)]
        if packable:
            if self.device_enabled():
                pmks, fill = self._derive_device(packable)
            else:
                pmks = [oracle.pmk_from_psk(w, e) for e, w in packable]
                fill = 1.0
            stats["fill"] = fill
            if self._fill is not None:
                self._fill.set(fill)
            with self._lock:
                self._memo.update(zip(packable, pmks))
            if self.store is not None:
                by_essid = {}
                for (essid, word), p in zip(packable, pmks):
                    by_essid.setdefault(essid, ([], []))
                    by_essid[essid][0].append(word)
                    by_essid[essid][1].append(p)
                self.store.put_many(
                    (e, ws, ps) for e, (ws, ps) in by_essid.items())
        if oddball:
            # out-of-range lengths the oracle still derives (and rejects
            # at the MIC stage) — host-only, never stored
            derived = [((e, w), oracle.pmk_from_psk(w, e))
                       for e, w in oddball]
            with self._lock:
                self._memo.update(derived)
        stats["derived"] = len(packable) + len(oddball)
        return stats

    def _derive_device(self, items):
        """Fused mixed-ESSID device derive: per-lane salts, static
        widths, one PBKDF2 kernel launch a wave.  Returns (pmk bytes
        list, fill fraction of the last wave)."""
        import numpy as np
        import torch

        from ..models import m22000
        from ..sched.fuse import pack_salted_lanes

        out, fill = [], 1.0
        for lo in range(0, len(items), self.batch):
            chunk = items[lo:lo + self.batch]
            rows, salt1, salt2, nvalid = pack_salted_lanes(
                chunk, self.batch, 1)
            # ship only the word columns the longest candidate fills, as
            # the engine's fused path does (the PBKDF2 rebuilds the rest)
            w = m22000._trim_cols(max(len(word) for _, word in chunk))
            rows = np.ascontiguousarray(rows[:, :w])
            pmk = m22000.pmk_kernel(*(
                torch.from_numpy(a.view(np.int32)).to(self._dev)
                for a in (rows, salt1, salt2)))
            pmks = pmk[:, :nvalid].cpu().numpy().view(np.uint32)
            cols = np.ascontiguousarray(pmks.T).astype(">u4")
            out.extend(cols[i].tobytes() for i in range(nvalid))
            fill = nvalid / rows.shape[0]
        return out, fill


def verify_batch(items, nc: int, batcher: PmkBatcher = None):
    """Batch-verify oracle items; verdicts bit-identical to the oracle.

    ``items``: iterable of ``(line, keys, pmk)`` following the
    ``oracle.check_key_m22000`` contract (``line`` may be a parsed
    ``Hashline``; ``pmk`` applies to the first key only, exactly like
    the oracle).  All PBKDF2 work across all items is derived in one
    batched wave up front; each verdict is then *finished* by the oracle
    itself with the derived PMK injected, so the returned list matches
    ``[oracle.check_key_m22000(line, keys, pmk=pmk, nc=nc) for ...]``
    element for element — on device, on host, with or without a store
    (a poisoned store entry can only turn a match into a miss, and the
    default store-less batcher removes even that).
    """
    if batcher is None:
        batcher = PmkBatcher(device="off")
    parsed, pairs = [], []
    for line, keys, pmk in items:
        h = line if isinstance(line, hl.Hashline) else hl.parse(line)
        keys = list(keys)
        dec = [oracle.hc_unhex(k) for k in keys]
        parsed.append((h, keys, dec, pmk))
        # the provided pmk covers the first key (oracle semantics);
        # every later key needs its own derivation
        start = 1 if pmk is not None else 0
        pairs.extend((h.essid, d) for d in dec[start:])
    if pairs:
        batcher.prewarm(pairs)
    out = []
    for h, keys, dec, pmk in parsed:
        r = None
        for i, (k, d) in enumerate(zip(keys, dec)):
            p = pmk if (i == 0 and pmk is not None) \
                else batcher.pmk(h.essid, d)
            r = oracle.check_key_m22000(h, [k], pmk=p, nc=nc)
            if r:
                break
        out.append(r)
    return out


class PrecrackEngine:
    """The fused ingestion sweep / recurring pre-crack job.

    Collects every unprocessed net's candidate set — Single/Pattern
    mutations, vendor packs, IMEI sweeps, the cracked-corpus dictionary,
    cross-net replay — derives the whole wave as one fused mixed-ESSID
    batch through the :class:`PmkBatcher`, then demuxes hits per net
    with the same per-net transaction shape as ``keygen_precompute``:
    rkg attempt rows, the crack mark and the ``algo`` release commit
    together, so a crash mid-sweep leaves every net either fully
    processed or untouched (never half-recorded).
    """

    def __init__(self, core, batch: int = 2048, device: str = "auto",
                 store=None, generators=None, dict_limit: int = 64,
                 imei_limit: int = None, nc: int = None):
        from .core import SERVER_NC

        self.core = core
        self.nc = SERVER_NC if nc is None else nc
        self.batcher = PmkBatcher(store=store, device=device, batch=batch,
                                  registry=core.registry)
        self.generators = generators
        self.dict_limit = dict_limit
        self.imei_limit = imei_limit
        reg = core.registry
        self._m_cands = reg.counter(
            "dwpa_precrack_candidates_total",
            "pre-crack candidates collected, by source family")
        self._m_founds = reg.counter(
            "dwpa_precrack_free_founds_total",
            "nets cracked server-side by the batched pre-crack sweep")
        self._tracer = SpanTracer(reg)

    # -- candidate collection ---------------------------------------------

    def _generators(self):
        if self.generators is not None:
            return self.generators
        from ..gen.vendors import vendor_candidates

        if self.imei_limit is None:
            return [vendor_candidates]
        return [lambda bssid, ssid: vendor_candidates(
            bssid, ssid, imei_limit=self.imei_limit)]

    def _dict_corpus(self):
        """The cracked/rkg corpus, frequency-ordered (the same ordering
        ``regen_cracked_dict`` serves volunteers)."""
        if self.dict_limit <= 0:
            return []
        rows = self.core.db.q(
            """SELECT pass, COUNT(*) c FROM nets
               WHERE n_state = 1 AND pass IS NOT NULL AND LENGTH(pass) >= 8
               GROUP BY pass ORDER BY c DESC, pass LIMIT ?""",
            (self.dict_limit,))
        return [r["pass"] for r in rows]

    def _collect(self, net, h, bssid, corpus):
        """One net's ordered candidate list as (source, algo, word).

        Order preserves ``keygen_precompute``'s attribution (Single,
        Pattern, vendor families) and appends the server-only sources
        after: replay (cracked siblings — their stored PMKs are seeded
        into the batcher, so same-ESSID replay never re-derives), then
        the cracked-corpus dictionary.
        """
        from . import jobs

        cands = [("single", "Single", c)
                 for c in jobs.single_mode_candidates(bssid, h.essid)]
        from ..gen.psktool import psk_candidates

        cands += [("single", "Pattern", c)
                  for c in psk_candidates(h.essid, bssid)]
        for gen in self._generators():
            for algo, c in gen(bssid, h.essid):
                cands.append(
                    ("imei" if algo == "IMEI" else "vendor", algo, c))
        for sib in self.core._handshakes_like(h, n_state=1):
            w = sib["pass"]
            if not w:
                continue
            cands.append(("replay", "Replay", w))
            if sib["ssid"] == h.essid and sib["pmk"] is not None:
                self.batcher.seed(h.essid, oracle.hc_unhex(w), sib["pmk"])
        cands += [("dict", "Dict", w) for w in corpus]
        return cands

    # -- the sweep ---------------------------------------------------------

    def run(self, limit: int = 100) -> dict:
        """The recurring job: process up to ``limit`` algo-IS-NULL nets."""
        nets = self.core.db.q(
            "SELECT * FROM nets WHERE algo IS NULL AND n_state = 0 "
            "ORDER BY net_id LIMIT ?", (limit,))
        return self._run_nets(nets)

    def on_ingest(self, net_ids) -> dict:
        """The ingestion hook: sweep freshly added nets immediately."""
        ids = list(net_ids)
        if not ids:
            return {"processed": 0, "cracked": 0, "candidates": 0}
        marks = ",".join("?" * len(ids))
        nets = self.core.db.q(
            f"SELECT * FROM nets WHERE net_id IN ({marks}) "
            "AND algo IS NULL AND n_state = 0 ORDER BY net_id", ids)
        return self._run_nets(nets)

    def _run_nets(self, nets) -> dict:
        with self._tracer.span("job:precrack"):
            return self._sweep(nets)

    def _sweep(self, nets) -> dict:
        db = self.core.db
        corpus = self._dict_corpus()
        plan, counts = [], {}
        for net in nets:
            h = hl.parse(net["struct"])
            cands = self._collect(net, h, long2mac(net["bssid"]), corpus)
            plan.append((net, h, cands))
            for source, _, _ in cands:
                counts[source] = counts.get(source, 0) + 1
        for source, n in sorted(counts.items()):
            self._m_cands.labels(source=source).inc(n)

        # Phase 1 — ONE fused derive across every net's candidates (no
        # locks held): siblings sharing an ESSID dedup to a single lane.
        pairs = [(h.essid, oracle.hc_unhex(w))
                 for _, h, cands in plan for _, _, w in cands]
        if pairs:
            self.batcher.prewarm(pairs)

        # Phase 2 — demux per net: verdicts finished by the oracle with
        # the derived PMK injected (bit-identical to the scalar loop),
        # then one transaction per net, same shape as keygen_precompute.
        found = total = 0
        for net, h, cands in plan:
            total += len(cands)
            tried, hit = [], None
            for _, algo, cand in cands:
                tried.append((algo, cand))
                p = self.batcher.pmk(h.essid, oracle.hc_unhex(cand))
                r = oracle.check_key_m22000(h, [cand], pmk=p, nc=self.nc)
                if r:
                    hit = (algo, cand, r)
                    break
            hit_algo = hit[0] if hit else ""
            with self.core._getwork_lock:
                with db.tx():
                    row = db.q1(
                        "SELECT algo, n_state FROM nets WHERE net_id = ?",
                        (net["net_id"],))
                    if (row is None or row["algo"] is not None
                            or row["n_state"] != 0):
                        continue  # raced: accepted/processed meanwhile
                    for algo, cand in tried:
                        db.x(
                            "INSERT INTO rkg(net_id, algo, pass) "
                            "VALUES (?, ?, ?)",
                            (net["net_id"], algo, cand))
                    if hit:
                        _, cand, r = hit
                        self.core._mark_cracked(
                            net["net_id"], r[0], r[3], r[1] or 0, r[2] or "")
                        db.x(
                            "UPDATE rkg SET n_state = 1 "
                            "WHERE net_id = ? AND pass = ?",
                            (net["net_id"], cand))
                        found += 1
                    # setting algo (even '') releases the net
                    db.x("UPDATE nets SET algo = ? WHERE net_id = ?",
                         (hit_algo, net["net_id"]))
        if found:
            self._m_founds.inc(found)
            if self.core.dictdir:
                from .jobs import regen_rkg_dict

                regen_rkg_dict(
                    self.core, os.path.join(self.core.dictdir, "rkg.txt.gz"))
        return {"processed": len(plan), "cracked": found,
                "candidates": total}
