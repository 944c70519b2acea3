"""The volunteer client main loop, with the GPU engine as the cracker.

Equivalent of the reference client's fetch->crack->submit loop
(help_crack.py run(), :881-957), on one device:

- challenge gate: before any work is fetched, the engine must crack a
  synthesized known-PSK PMKID + EAPOL pair (``client/challenge.py``),
  then prewarm the work-sized steps through the candidate feed;
- work loop: get_work -> resume snapshot -> dict download (md5-checked,
  cached by dhash) -> two-pass crack (pass 1: targeted candidates from the
  hash material + dynamic PR dict + cracked/rkg dicts; pass 2: the
  server dicts) -> put_work;
- dictcount autotune +/-1 against the 900 s work-unit pacing target,
  clamped 1..15 (help_crack.py:947-952, get_work.php:41-46);
- resume file: a JSON snapshot of the work unit written before cracking
  and checkpointed after every batch, replayed on restart
  (help_crack.py:737-763);
- potfile: founds appended as ``<hashline>:<psk>`` for user tooling; a
  durable outbox journals founds before put_work.

Both passes consume framed blocks from ``CandidateFeed``: producer
threads stream, decode and pack candidates (pure host work, no CUDA
call), and ``M22000Engine.crack_blocks`` stages each block's rows on a
CUDA side stream.

Single process, single device.  What the port does not do yet is refused
loudly, never approximated: a unit carrying hashcat ``rules`` (on-device
rules, ROADMAP later slice 3) or ``masks`` (on-device mask generation,
slice 7) raises ``UnsupportedUnit`` and ``run`` abandons it (the
server's lease reap reassigns it); a PMK cache (slice 4), unit fusion
(slice 5), forced device streams (slice 6) and a dict cache raise at
construction.
"""

import itertools
import json
import os
import re
import time
from dataclasses import dataclass

from .. import __version__
from ..feed import CandidateFeed
from ..gen import DictStream, psk_candidates
from ..models import hashline as hl
from ..models.m22000 import M22000Engine
from ..obs import SpanTracer, default_registry, get_logger, setup_logging
from ..oracle import m22000 as oracle
from ..parallel.device import resolve_device
from ..utils.fsio import fsync_replace
from .. import testing as synth
from .challenge import CHALLENGE_PSK, challenge
from .outbox import FoundOutbox
from .protocol import NoNets, PermanentError, ServerAPI, VersionRejected
from .targeted import targeted_candidates

PACE_TARGET_S = 900.0  # work-unit pacing target (reference autotune threshold)

#: The ``_ver`` stamp of this client's resume checkpoints.  It differs
#: from the JAX package's, so a workdir checkpoint written by one
#: package is never replayed by the other (stream order is only sound
#: against the exact build that wrote it, see ``_write_resume``).
RESUME_VERSION = f"{__version__}+torch"


class UnsupportedUnit(Exception):
    """A work unit needs a feature the port does not have yet.

    Deliberately not a ``RuntimeError``: ``_process_with_recovery``
    retries those at half batch, and a missing feature does not heal on
    a retry.  ``run`` abandons the unit instead."""


def version_tuple(v: str):
    """Order dotted versions with optional alpha suffixes, matching the
    reference's numeric+alpha compare (help_crack.py:128-156)."""
    parts = []
    for piece in v.strip().split("."):
        m = re.match(r"(\d*)(.*)", piece)
        parts.append((int(m.group(1) or 0), m.group(2)))
    return tuple(parts)


@dataclass
class ClientConfig:
    base_url: str
    workdir: str = "hc_work"
    dictcount: int = 1
    batch_size: int = 16384
    additional_dict: str = None     # -ad equivalent
    potfile: str = None             # -pot equivalent (default: workdir/potfile)
    nc: int = 8
    max_work_units: int = 0         # 0 = run forever
    pace_target: float = PACE_TARGET_S
    cracked_refresh: int = 100      # re-download cracked/rkg dicts every
                                    # N work units (DAW dl_count cadence,
                                    # help_crack.py:47,524-529)
    feed_depth: int = 2             # candidate-feed queue depth (blocks
                                    # framed ahead of the engine)
    feed_workers: int = None        # candidate-feed producer threads
                                    # (None = one, for the one device;
                                    # 0 = inline/synchronous feed)
    archive: bool = True            # append-only archive.22000/archive.res
                                    # audit logs (DAW, help_crack.py:453-456)
    pmk_cache_dir: str = None       # not ported yet (ROADMAP later slice 4)
    dict_cache_dir: str = None      # not ported yet (ROADMAP "DictCache")
    unit_queue: int = None          # unit fusion knobs: not ported yet
    fuse_max_units: int = None      # (ROADMAP later slice 5)
    device_streams: str = "auto"    # "on" is not ported yet (ROADMAP later
                                    # slice 6); "auto"/"off" run lockstep
                                    # on the one device
    max_tries: int = 0              # --max-tries: transport attempts per
                                    # call (0 = retry forever, reference
                                    # behavior)
    backoff: float = 123.0          # --backoff: retry base delay; also
                                    # the idle (No nets) nap
    retry_cap: float = None         # --retry-cap: max retry delay for the
                                    # decorrelated-jitter ramp (None =
                                    # flat at --backoff, reference parity)
    outbox_dir: str = None          # --outbox-dir: durable found outbox
                                    # journal dir (default workdir/outbox)
    prefetch_units: int = 0         # --prefetch-units: extra work units
                                    # leased ahead while the transport is
                                    # healthy, cracked while it is OPEN
    device: str = None              # torch device; None = cuda:0


@dataclass
class WorkResult:
    hkey: str
    founds: list
    elapsed: float
    accepted: bool = False
    candidates_tried: int = 0
    stage_times: dict = None


def _refuse_unported(cfg: ClientConfig):
    """Raise for a configured feature that the port does not have yet."""
    if cfg.pmk_cache_dir:
        raise NotImplementedError(
            "pmk_cache_dir: the PMK store is not ported yet (ROADMAP later slice 4)")
    if cfg.dict_cache_dir:
        raise NotImplementedError(
            "dict_cache_dir: the packed-dictionary cache is not ported yet "
            "(ROADMAP item DictCache)")
    if cfg.unit_queue is not None or cfg.fuse_max_units is not None:
        raise NotImplementedError(
            "unit fusion is not ported yet (ROADMAP later slice 5)")
    if cfg.device_streams == "on":
        raise NotImplementedError(
            "device_streams='on': per-device streams are not ported yet "
            "(ROADMAP later slice 6)")
    if cfg.device_streams not in ("auto", "off"):
        raise ValueError(f"device_streams must be auto/on/off, not {cfg.device_streams!r}")


class TpuCrackClient:
    def __init__(self, config: ClientConfig, api: ServerAPI = None, log=None,
                 registry=None):
        _refuse_unported(config)
        self.cfg = config
        self.device = resolve_device(config.device)
        self.api = api or ServerAPI(
            config.base_url, max_tries=config.max_tries,
            backoff=config.backoff, retry_cap=config.retry_cap)
        if log is None:
            # one logging config for the whole process (obs.setup_logging
            # is idempotent); DWPA_LOG=json switches to structured lines
            setup_logging()
            log = get_logger("client").info
        self.log = log
        # Telemetry: all client metrics/spans land in one registry
        # (injectable for tests; default: the process-wide one).  The
        # transport layer is bound to the same registry so get_work/
        # put_work/dict-download counters + spans appear next to the
        # crack-loop spans.  Recording is pure host-side work.
        self.registry = registry or default_registry()
        self.tracer = SpanTracer(self.registry)
        bind = getattr(self.api, "bind_obs", None)
        if bind is not None:  # duck-typed test doubles stay unbound
            bind(self.registry, self.tracer)
        reg = self.registry
        self._m_pmks = reg.gauge(
            "dwpa_client_pmk_per_s",
            "candidates/s through the engine, by crack pass")
        self._m_autotune = reg.counter(
            "dwpa_client_autotune_total",
            "dictcount autotune decisions, by direction")
        self._m_dictcount = reg.gauge(
            "dwpa_client_dictcount", "current work-unit dictionary count")
        self._m_resume = reg.counter(
            "dwpa_client_resume_skipped_total",
            "candidates fast-forwarded by resume replay")
        # Registered for the scrape surface; nothing counts recompiles in
        # the port yet (ROADMAP: a torch counterpart of watch_compiles).
        self._m_recompiles = reg.counter(
            "dwpa_client_recompiles_total",
            "XLA compile-cache misses observed inside work units")
        self._m_units = reg.counter(
            "dwpa_client_work_units_total",
            "work units completed, by server verdict")
        self._m_founds = reg.counter(
            "dwpa_client_founds_total", "cracked PSKs recovered")
        self._m_engine_retries = reg.counter(
            "dwpa_client_engine_retries_total",
            "work units retried in-process after an engine error")
        os.makedirs(config.workdir, exist_ok=True)
        self.dictdir = os.path.join(config.workdir, "dicts")
        os.makedirs(self.dictdir, exist_ok=True)
        # Durable found outbox: every found is journaled before its first
        # put_work attempt and drained at startup/between units, so a
        # crash or server outage between crack and ack cannot lose a PSK.
        self.outbox = FoundOutbox(
            config.outbox_dir or os.path.join(config.workdir, "outbox"),
            registry=self.registry)
        # Degraded-mode unit buffer (_prefetch_units): units leased ahead
        # while the transport is healthy, cracked while it is OPEN.
        self._unit_buffer = []
        self.resume_path = os.path.join(config.workdir, "resume.json")
        self.potfile = config.potfile or os.path.join(config.workdir, "potfile")
        self.dictcount = max(1, min(15, config.dictcount))
        self._m_dictcount.set(self.dictcount)
        # cracked/rkg refresh countdown: primed to refresh on first use,
        # then every cfg.cracked_refresh units (DAW dl_count semantics).
        self._cracked_countdown = 0
        self._resuming = False
        self.last_result = None

    # -- self-update (help_crack.py:158-189) --------------------------------

    def check_update(self) -> bool:
        """Probe the server-published client version; download on newer.

        The reference overwrites sys.argv[0] and exits; a package can't
        safely self-overwrite mid-import, so the new archive lands in the
        workdir and run() exits for the supervisor to swap it in —
        operationally the same restart-to-update contract.
        """
        manifest = self.api.remote_version().split()
        # Manifest: "<version> [archive-md5]".  It must look like a
        # version — a misconfigured server returning an HTML page for the
        # probe must not trigger updates.
        remote = manifest[0] if manifest else ""
        md5 = manifest[1] if len(manifest) > 1 else None
        if not remote or not re.fullmatch(r"[0-9]+(\.[0-9]+)*[a-z0-9]*", remote):
            return False
        if version_tuple(remote) <= version_tuple(__version__):
            return False
        dest = os.path.join(self.cfg.workdir, f"dwpa_tpu-{remote}.pyz")
        try:
            # Bounded tries: a manifest pointing at a missing archive must
            # not park the crack loop in the infinite-retry backoff.
            self.api.download("hc/dwpa_tpu.pyz", dest, expected_md5=md5,
                              max_tries=2)
        except (ConnectionError, ValueError, OSError) as e:
            self.log(f"update {remote} advertised but download failed: {e}")
            return False
        self.log(f"update {__version__} -> {remote} downloaded to {dest}; restart to apply")
        return True

    # -- challenge gate ----------------------------------------------------

    def challenge(self) -> bool:
        """Known-PSK self-test; any failure disqualifies this cracker."""
        with self.tracer.span("challenge"):
            ok = challenge(device=self.device, nc=self.cfg.nc)
        self.log(f"challenge: {'passed' if ok else 'FAILED'}")
        if ok:
            self.prewarm()
        return ok

    def _feed_workers(self) -> int:
        """Configured producer count; one producer for the one device."""
        return 1 if self.cfg.feed_workers is None else self.cfg.feed_workers

    def prewarm(self):
        """Run the work-sized crack steps once behind the challenge gate,
        so the first work unit never pays first-use costs (the kernel
        library build, allocator growth, pinned-memory pools).

        Covers the PBKDF2 row widths real units hit — the configured batch
        size at every trimmed candidate width (W=4 for words <= 16 chars,
        W=8 up to 32, W=16 for the 33-63 passphrase tail) — through a
        MIXED ESSID group (PMKID + one EAPOL per keyver), streamed
        through the candidate feed, so prewarm takes the exact feed ->
        stage -> dispatch path real units take.
        """
        sp = self.tracer.start("prewarm")
        eng = M22000Engine(
            [
                synth.make_pmkid_line(CHALLENGE_PSK, b"dlink", seed="challenge-p"),
                synth.make_eapol_line(CHALLENGE_PSK, b"dlink", keyver=1,
                                      seed="warm-k1"),
                synth.make_eapol_line(CHALLENGE_PSK, b"dlink", keyver=2,
                                      seed="challenge-e"),
                synth.make_eapol_line(CHALLENGE_PSK, b"dlink", keyver=3,
                                      seed="warm-k3"),
            ],
            nc=self.cfg.nc, batch_size=self.cfg.batch_size, device=self.device,
        )
        n = eng.batch_size
        # one block per width bucket
        warm_words = itertools.chain(
            (b"warm-%08d" % i for i in range(n)),
            (b"warm-long-padding-%08d" % i for i in range(n)),
            (b"warm-full-width-passphrase-padding-%08d" % i
             for i in range(n)),
        )
        feed = CandidateFeed(warm_words, batch_size=n,
                             depth=self.cfg.feed_depth,
                             producers=self._feed_workers(),
                             prepack=eng.host_packer(),
                             registry=self.registry, name="prewarm")
        try:
            eng.crack_blocks(feed)
        finally:
            feed.close()
        # crack_blocks syncs internally (hits gate), so the span's clock
        # stops after real device completion
        sp.stop()
        self.log(f"prewarm: work-size steps ready in {sp.seconds:.1f}s")

    # -- work-unit plumbing ------------------------------------------------

    def _write_resume(self, work: dict):
        # Atomic replace: the checkpoint is rewritten mid-unit after every
        # batch, and a crash during the write must never corrupt the only
        # copy (a truncated snapshot would be discarded on restart and the
        # whole work unit lost until the server's lease reap).
        # The version + process-count + batch-size stamps gate replay:
        # skip-by-count is only sound against the exact stream order this
        # client build generates with this batch size.
        work["_ver"] = RESUME_VERSION
        work["_nproc"] = 1
        work["_batch"] = self.cfg.batch_size
        # fsync file AND directory around the replace (utils.fsio): a
        # bare os.replace is atomic against crashes of this process but
        # not against power loss — the rename can reach disk before the
        # tmp file's data, resurrecting an older-but-valid checkpoint
        # whose skip count double-counts candidates never re-tried.
        tmp = self.resume_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(work, f)
            f.flush()
        fsync_replace(tmp, self.resume_path)

    def _clear_resume(self):
        if os.path.exists(self.resume_path):
            os.unlink(self.resume_path)

    def _read_resume(self) -> dict:
        if not os.path.exists(self.resume_path):
            return None
        try:
            with open(self.resume_path) as f:
                work = json.load(f)
            if ("hkey" in work and "hashes" in work and "dicts" in work
                    and work.get("_ver") == RESUME_VERSION
                    and work.get("_nproc") == 1
                    and work.get("_batch") == self.cfg.batch_size):
                return work
        except (ValueError, OSError):
            pass
        self._clear_resume()
        return None

    def _fetch_dicts(self, work: dict) -> list:
        """Download (or reuse cached) pass-2 work dicts; returns local
        paths.  cracked.txt.gz is excluded — it runs in pass 1 via
        ``_prefetch_cracked`` (the DAW client likewise removes it from
        the rules pass, help_crack.py:927-928)."""
        paths = []
        for d in work.get("dicts", []):
            if os.path.basename(d["dpath"]) == "cracked.txt.gz":
                continue
            dest = os.path.join(self.dictdir, d["dhash"] + ".gz")
            if not os.path.exists(dest):
                self.api.download(d["dpath"], dest, expected_md5=d["dhash"])
            paths.append(dest)
        return paths

    @staticmethod
    def _dict_key(path: str) -> str:
        """Dict-cache key for a pass-2 path: server dicts land as
        ``<dictdir>/<dhash>.gz`` (``_fetch_dicts``), so the basename IS
        the md5 the server published — and a regenerated dict gets a
        new dhash, which is the cache's invalidation rule.  Paths not
        named by an md5 (e.g. ``additional_dict``) return None."""
        stem = os.path.splitext(os.path.basename(path))[0]
        return stem if re.fullmatch(r"[0-9a-f]{32}", stem) else None

    def _prefetch_cracked(self, work: dict) -> list:
        """Download/refresh the cracked + rkg snapshots; returns the
        local file list.

        CONSUMER-THREAD ONLY (server calls): feed producer threads stream
        the returned files via ``_stream_cracked`` but must never fetch.

        DAW behavior (help_crack.py:469-509,512-529): when a work unit
        carries cracked.txt.gz, keep a local copy refreshed only every
        ``cracked_refresh`` units, fetch rkg.txt.gz alongside it
        (best-effort — stock servers serve it as a plain artifact), and
        run both before everything else: previously cracked and
        vendor-default keys are the highest-yield candidates.
        """
        entry = next(
            (d for d in work.get("dicts", [])
             if os.path.basename(d["dpath"]) == "cracked.txt.gz"),
            None,
        )
        if entry is None:
            return []
        cracked = os.path.join(self.dictdir, "cracked.txt.gz")
        rkg = os.path.join(self.dictdir, "rkg.txt.gz")
        # The cadence refresh is suppressed while replaying a resumed
        # unit (the skip-by-count fast-forward needs the same bytes the
        # crashed run streamed), but a *missing* file is always fetched —
        # yielding nothing would submit the unit with its highest-yield
        # candidates never tried.
        cadence = self._cracked_countdown <= 0 and not self._resuming
        if cadence or not os.path.exists(cracked):
            try:
                self.api.download(entry["dpath"], cracked, max_tries=2,
                                  expected_md5=entry.get("dhash"))
                self._cracked_countdown = self.cfg.cracked_refresh
            except (ConnectionError, ValueError, OSError):
                pass
            try:
                self.api.download("dict/rkg.txt.gz", rkg, max_tries=1)
            except (ConnectionError, ValueError, OSError):
                pass
        self._cracked_countdown -= 1
        return [p for p in (cracked, rkg) if os.path.exists(p)]

    def _stream_cracked(self, files: list):
        """Stream the prefetched cracked/rkg files — pure host work, safe
        on a feed producer thread.  (The JAX client also runs them through
        the unit's rules; a unit with rules is refused here.)"""
        for path in files:
            yield from DictStream(path)

    def _snapshot_prdict(self, work: dict):
        """Snapshot the dynamic PR dict into the work/resume state.

        CONSUMER-THREAD ONLY, hoisted ahead of the pass-1 feed: the
        server query AND the resume write must not run on a producer
        thread (two threads must never mutate/serialize the shared
        ``work`` dict).

        The server-side query is unordered and grows with new
        submissions, so re-fetching after a crash would misalign the
        resume's skip-by-count fast-forward; the snapshot rides every
        checkpoint write, making the stream deterministic.
        """
        if not work.get("prdict") or "_prdict_cache" in work:
            return
        try:
            words = self.api.get_prdict(work["hkey"])
        except (ConnectionError, ValueError, OSError):
            # OSError covers gzip.BadGzipFile etc.
            words = []
        work["_prdict_cache"] = [w.hex() for w in words]
        self._write_resume(work)

    def _check_supported(self, work: dict):
        """Refuse a unit the port cannot crack in full, before any work."""
        if work.get("rules"):
            raise UnsupportedUnit(
                "work unit carries hashcat rules; on-device rules are not "
                "ported yet (ROADMAP later slice 3)")
        if work.get("masks"):
            raise UnsupportedUnit(
                "work unit carries mask shards; on-device mask generation "
                "is not ported yet (ROADMAP later slice 7)")

    def _targeted_candidates(self, engine: M22000Engine, work: dict):
        """Pass-1 generator, in the DAW client's priority order
        (help_crack.py:615-687): ESSID-fingerprint family keyspaces
        first, then hash-material candidates, the dynamic PR dict, and
        any local additional dictionary.

        Derived from ``work["hashes"]`` — NOT the live engine view: the
        engine prunes nets on a find, so a stream generated from
        ``engine.groups``/``engine.nets`` after a mid-unit find would be
        shorter than the fresh-engine stream a resume rebuilds, and the
        skip-by-count fast-forward would under-skip.  Parsing the
        checkpointed hash list keeps the stream a pure function of the
        resume snapshot."""
        parsed = []
        for raw in work.get("hashes", []):
            try:
                parsed.append(hl.parse(raw))
            except ValueError:
                continue  # engine skips it too (M22000Engine.skipped)
        essids = list(dict.fromkeys(h.essid for h in parsed))
        yield from targeted_candidates(essids)
        for h in parsed:
            yield from psk_candidates(h.essid, h.mac_ap, h.mac_sta)
        # The dynamic PR dict reads ONLY the snapshot ``_snapshot_prdict``
        # hoisted into the work state before the feed started — this
        # generator runs on a producer thread and must stay pure host
        # work (no server calls, no resume writes).
        for wx in work.get("_prdict_cache") or []:
            yield oracle.hc_unhex(bytes.fromhex(wx))
        if self.cfg.additional_dict:
            yield from DictStream(self.cfg.additional_dict)

    def _record_founds(self, founds: list):
        # flush + fsync per found: the PSK is (or is about to be)
        # reported to the server, so a crash between the append and the
        # page cache reaching disk must not lose the operator's only
        # local copy of a cracked key.
        with open(self.potfile, "a") as f:
            for fd in founds:
                f.write(f"{fd.line.raw}:{fd.psk.decode('latin1')}\n")
                f.flush()
                os.fsync(f.fileno())

    def _archive_work(self, work: dict):
        """Append-only audit logs (DAW fork, help_crack.py:453-456,
        741-743): every work unit's hashlines land in archive.22000 and
        its resume snapshot in archive.res, so an operator can replay or
        post-mortem any unit the client ever handled."""
        if not self.cfg.archive:
            return
        with open(os.path.join(self.cfg.workdir, "archive.22000"), "a") as f:
            for line in work.get("hashes", []):
                f.write(line + "\n")
        with open(os.path.join(self.cfg.workdir, "archive.res"), "a") as f:
            f.write(json.dumps({k: v for k, v in work.items()
                                if not k.startswith("_")}) + "\n")

    # -- the loop ----------------------------------------------------------

    def _pass1_candidates(self, work: dict, cracked_files: list):
        """Pass-1 deterministic host-side stream: targeted generators,
        then cracked/rkg (highest-yield first, help_crack.py:615-687).
        Pure host work — runs on the feed's producer threads; every
        server call was hoisted (``_snapshot_prdict`` /
        ``_prefetch_cracked``)."""
        yield from self._targeted_candidates(None, work)
        yield from self._stream_cracked(cracked_files)

    def _fetch_pass2_paths(self, work: dict) -> list:
        """Fetch the pass-2 server dicts; returns local paths.

        CONSUMER-THREAD ONLY, at pass-2 start (a resume that skipped
        pass 1 still fetches here; the feed's producers then stream
        pure file reads)."""
        return self._fetch_dicts(work)

    def process_work(self, work: dict) -> WorkResult:
        """One work unit, traced end to end: the ``work_unit`` span
        parents the phase spans (pass1/pass2 here; dict_download and
        put_work via the bound transport), and the pass PMK/s gauges
        record inside."""
        with self.tracer.span("work_unit"):
            return self._process_work(work)

    def _process_work(self, work: dict) -> WorkResult:
        # Refused before anything is written: a unit this client cannot
        # crack in full is abandoned, never half-cracked.
        self._check_supported(work)
        # perf_counter: the elapsed drives the 900 s dictcount autotune
        # and the logged unit time — a wall-clock NTP step must not
        # corrupt either
        t0 = time.perf_counter()
        # Intra-unit resume (the hashcat --session analog): _progress
        # carries completed-candidate count and prior founds; the stream
        # is deterministic, so skipping replays exactly the unfinished
        # tail (at-least-once: a half-done batch is re-tried).
        # Persist the snapshot as-read (progress included) BEFORE popping:
        # a crash during the skip fast-forward below must not regress the
        # checkpoint to zero.
        self._write_resume(work)
        progress = work.pop("_progress", None) or {}
        skip = int(progress.get("done", 0))
        self._resuming = skip > 0
        if skip:
            self._m_resume.inc(skip)
        else:
            # once per unit: a resume replay must not duplicate the entry
            self._archive_work(work)
        prior_cand = list(progress.get("cand", []))
        engine = M22000Engine(
            work["hashes"], nc=self.cfg.nc, batch_size=self.cfg.batch_size,
            device=self.device,
        )
        founds = []
        done = skip

        def _checkpoint():
            work["_progress"] = {
                "done": done,
                "cand": prior_cand
                + [{"k": f.line.mac_ap.hex(), "v": f.psk.hex()} for f in founds],
            }
            self._write_resume(work)

        def on_batch(consumed, new_founds):
            nonlocal done
            done += consumed
            founds.extend(new_founds)
            _checkpoint()

        # Pass 1 materializes host-side, so its resume fast-forward is
        # the feed's producer-side skip; whatever the window doesn't
        # cover carries into pass 2.
        #
        # Both passes consume from the candidate feed (dwpa_tpu_torch/feed):
        # producer threads run the host stages (streaming, $HEX decode +
        # packing) behind a bounded block queue, so the device never
        # idles on host work — every server call and resume write is
        # hoisted onto this (consumer) thread first.
        cfg_feed = dict(depth=self.cfg.feed_depth,
                        producers=self._feed_workers(),
                        registry=self.registry)
        self._snapshot_prdict(work)
        with self.tracer.span("pass1") as sp1:
            cracked_files = self._prefetch_cracked(work)
            if skip:
                self.log(f"resuming work unit at candidate {skip}")
            feed1 = CandidateFeed(
                self._pass1_candidates(work, cracked_files),
                batch_size=self.cfg.batch_size, skip=skip,
                prepack=engine.host_packer(), name="pass1", **cfg_feed)
            try:
                engine.crack_blocks(feed1, on_batch=on_batch)
                # actually-skipped count (< skip on a short stream); the
                # remainder of the resume window carries into pass 2.
                # The skip ran before any framing, so this never blocks
                # on device work.
                skipped = feed1.skipped
            finally:
                feed1.close()
        # crack_blocks syncs internally (hits gate), so sp1's clock
        # stopped after real device completion; the gauge counts
        # candidates/s — PMKs computed per candidate per essid group
        tried1 = done - skip
        if tried1 and sp1.seconds > 0:
            self._m_pmks.labels(**{"pass": "1"}).set(tried1 / sp1.seconds)
        skip2 = skip - skipped
        with self.tracer.span("pass2") as sp2:
            paths = self._fetch_pass2_paths(work)
            words = (w for p in paths for w in DictStream(p))
            feed2 = CandidateFeed(
                words, batch_size=self.cfg.batch_size, skip=skip2,
                prepack=engine.host_packer(), name="pass2", **cfg_feed)
            try:
                engine.crack_blocks(feed2, on_batch=on_batch)
            finally:
                feed2.close()
        tried = done - skip
        tried2 = tried - tried1
        if tried2 and sp2.seconds > 0:
            self._m_pmks.labels(**{"pass": "2"}).set(tried2 / sp2.seconds)

        elapsed = time.perf_counter() - t0
        st = engine.stage_times
        crack_s = sum(st.values())
        # "prepare" is the RESIDUAL on-thread stage time (device staging
        # for feed-prepacked blocks): packing itself runs on the feed's
        # producer threads and is accounted to the feed:produce spans.
        self.log(
            "stages: stage+h2d=%.1fs dispatch=%.1fs device+sync=%.1fs "
            "other=%.1fs (tried %d)"
            % (st["prepare"], st["dispatch"], st["collect"],
               max(0.0, elapsed - crack_s), tried)
        )
        result = WorkResult(
            hkey=work["hkey"], founds=founds, elapsed=elapsed,
            candidates_tried=tried, stage_times=dict(st),
        )
        self.last_result = result
        if founds:
            self._record_founds(founds)
            self._m_founds.inc(len(founds))
        # prior founds from a resumed session are re-submitted: put_work
        # is idempotent server-side and the claim may not have landed
        cand = prior_cand + [
            {"k": f.line.mac_ap.hex(), "v": f.psk.hex()} for f in founds
        ]
        cand = [dict(t) for t in {tuple(sorted(c.items())) for c in cand}]
        try:
            result.accepted = self._submit(work["hkey"], cand,
                                           epoch=work.get("epoch"))
        except ConnectionError as e:
            # Degraded mode: the founds were journaled before the
            # attempt — delivery now belongs to the outbox drain, so a
            # dead server costs this unit an "accepted" flag, not the
            # PSKs and not a parked crack loop.
            if cand:
                self.log(f"put_work failed ({e}); "
                         f"{len(cand)} found(s) wait in the outbox")
            result.accepted = False
        self._m_units.labels(
            accepted="true" if result.accepted else "false").inc()
        self._clear_resume()
        self._autotune(elapsed)
        return result

    def _submit_tries(self) -> int:
        """Transport attempts per submission call.  With the outbox
        guaranteeing delivery, an unbounded (reference-style) retry would
        only park the crack loop — bound it; an explicit --max-tries is
        honored as-is."""
        return self.api.max_tries or 2

    def _submit(self, hkey: str, cand: list, epoch: int = None) -> bool:
        """Journal-then-send one unit's founds; acks on server OK.

        The outbox ``record`` is the durability point — it fsyncs before
        the first ``put_work`` attempt and drops any (hkey, bssid) the
        server already acked, so a resume-replay re-crack after a
        restart cannot double-submit.  ``epoch`` (from the work unit)
        keys the lease release server-side; outbox drains pass None and
        the server resolves the live epoch."""
        to_send = self.outbox.record(hkey, cand)
        if not to_send:
            # Nothing the server doesn't already have (all acked, or an
            # empty unit): an empty submission still reports the unit.
            if cand:
                return True
            return self.api.put_work(hkey, cand,
                                     max_tries=self._submit_tries(),
                                     epoch=epoch)
        accepted = self.api.put_work(hkey, to_send,
                                     max_tries=self._submit_tries(),
                                     epoch=epoch)
        if accepted:
            self.outbox.ack(hkey, to_send)
        return accepted

    def _drain_outbox(self):
        """Deliver journaled founds left over from crashes/outages —
        called at startup and between units; stops (and stays pending)
        on the first transport failure."""
        if not self.outbox.pending_count():
            return
        delivered = self.outbox.drain(
            lambda hkey, cand: self.api.put_work(
                hkey, cand, max_tries=self._submit_tries()))
        if delivered:
            self.log(f"outbox: delivered {delivered} journaled found(s)")
        left = self.outbox.pending_count()
        if left:
            self.log(f"outbox: {left} found(s) still pending delivery")

    def _prefetch_units(self):
        """Top the degraded-mode buffer up to ``prefetch_units`` extra
        leased units while the transport is healthy, so an OPEN circuit
        still has queued work to crack."""
        if self.cfg.prefetch_units <= 0:
            return
        while (len(self._unit_buffer) < self.cfg.prefetch_units
               and not self.api.circuit_open):
            try:
                self._unit_buffer.append(
                    self.api.get_work(self.dictcount, max_tries=1))
            except (NoNets, VersionRejected, ConnectionError, ValueError,
                    OSError):
                break  # best-effort: the serial path needs no buffer

    def _autotune(self, elapsed: float):
        if elapsed < self.cfg.pace_target and self.dictcount < 15:
            self.dictcount += 1
            self._m_autotune.labels(direction="up").inc()
        elif elapsed > self.cfg.pace_target and self.dictcount > 1:
            self.dictcount -= 1
            self._m_autotune.labels(direction="down").inc()
        self._m_dictcount.set(self.dictcount)

    #: In-process crack attempts per work unit before the unit is
    #: abandoned (attempt 1 at the configured batch, each retry attempt
    #: at half — see _process_with_recovery).
    ENGINE_RETRY_LIMIT = 3

    def _process_with_recovery(self, work: dict):
        """One work unit with in-process engine recovery.

        A crack dispatch that raises — a device falling off the bus, an
        out-of-memory at the configured batch — used to kill the whole
        client and lose the unit.  Instead: retry ONCE at half the batch
        size (an OOM at B usually fits at B/2; a transient device error
        just needs the re-dispatch), dropping the ``_progress`` checkpoint
        first because skip-by-count is only sound against the stream
        order of the batch size that wrote it (see _write_resume).  A
        second failure requeues the unit with backoff via the resume
        file; ``ENGINE_RETRY_LIMIT`` total attempts abandon it rather
        than wedge the loop.  Returns None when no result was produced.
        ``UnsupportedUnit`` is not a ``RuntimeError`` and passes through.
        """
        try:
            return self.process_work(work)
        except (NoNets, SystemExit, KeyboardInterrupt):
            raise
        except RuntimeError as e:
            self._m_engine_retries.inc()
            full = self.cfg.batch_size
            self.log(f"engine error: {e}; retrying unit at batch {full // 2}")
            work.pop("_progress", None)  # unsound across a batch change
            try:
                self.cfg.batch_size = max(1, full // 2)
                return self.process_work(work)
            except RuntimeError as e2:
                work.pop("_progress", None)
                attempts = int(work.get("_attempts", 0)) + 1
                work["_attempts"] = attempts
                self.cfg.batch_size = full  # restore BEFORE stamping resume
                if attempts >= self.ENGINE_RETRY_LIMIT:
                    self._clear_resume()
                    self.log(f"engine error persisted after {attempts} "
                             f"attempts; abandoning unit: {e2}")
                else:
                    self._write_resume(work)
                    self.log(f"engine error persisted: {e2}; unit requeued "
                             f"with backoff (attempt {attempts})")
                    self.api.sleep(self.api.backoff)
                return None
            finally:
                self.cfg.batch_size = full

    def run(self) -> int:
        """Update-check + challenge-gate, then loop work units; returns
        the number of units completed."""
        if self.check_update():
            raise SystemExit("client update downloaded; restart to apply")
        if not self.challenge():
            raise SystemExit("challenge failed: cracker output untrusted")
        done = 0
        while not self.cfg.max_work_units or done < self.cfg.max_work_units:
            # Founds journaled by a previous crash/outage go first: the
            # outbox drains at startup and between units, and a drain
            # stopped by a transport failure just retries next round.
            try:
                self._drain_outbox()
            except (ConnectionError, ValueError):
                pass
            work = self._read_resume()
            if work is None and self._unit_buffer:
                work = self._unit_buffer.pop(0)
            if work is None:
                try:
                    work = self.api.get_work(self.dictcount)
                except NoNets:
                    self.log("no nets available; sleeping")
                    self.api.sleep(self.api.backoff)
                    continue
            self._prefetch_units()
            try:
                res = self._process_with_recovery(work)
            except UnsupportedUnit as e:
                # The port cannot crack this unit in full: abandon it —
                # the server's lease reap reassigns it to another client.
                self._clear_resume()
                self.log(f"unsupported work unit: {e}; abandoning unit")
                continue
            except PermanentError as e:
                # A 4xx mid-unit (a dict the server no longer serves,
                # say) will not heal on replay: abandon the unit — the
                # server's lease reap reassigns it — instead of resuming
                # into the same rejection forever.
                self._clear_resume()
                self.log(f"permanent transport failure mid-unit: {e}; "
                         "abandoning unit")
                continue
            except ConnectionError as e:
                # Transport died mid-unit (say, a dict fetch while the
                # server is down).  The unit is checkpointed in the resume
                # file — nap until the circuit's next probe slot, then
                # replay it; any founds already cracked sit safely in the
                # outbox.
                nap = self.api.backoff
                breaker = getattr(self.api, "breaker", None)
                if breaker is not None and breaker.remaining() > 0:
                    nap = breaker.remaining()
                self.log(f"transport failure mid-unit: {e}; "
                         f"resuming in {nap:.0f}s")
                self.api.sleep(nap)
                continue
            if res is None:
                continue  # unit requeued (resume file) or abandoned
            done += 1
            self.log(
                f"work {res.hkey[:8]}: {len(res.founds)} founds / "
                f"{res.candidates_tried} candidates in {res.elapsed:.0f}s "
                f"(accepted={res.accepted}, dictcount->{self.dictcount})"
            )
        return done
