"""The volunteer client main loop, with the GPU engine as the cracker.

Equivalent of the reference client's fetch->crack->submit loop
(help_crack.py run(), :881-957), on one device:

- challenge gate: before any work is fetched, the engine must crack a
  synthesized known-PSK PMKID + EAPOL pair (``client/challenge.py``),
  then prewarm the work-sized steps through the candidate feed;
- work loop: get_work -> resume snapshot -> dict download (md5-checked,
  cached by dhash) -> two-pass crack (pass 1: targeted candidates from the
  hash material + dynamic PR dict + cracked/rkg dicts expanded through the
  unit's hashcat rules on the host; pass 2: the server dicts, expanded
  through those rules on the device when the unit carries any; then the
  unit's mask shards, generated on the device) -> put_work;
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
CUDA side stream.  A rules pass 2 feeds base-word blocks
(``RulesFeedSource``) to ``M22000Engine.crack_rules_blocks``, which
uploads each block once and mangles it on the device by every rule.
Server-issued mask shards reach the engine only as ``mask_blocks``
blocks (``crack_blocks``), which generate their candidates on the
device.  With ``pmk_cache_dir`` set, both passes run through a
persistent PMK store (``dwpa_tpu_torch.pmkstore``); with
``dict_cache_dir`` set, pass 2 reads every server dict after its first
pass from the packed-dictionary cache (``feed.dictcache``: pre-packed
rows, or pre-split rules bases, from an mmap; a resume is an index seek);
without it, one process's plain pass 2 finds each dict's lines with
numpy and packs them natively on the feed's producers
(``feed.framing.frame_spans``).

Bulk passes run lockstep on the client's device, or as independent
per-device streams (``device_streams``: ``"on"``, ``"off"``, or
``"auto"`` = ``parallel.streams.streams_default()``, which is off on a
one-card host).  ``fused_executor`` cracks a stream of small units as
fused mixed-ESSID batches (``sched/``).  Every unit runs under the build
sentinel (``analysis.recompile.watch_compiles``): a kernel or native
library built inside a unit counts in ``dwpa_client_recompiles_total``.

Multi-process slices (``parallel/mesh.py``, ``torch.distributed`` over
gloo): the processes act as ONE volunteer.  Process 0 alone talks to the
server (update probe, resume read, get_work, prdict, put_work) and
broadcasts each outcome, so every process cracks the same unit on its
own device; dict downloads stay per process (md5-pinned).  Pass 1 runs
replicated, pass 2 shards for real (without rules through the feed's
sharded framing, with rules through the flat ``crack_rules``), and every
batch's hits gate is global.  Every agreement helper is a collective
that every process must reach.
"""

import base64
import itertools
import json
import os
import re
import time
from dataclasses import dataclass

from .. import __version__
from ..analysis.recompile import watch_compiles
from ..feed import CandidateFeed, DictCache, DictFeedSource, RulesFeedSource
from ..feed.framing import frame_blocks, frame_spans
from ..gen import DictStream, psk_candidates
from ..gen.mask import mask_blocks
from ..models import hashline as hl
from ..models.m22000 import M22000Engine
from ..native import load_pack
from ..obs import (SpanTracer, default_registry, get_logger, is_emitter,
                   merged_slice_snapshot, setup_logging)
from ..oracle import m22000 as oracle
from ..parallel.device import resolve_device
from ..parallel.mesh import (allgather_host, broadcast_host, process_count,
                             process_index)
from ..parallel.streams import default_feed_workers, streams_default
from ..pmkstore import PMKStore
from ..rules import apply_rules, parse_rules
from ..sched import MultiUnitExecutor
from ..sched.executor import UNITS_PER_BATCH_BUCKETS
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


def _broadcast_json(obj):
    """Process 0's JSON-serializable ``obj`` (or None) on every process.

    The slice contract: exactly one process talks to the server per
    decision, and every process must then act on IDENTICAL data or the
    next collective pairs different batches.  Two fixed-shape broadcasts:
    the byte length (-1 = None), then the padded payload — a broadcast
    needs equal shapes on every process, so the length is agreed before
    the buffer exists.
    """
    import numpy as np

    data = b"" if obj is None else json.dumps(obj).encode()
    first = process_index() == 0
    n = int(broadcast_host(np.asarray(
        [-1 if first and obj is None else len(data)], np.int64))[0])
    if n < 0:
        return None
    buf = np.zeros(n, np.uint8)
    if first:
        buf[:n] = np.frombuffer(data, np.uint8)
    buf = broadcast_host(buf)
    return json.loads(buf.tobytes().decode())


def _allgather_strs(s: str, width: int = 256):
    """Every process's (truncated) string, in rank order.

    The fixed width keeps the allgather's equal-shape contract without a
    length negotiation; used for slice-wide agreement checks (versions,
    digests, error flags) where every process MUST reach the collective —
    a raise before it would strand the peers inside it.
    """
    import numpy as np

    buf = np.zeros(width, np.uint8)
    b = (s or "").encode()[:width]
    buf[: len(b)] = np.frombuffer(b, np.uint8)
    rows = allgather_host(buf).reshape(-1, width)
    return [bytes(r).rstrip(b"\0").decode("utf-8", "replace") for r in rows]


def shard_word_blocks(words, nproc: int, pid: int, batch_size: int,
                      pad_word: bytes = b""):
    """Block-slice a GLOBAL word stream into this process's 1/nproc
    share, yielding ``(host_words, global_count)`` per block.

    Every process consumes the identical global stream, takes its
    contiguous ``ceil(len(block) / nproc)`` slice of each ``batch_size x
    nproc`` block, and pads short slices with an invalid word, so every
    process feeds the engine the same number of same-sized batches.
    ``global_count`` is the number of real global candidates the block
    covers, so resume checkpoints count stream positions, not local
    rows.  The framing itself is ``feed.framing.frame_blocks``.
    """
    for blk in frame_blocks(words, batch_size, nproc=nproc, pid=pid,
                            pad_word=pad_word):
        yield blk.words, blk.count


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
                                    # (None = one per local CUDA device,
                                    # parallel.streams.default_feed_workers;
                                    # 0 = inline/synchronous feed)
    archive: bool = True            # append-only archive.22000/archive.res
                                    # audit logs (DAW, help_crack.py:453-456)
    pmk_cache_dir: str = None       # --pmk-cache-dir: persistent PMK
                                    # store; repeat (ESSID, word) pairs
                                    # skip PBKDF2 (None = off)
    pmk_cache_max_bytes: int = 256 * 1024 * 1024  # --pmk-cache-max-bytes:
                                    # store cap; the oldest segments are
                                    # evicted beyond it
    dict_cache_dir: str = None      # --dict-cache-dir: persistent packed
                                    # dict cache; repeat pass-2 dicts are
                                    # served pre-packed (None = off)
    dict_cache_max_bytes: int = 4 * 1024 * 1024 * 1024
                                    # --dict-cache-max-bytes: cache size cap
    unit_queue: int = 4             # --unit-queue: work units prefetched
                                    # ahead of the device by the fused
                                    # executor (dwpa_tpu_torch/sched)
    fuse_max_units: int = 8         # --fuse-max-units: max work units
                                    # packed into one fused device batch
                                    # (one salt-table row per ESSID)
    device_streams: str = "auto"    # --device-streams: independent
                                    # per-device crack streams ("on"),
                                    # lockstep ("off"), or "auto" = on for
                                    # one process with several CUDA
                                    # devices (streams_default)
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
    rule_workers: int = 0           # >1: expand PASS-1 rules (cracked/rkg
                                    # dicts) on a process pool; pass 2
                                    # expands on the device


@dataclass
class WorkResult:
    hkey: str
    founds: list
    elapsed: float
    accepted: bool = False
    candidates_tried: int = 0
    stage_times: dict = None


class TpuCrackClient:
    def __init__(self, config: ClientConfig, api: ServerAPI = None, log=None,
                 registry=None):
        if config.device_streams not in ("auto", "on", "off"):
            raise ValueError(
                f"device_streams must be auto/on/off, not {config.device_streams!r}")
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
        # Builds inside a unit (analysis.recompile.watch_compiles): a
        # kernel or native library compiled on the crack path.
        self._m_recompiles = reg.counter(
            "dwpa_client_recompiles_total",
            "kernel and native-library builds observed inside work units")
        self._m_units = reg.counter(
            "dwpa_client_work_units_total",
            "work units completed, by server verdict")
        self._m_founds = reg.counter(
            "dwpa_client_founds_total", "cracked PSKs recovered")
        self._m_engine_retries = reg.counter(
            "dwpa_client_engine_retries_total",
            "work units retried in-process after an engine error")
        # Fused-executor families are registered up front (idempotent by
        # name — fused_executor() binds the same series) so a metrics
        # scrape shows them at zero before the first fused wave runs.
        reg.histogram(
            "dwpa_fused_units_per_batch",
            "Work units packed into each fused device batch",
            buckets=UNITS_PER_BATCH_BUCKETS)
        reg.gauge("dwpa_fused_fill_fraction",
                  "Real-candidate fraction of the last fused batch")
        reg.gauge("dwpa_unit_queue_depth",
                  "Prefetched work units waiting in the executor queue")
        # Device-stream families likewise (parallel/streams.py); the
        # device-labeled series appear once the first stream dispatches.
        reg.counter("dwpa_stream_blocks_total",
                    "Feed blocks completed per device stream")
        reg.gauge("dwpa_stream_busy_fraction",
                  "Per-stream fraction of wall time spent in "
                  "prepare/dispatch/collect (1 - shared-queue wait)")
        reg.gauge("dwpa_stream_queue_depth",
                  "Shared work-queue depth at this stream's last pull")
        if config.additional_dict and process_count() > 1:
            # A per-process local file cannot feed a slice: the pass-1
            # streams must be byte-identical on every process.  Publish
            # it as a server dict.
            raise SystemExit(
                "additional_dict is process-local; in a multi-process "
                "slice publish it as a server dictionary instead")
        os.makedirs(config.workdir, exist_ok=True)
        self.dictdir = os.path.join(config.workdir, "dicts")
        os.makedirs(self.dictdir, exist_ok=True)
        # Durable found outbox: every found is journaled before its first
        # put_work attempt and drained at startup/between units, so a
        # crash or server outage between crack and ack cannot lose a PSK.
        # Every process of a slice opens a journal (cheap); only process
        # 0 — the slice's server voice — ever records or drains.
        self.outbox = FoundOutbox(
            config.outbox_dir or os.path.join(config.workdir, "outbox"),
            registry=self.registry)
        # Degraded-mode unit buffer (_prefetch_units): units leased ahead
        # while the transport is healthy, cracked while it is OPEN.
        self._unit_buffer = []
        # Persistent PMK store (optional): repeat (ESSID, word) pairs —
        # popular ESSIDs across uploads, overlapping dicts, pass-2
        # replays of pass-1 words — become disk hits instead of PBKDF2.
        self.pmk_store = None
        if config.pmk_cache_dir:
            if process_count() > 1:
                # The engine's store split is single-process (as JAX's):
                # a slice keeps the plain path.
                self.log("pmk store: disabled in a multi-process slice")
            else:
                self.pmk_store = PMKStore(
                    config.pmk_cache_dir,
                    max_bytes=config.pmk_cache_max_bytes,
                    registry=self.registry)
        # Persistent packed-dictionary cache (optional): pass-2 server
        # dicts — ~100%-recurring inputs keyed by dhash — are served as
        # mmap'd pre-packed blocks on every unit after the first (zero
        # gunzip/packing, O(1) resume seeks).  A changed server dict gets
        # a new dhash (old entries age out of the LRU cap).
        self.dict_cache = None
        if config.dict_cache_dir:
            self.dict_cache = DictCache(
                config.dict_cache_dir,
                max_bytes=config.dict_cache_max_bytes,
                registry=self.registry)
        self.resume_path = os.path.join(config.workdir, "resume.json")
        self.potfile = config.potfile or os.path.join(config.workdir, "potfile")
        self.dictcount = max(1, min(15, config.dictcount))
        self._m_dictcount.set(self.dictcount)
        # cracked/rkg refresh countdown: primed to refresh on first use,
        # then every cfg.cracked_refresh units (DAW dl_count semantics).
        self._cracked_countdown = 0
        self._resuming = False
        self._digest_cache = {}
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

    # -- device-stream plumbing (parallel/streams.py) ----------------------

    def _feed_workers(self) -> int:
        """Configured producer count, defaulting to one per local CUDA
        device so an N-stream host never starves behind one producer."""
        if self.cfg.feed_workers is not None:
            return self.cfg.feed_workers
        return default_feed_workers()

    def _use_streams(self) -> bool:
        """Whether bulk passes run as independent device streams
        (``crack_streams``) instead of lockstep dispatch: "on"/"off"
        force it; "auto" follows ``streams_default()`` — streams in one
        process with several CUDA devices, lockstep on one card (where
        they are the same thing) and in a multi-process slice (where the
        global hits gate is needed)."""
        mode = self.cfg.device_streams
        if mode == "on":
            return True
        if mode == "off":
            return False
        return streams_default()

    def _crack_blocks(self, engine, feed, on_batch=None):
        """Route one framed block stream through streams or lockstep,
        preserving the ``on_batch`` resume contract either way."""
        if self._use_streams():
            return engine.crack_streams(feed, on_batch=on_batch,
                                        registry=self.registry,
                                        tracer=self.tracer)
        return engine.crack_blocks(feed, on_batch=on_batch)

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
            tracer=self.tracer,
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
            # streams mode warms every stream's engine (the path real
            # units take); lockstep warms the one engine
            self._crack_blocks(eng, feed)
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
        work["_nproc"] = process_count()
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
                    and work.get("_nproc") == process_count()
                    and work.get("_batch") == self.cfg.batch_size):
                return work
        except (ValueError, OSError):
            pass
        self._clear_resume()
        return None

    def _file_digest(self, path: str) -> str:
        """md5 of a workdir file, cached by (size, mtime): the cracked/rkg
        snapshots only change on the refresh cadence, and the slice's
        agreement check runs every unit."""
        import hashlib

        st = os.stat(path)
        key = (path, st.st_size, st.st_mtime_ns)
        hit = self._digest_cache.get(key)
        if hit is None:
            h = hashlib.md5()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            hit = self._digest_cache[key] = h.hexdigest()
        return hit

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
        files = [p for p in (cracked, rkg) if os.path.exists(p)]
        if process_count() > 1:
            # cracked/rkg are NOT md5-pinned (best-effort artifacts), so a
            # server-side regen between two processes' downloads could
            # hand the slice different bytes and the pass-1 streams would
            # diverge.  Allgather (not a broadcast) so EVERY process sees
            # every digest and all raise together.
            mine = ",".join(
                f"{os.path.basename(p)}:{self._file_digest(p)}" for p in files)
            alld = _allgather_strs(mine)
            if len(set(alld)) != 1:
                raise RuntimeError(
                    "multi-process pass-1 dict snapshot mismatch (cracked/"
                    "rkg raced a server regen) — delete the local copies "
                    f"and restart the unit; digests: {alld}")
        return files

    def _stream_cracked(self, files: list, rules):
        """Stream the prefetched cracked/rkg files through the work
        rules — pure host work, safe on a feed producer thread."""
        for path in files:
            stream = DictStream(path)
            yield from (apply_rules(rules, stream, workers=self.cfg.rule_workers)
                        if rules else stream)

    def _snapshot_prdict(self, work: dict):
        """Snapshot the dynamic PR dict into the work/resume state.

        CONSUMER-THREAD ONLY, hoisted ahead of the pass-1 feed: the
        server query AND the resume write must not run on a producer
        thread (two threads must never mutate/serialize the shared
        ``work`` dict).

        The server-side query is unordered and grows with new
        submissions, so re-fetching after a crash would misalign the
        resume's skip-by-count fast-forward; the snapshot rides every
        checkpoint write, making the stream deterministic.  In a slice
        only process 0 queries, and broadcasts the snapshot: the pass-1
        stream must be byte-identical on every process.
        """
        if not work.get("prdict") or "_prdict_cache" in work:
            return
        hexes = None
        if process_index() == 0:
            try:
                words = self.api.get_prdict(work["hkey"])
            except (ConnectionError, ValueError, OSError):
                # OSError covers gzip.BadGzipFile etc.; a process-0 raise
                # here would strand the peers parked in the broadcast
                words = []
            hexes = [w.hex() for w in words]
        if process_count() > 1:
            hexes = _broadcast_json(hexes) or []
        work["_prdict_cache"] = hexes
        self._write_resume(work)

    def _rules(self, work: dict):
        """The unit's hashcat rules (base64 rule text), parsed; bad lines
        are skipped, as hashcat does."""
        blob = work.get("rules")
        if not blob:
            return []
        try:
            text = base64.b64decode(blob).decode("utf-8", "replace")
        except ValueError:
            return []
        return parse_rules(text.splitlines())

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

    def _pass1_candidates(self, work: dict, rules, cracked_files: list):
        """Pass-1 deterministic host-side stream: targeted generators,
        then cracked/rkg through the work rules (highest-yield first,
        help_crack.py:615-687).
        Pure host work — runs on the feed's producer threads; every
        server call was hoisted (``_snapshot_prdict`` /
        ``_prefetch_cracked``)."""
        yield from self._targeted_candidates(None, work)
        yield from self._stream_cracked(cracked_files, rules)

    def _fetch_pass2_paths(self, work: dict) -> list:
        """Fetch the pass-2 server dicts; returns local paths.

        CONSUMER-THREAD ONLY, at pass-2 start (a resume that skipped
        pass 1 still fetches here; the feed's producers then stream
        pure file reads).  In a slice a download failure on ONE process
        aborts the whole slice loudly: every process reaches the
        allgather below even on failure, then all raise together."""
        err = None
        try:
            paths = self._fetch_dicts(work)
        except (ConnectionError, ValueError, OSError) as e:
            if process_count() <= 1:
                raise
            err, paths = f"{type(e).__name__}: {e}", []
        if process_count() > 1:
            errs = [e for e in _allgather_strs(err or "") if e]
            if errs:
                raise RuntimeError(
                    f"pass-2 dict fetch failed on the slice: {errs}")
        return paths

    def process_work(self, work: dict) -> WorkResult:
        """One work unit, traced end to end: the ``work_unit`` span
        parents the phase spans (pass1/pass2/mask here; dict_download and
        put_work via the bound transport), and the pass PMK/s gauges
        record inside."""
        with self.tracer.span("work_unit"):
            return self._process_work(work)

    def _process_work(self, work: dict) -> WorkResult:
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
        # Mask shards keep their own progress counter: "done" counts the
        # pass-1/2 candidate stream, "mask_done" counts mask-keyspace
        # candidates — mixing them would make the pass-1 fast-forward
        # skip dict candidates that were never tried.
        mask_skip = int(progress.get("mask_done", 0))
        if process_count() > 1:
            # Processes may have checkpointed different done counts
            # before a crash; the slice needs one skip everywhere, so all
            # adopt process 0's (at-least-once: a lower value only
            # re-tries candidates).
            import numpy as np

            agreed = broadcast_host(np.asarray([skip, mask_skip], np.int64))
            skip, mask_skip = int(agreed[0]), int(agreed[1])
        self._resuming = skip > 0 or mask_skip > 0
        if self._resuming:
            self._m_resume.inc(skip + mask_skip)
        else:
            # once per unit: a resume replay must not duplicate the entry
            self._archive_work(work)
        prior_cand = list(progress.get("cand", []))
        engine = M22000Engine(
            work["hashes"], nc=self.cfg.nc, batch_size=self.cfg.batch_size,
            device=self.device, pmk_store=self.pmk_store, tracer=self.tracer,
        )
        founds = []
        done = skip
        mask_done = mask_skip

        def _checkpoint():
            with self.tracer.span("client:checkpoint"):
                work["_progress"] = {
                    "done": done,
                    "mask_done": mask_done,
                    "cand": prior_cand
                    + [{"k": f.line.mac_ap.hex(), "v": f.psk.hex()} for f in founds],
                }
                self._write_resume(work)

        def on_batch(consumed, new_founds):
            nonlocal done
            done += consumed
            founds.extend(new_founds)
            _checkpoint()

        def on_mask_batch(consumed, new_founds):
            nonlocal mask_done
            mask_done += consumed
            founds.extend(new_founds)
            _checkpoint()

        # Pass 1 materializes host-side, so its resume fast-forward is
        # the feed's producer-side skip; whatever the window doesn't
        # cover carries into pass 2.
        #
        # Pass-2 rules run ON DEVICE (crack_rules_blocks: one base-word
        # upload mangled by every rule — the hashcat-on-GPU analog of
        # help_crack.py:773's ``-S -r``), where candidates never exist
        # host-side; its own skip honors the same count contract.
        #
        # Both passes consume from the candidate feed (dwpa_tpu_torch/feed):
        # producer threads run the host stages (streaming, rule expansion,
        # $HEX decode + packing) behind a bounded block queue, so the
        # device never idles on host work — every server call and resume
        # write is hoisted onto this (consumer) thread first.
        rules = self._rules(work)
        cfg_feed = dict(depth=self.cfg.feed_depth,
                        producers=self._feed_workers(),
                        registry=self.registry)
        self._snapshot_prdict(work)
        # The build sentinel wraps every pass: a steady-state unit must
        # not build a kernel or native library (prewarm built them), and
        # when one does, the counter makes it visible fleet-wide.
        with watch_compiles() as comp:
            with self.tracer.span("pass1") as sp1:
                cracked_files = self._prefetch_cracked(work)
                if skip:
                    self.log(f"resuming work unit at candidate {skip}")
                # Pass 1 runs replicated in a slice: every process feeds
                # the identical targeted stream as its own share.
                feed1 = CandidateFeed(
                    self._pass1_candidates(work, rules, cracked_files),
                    batch_size=self.cfg.batch_size, skip=skip, nproc=1,
                    pid=0, prepack=engine.host_packer(), name="pass1",
                    **cfg_feed)
                try:
                    self._crack_blocks(engine, feed1, on_batch=on_batch)
                    # actually-skipped count (< skip on a short stream);
                    # the remainder of the resume window carries into
                    # pass 2.  The skip ran before any framing, so this
                    # never blocks on device work.
                    skipped = feed1.skipped
                finally:
                    feed1.close()
            # crack_blocks syncs internally (hits gate), so sp1's clock
            # stopped after real device completion; the gauge counts
            # candidates/s — PMKs computed per candidate per essid group.
            # The counts are the slice's (every process reports global
            # blocks), so each process records its 1/nproc share: the
            # slice report's sum is then the slice's rate, not nproc
            # times it.
            share = 1 / process_count()
            tried1 = done - skip
            if tried1 and sp1.seconds > 0:
                self._m_pmks.labels(**{"pass": "1"}).set(
                    tried1 * share / sp1.seconds)
            skip2 = skip - skipped
            with self.tracer.span("pass2") as sp2:
                paths = self._fetch_pass2_paths(work)
                if rules and process_count() > 1:
                    # A slice's rules pass: crack_rules takes the full
                    # global dict stream (every process downloads whole
                    # dicts anyway) and shards internally — each process
                    # uploads only its 1/nproc row slice and decodes
                    # finds from the gathered bit masks.  The feed
                    # supplies the base words (``words()`` flat view):
                    # dict read + gunzip on the producer threads.
                    words = (w for p in paths for w in DictStream(p))
                    feed2 = CandidateFeed(
                        words, nproc=1, pid=0, prepack=None, name="pass2",
                        batch_size=self.cfg.batch_size * process_count(),
                        **cfg_feed)
                    try:
                        engine.crack_rules(feed2.words(), rules,
                                           on_batch=on_batch, skip=skip2,
                                           registry=self.registry,
                                           tracer=self.tracer)
                    finally:
                        feed2.close()
                elif rules:
                    # The feed serves BASE-WORD blocks, framed per dict
                    # (warm ``.rbase`` entries skip the split + pack; cold
                    # dicts stream once and write the entry back), and
                    # the engine uploads each block once and expands it
                    # on the device by every rule; `@`-purge and overflow
                    # pairs are host-interpreted by the engine's seam.
                    # skip2 counts expanded candidates, the engine's
                    # resume domain.
                    src = RulesFeedSource(
                        [(p, self._dict_key(p)) for p in paths],
                        batch_size=self.cfg.batch_size, cache=self.dict_cache,
                        name="pass2", log=self.log)
                    feed2 = CandidateFeed(
                        None, batch_size=self.cfg.batch_size, frames=src,
                        prepack=None, name="pass2", **cfg_feed)
                    try:
                        crack = (engine.crack_rules_streams
                                 if self._use_streams()
                                 else engine.crack_rules_blocks)
                        crack(feed2, rules, on_batch=on_batch, skip=skip2,
                              registry=self.registry, tracer=self.tracer)
                    finally:
                        feed2.close()
                else:
                    # No-rules pass 2 shards across a slice's processes:
                    # the feed's sharded framing hands each process its
                    # padded 1/nproc slice of every global block, the
                    # resume skip applies to the GLOBAL stream, and the
                    # engine reports each block's global count.  One
                    # process degenerates to nproc=1 framing.
                    if self.dict_cache is not None:
                        # Packed-dict cache path: per-dict framing, warm
                        # dicts served as pre-packed mmap blocks, cold
                        # dicts streamed once and written back.  The
                        # source owns the resume skip — warm skips are
                        # index seeks.
                        src = DictFeedSource(
                            [(p, self._dict_key(p)) for p in paths],
                            batch_size=self.cfg.batch_size,
                            cache=self.dict_cache, skip=skip2, name="pass2",
                            log=self.log)
                        feed2 = CandidateFeed(
                            None, batch_size=self.cfg.batch_size, frames=src,
                            prepack=engine.host_packer(), name="pass2",
                            **cfg_feed)
                    elif process_count() == 1 and load_pack() is not None:
                        # No cache, one process: the dicts' lines found
                        # with numpy and packed natively on the producers
                        # (no bytes object a word), framed as the chained
                        # word stream would be, resume skip included.
                        src = frame_spans(
                            (sp for p in paths for sp in DictStream(p).spans()),
                            self.cfg.batch_size, skip=skip2)
                        feed2 = CandidateFeed(
                            None, batch_size=self.cfg.batch_size, frames=src,
                            prepack=engine.host_packer(), name="pass2",
                            **cfg_feed)
                    else:
                        words = (w for p in paths for w in DictStream(p))
                        feed2 = CandidateFeed(
                            words, batch_size=self.cfg.batch_size, skip=skip2,
                            prepack=engine.host_packer(), name="pass2",
                            **cfg_feed)
                    try:
                        self._crack_blocks(engine, feed2, on_batch=on_batch)
                    finally:
                        feed2.close()
            # Mask pass: server-issued keyspace shards, generated ON DEVICE
            # from (mask, custom, skip, limit) alone — zero candidate bytes
            # arrived on the wire.  mask_blocks frames each shard as MaskPrep
            # blocks in hashcat -s/-l coordinates (absolute keyspace
            # offsets), so the mask_done fast-forward resumes mid-shard
            # bit-identically: a restart replays exactly ``limit - done``
            # candidates of the lease's range.  In a slice each process
            # generates its share of every block.
            mask_entries = work.get("masks") or []
            if mask_entries:
                with self.tracer.span("mask") as spm:
                    mrem = mask_skip
                    for shard in mask_entries:
                        mlimit = int(shard["limit"])
                        if mrem >= mlimit:
                            mrem -= mlimit  # shard finished pre-restart
                            continue
                        custom = {k: v.encode("latin1") for k, v in
                                  (shard.get("custom") or {}).items()}
                        blocks = mask_blocks(
                            shard["mask"], self.cfg.batch_size,
                            skip=int(shard["skip"]) + mrem,
                            limit=mlimit - mrem, custom=custom)
                        mrem = 0
                        self._crack_blocks(engine, blocks,
                                           on_batch=on_mask_batch)
                triedm = mask_done - mask_skip
                if triedm and spm.seconds > 0:
                    self._m_pmks.labels(**{"pass": "mask"}).set(
                        triedm * share / spm.seconds)
        tried = (done - skip) + (mask_done - mask_skip)
        tried2 = done - skip - tried1
        if tried2 and sp2.seconds > 0:
            self._m_pmks.labels(**{"pass": "2"}).set(tried2 * share / sp2.seconds)
        if comp.count:
            self._m_recompiles.inc(comp.count)

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
        if process_count() > 1:
            # One submission per slice: process 0 talks to the server,
            # every process adopts its verdict (all decoded identical
            # founds).  A process-0 exception broadcasts as an error
            # sentinel — the peers are already parked in the broadcast
            # and would wait out the slice timeout if process 0 raised.
            acc = err = None
            if process_index() == 0:
                try:
                    acc = self._submit(work["hkey"], cand,
                                       epoch=work.get("epoch"))
                except ConnectionError:
                    acc = False  # journaled; the outbox drain retries
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"
            payload = _broadcast_json({"acc": acc, "err": err})
            if payload["err"]:
                raise ConnectionError(
                    f"put_work failed on process 0: {payload['err']}")
            result.accepted = bool(payload["acc"])
        else:
            try:
                result.accepted = self._submit(work["hkey"], cand,
                                               epoch=work.get("epoch"))
            except ConnectionError as e:
                # Degraded mode: the founds were journaled before the
                # attempt — delivery now belongs to the outbox drain, so
                # a dead server costs this unit an "accepted" flag, not
                # the PSKs and not a parked crack loop.
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
        on the first transport failure.  Process 0 alone in a slice."""
        if process_index() != 0 or not self.outbox.pending_count():
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
        still has queued work to crack (one process only: a slice cracks
        one agreed unit at a time)."""
        if process_count() > 1 or self.cfg.prefetch_units <= 0:
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

    def fused_executor(self, units):
        """A ``sched.MultiUnitExecutor`` bound to this client's device,
        config, telemetry and PMK store — the multi-unit fused crack path
        (``--unit-queue`` / ``--fuse-max-units``).  One process only, as
        JAX's: fused waves are assembled from whatever units the queue
        holds, so a slice's processes would crack different batches."""
        if process_count() > 1:
            raise RuntimeError(
                "unit fusion is single-process only (a multi-process "
                "slice takes the serial per-unit path)")
        return MultiUnitExecutor(
            units, batch_size=self.cfg.batch_size,
            unit_queue=self.cfg.unit_queue,
            fuse_max_units=self.cfg.fuse_max_units,
            nc=self.cfg.nc, device=self.device, pmk_store=self.pmk_store,
            registry=self.registry, tracer=self.tracer,
            streams="auto" if self.cfg.device_streams == "auto"
            else self._use_streams())

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
        the number of units completed.

        In a multi-process slice (``process_count() > 1``) process 0
        owns every server decision (update probe, resume read, get_work,
        put_work) and broadcasts the outcome, so all processes crack the
        SAME unit with their batches paired; dict downloads stay per
        process (md5-pinned, so the bytes are identical).  After every
        unit the slice merges its registries and process 0 reports the
        slice's PMK/s once (``_slice_report``).
        """
        multiproc = process_count() > 1
        pid = process_index()
        if multiproc:
            # A mixed-version slice is fatal by design (stream order is
            # version-dependent, see _write_resume), so agreement is
            # checked BEFORE any work, where the failure is a clear exit
            # rather than a mid-unit collective timeout.
            vers = _allgather_strs(__version__)
            if len(set(vers)) != 1:
                raise SystemExit(
                    f"mixed client versions across the slice: {vers}; "
                    "upgrade every process to the same build")
        # Every process probes/downloads (HTTP only, no collectives), so
        # an update lands on all of them; process 0's verdict alone
        # decides the restart.
        upd = self.check_update()
        if multiproc:
            upd = bool(_broadcast_json(upd if pid == 0 else None))
        if upd:
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
            if not multiproc:
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
            else:
                # Process-0 server errors (version gate, malformed work)
                # reach every process as a sentinel: the peers are
                # already parked in the broadcast.
                payload = {"work": None, "err": None}
                if pid == 0:
                    try:
                        payload["work"] = (self._read_resume()
                                           or self.api.get_work(self.dictcount))
                    except NoNets:
                        pass
                    except Exception as e:
                        payload["err"] = f"{type(e).__name__}: {e}"
                payload = _broadcast_json(payload)
                if payload["err"]:
                    raise SystemExit(
                        f"get_work failed on process 0: {payload['err']}")
                work = payload["work"]
                if work is None:
                    self.log("no nets available; sleeping")
                    self.api.sleep(self.api.backoff)
                    continue
            if multiproc:
                res = self.process_work(work)
            else:
                try:
                    res = self._process_with_recovery(work)
                except PermanentError as e:
                    # A 4xx mid-unit (a dict the server no longer serves,
                    # say) will not heal on replay: abandon the unit —
                    # the server's lease reap reassigns it — instead of
                    # resuming into the same rejection forever.
                    self._clear_resume()
                    self.log(f"permanent transport failure mid-unit: {e}; "
                             "abandoning unit")
                    continue
                except ConnectionError as e:
                    # Transport died mid-unit (say, a dict fetch while the
                    # server is down).  The unit is checkpointed in the
                    # resume file — nap until the circuit's next probe
                    # slot, then replay it; any founds already cracked sit
                    # safely in the outbox.
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
            if multiproc:
                self._slice_report()
        return done

    def _slice_report(self):
        """COLLECTIVE (multi-process only): merge every process's
        registry and report the slice's throughput ONCE — the slice is
        one volunteer, so its PMK/s must not appear nproc times.  Every
        process reaches this call (it sits on the per-unit path after
        put_work, which every process completes)."""
        merged = merged_slice_snapshot(self.registry)
        if is_emitter():
            p1 = merged.value("dwpa_client_pmk_per_s", **{"pass": "1"}) or 0.0
            p2 = merged.value("dwpa_client_pmk_per_s", **{"pass": "2"}) or 0.0
            self.log(
                f"slice PMK/s: pass1={p1:.0f} pass2={p2:.0f} "
                f"(summed over {process_count()} processes)")
