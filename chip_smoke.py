#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path — one m22000 work unit cracked end to end —
through the entry points a user calls, and holds the PBKDF2 kernel (K1)
and the verify kernels (K3) to their plain torch versions and to
hashlib.  Phases, each printed as it ends:

1. device and build: the card's name and power limit (``nvidia-smi``),
   then the three kernel libraries built from ``dwpa_tpu_torch/csrc``
   (K1, K2, K3; one ``nvcc`` each, in parallel), K1's loop split by pipe
   (``ops/sass.py`` ``pipe_split``) with the ALU pipe's and the issue
   rate's least time for a batch, and K3's SASS loops;
2. the kernel against the plain version on the card at 2 and 4096
   iterations (every row width, both salt ranks, a ragged batch), and
   against ``hashlib.pbkdf2_hmac`` at 4096; equality is exact;
3. the known-PSK challenge gate;
4. the work unit at full size: one ESSID group of five nets (keyver 2,
   PMKID, keyver 2 that needs a nonce correction, keyver 1, keyver 3),
   a seeded 1,048,576-word dictionary in 131072-word batches, the PSK
   planted in the last batch.  Every net must be found with the right
   PSK, NC delta, endian and PMK, through K1 and K3 only (no plain
   PBKDF2, no plain verify); the breakdown times K3 per verify part on
   the device alone (``kernel_ms``), beside a single call with its host
   issue and the plain verify on the same PMKs; then K1 timed per launch
   at 2,048 to 131,072 rows;
5. the SM probe (K2): its kernel against the plain version for all four
   mixes at 1 and 2 iterations, at full width and at a ragged width
   (exact), then its measurement path (``sm_probe.run``): the four mixes
   at full width, the resident-threads sweep, the PMK/s ceiling, and from
   the ``sha1_round`` rate K1's measured bound beside its issue-rate one;
6. the volunteer loop: ``TpuCrackClient.run()`` against an in-process
   stub server that issues phase 4's unit (its five nets, and a gzip of
   its dictionary as the unit's one dict) and re-checks every submitted
   PSK with the oracle — challenge, prewarm, get_work, md5-checked
   download, pass 1, pass 2 through the candidate feed and the CUDA-stream
   stager, put_work.  All five nets must be found and accepted, through
   K1 only, with the native packer and the feed's producer thread packing
   pass 2.  Then a crash after the 4th pass-2 checkpoint and a fresh
   client's replay of the unit from the resume file, and the unit again
   with an inline feed (``feed_workers=0``);
7. the rules path: (a) every rule of the bundled ``wpa.rule`` expands a
   seeded 131072-word base batch (1-63 bytes, bytes >= 128 included) on
   the card exactly as on the CPU and as the host interpreter does on 4096
   sampled rows; (b) the engine's ``crack_rules_blocks`` on the JAX
   bench's ``rules_device`` configuration (one PMKID net, 8 rules, 6 x
   131072 base words), the planted PSK found through K1 only, and K1 held
   to the plain version on an expanded 16-column batch; (c) the volunteer
   loop on a rules unit (phase 6's five nets, each with its own PSK made
   by a different rule, a 262,144-word dict and the first 16 rules of
   ``wpa.rule``, plus a 65,536-word ``cracked.txt.gz`` that pass 1
   expands through those rules on the host), accepted, then a crash after
   the first pass-2 block and a fresh client's exact replay; the first
   run expands pass 1 in process and the crashing one on a pool of
   ``RULE_WORKERS`` processes, and both expansions are also timed alone;
8. the mask path: (a) ``device_mask_words`` on the card exactly as on the
   CPU and as the host words + pack, at 131072 rows, for six masks (the
   ?d x 8 keyspace end, a start beyond 2**32, bytes 0 and >= 128, 63
   positions), and its time; (b) ``crack_mask`` on the JAX bench's config
   #5 (one PMKID net, ?d x 8, 8 x 131072, all miss) through K1 only, with
   no candidate upload and no native pack, K1 held to the plain version
   on a generated batch, then five nets with PSKs planted in one slice;
   (c) ``TpuCrackClient.run()`` on a pure-mask unit (two ?d x 8 shards
   holding the PSKs of five nets of phase 6's kinds), accepted, then a
   crash after the first mask checkpoint and a fresh client's replay of
   exactly ``limit - mask_done`` candidates;
9. the PMK store: (a) the JAX bench's ``pmkstore`` configuration (one
   PMKID net, 4 x 131072 words, a warm dictionary sharing 7/8 of the cold
   one), cold and warm, with K1's launches and rows, hit ratios, the
   producer's split and the consumer's write-back per batch, and written
   PMKs held to hashlib; (b) phase 6's unit through ``run()`` with a PMK
   store, cold then warm (no K1 in the warm pass 2); (c) a poisoned-store
   control: one net's PSK carries a zero PMK, and both runs miss exactly
   that net;
10. mixed-ESSID unit fusion: (a) ``fused_pmk_step`` on one 131072-lane
   batch of 8 units x 16,000 words against the plain version at 2
   iterations and hashlib at 4096 on 64 lanes; (b) the JAX bench's
   ``small_units`` configuration (8 PMKID units x 1000 words), one engine
   per unit through ``crack`` against one engine through ``crack_fused``:
   the same founds, 8 K1 launches against 1; (c) 32 units of 16,000 words
   (phase 6's five kinds in turn, two units sharing an ESSID) through the
   client's ``fused_executor`` (``MultiUnitExecutor``, unit_queue 4,
   fuse_max_units 8): every PSK found, one K1 launch per fused batch;
   (d) that stream through a fresh PMK store cold, fully warm (no K1) and
   half warm (``mix_step``), the store's sampled records held to hashlib.
11. the packed-dictionary cache: (a) the JAX bench's ``dict_cache`` feed
   legs (a 200,000-word gz dict through ``DictFeedSource`` and a
   two-producer ``CandidateFeed``, cold then warm: words/s, the cache's
   bytes, the warm words equal to the cold ones word for word); (b) its
   e2e legs (one PMKID net, 2 x 131072 words with the PSK in the last
   batch, through ``crack_blocks`` and ``host_packer()``, cold then warm:
   the same founds, per-batch counts and K1 launches; a mid-stream resume
   skip accounted alike, the warm one with no gunzip; K1 exact against the
   plain version at 2 iterations on a batch materialized from the cache);
   (c) phase 6's unit through ``run()`` with ``dict_cache_dir``, cold then
   warm (hit blocks only, no ``DictStream`` in pass 2, the cold run's
   resume stamps), then a warm run crashed after the 4th pass-2
   checkpoint and a fresh client's replay by an index seek; (d) phase 7c's
   rules unit, its dict cut to one block and without the pass-1 cracked
   dict, cold then warm from ``.rbase`` (the same finds, ``rules:expand``
   timed in both).
12. the server (``dwpa_tpu_torch.server``): (a) its ``PmkBatcher`` on
   ``cuda:0`` over 8 ESSIDs x 1000 words (lengths 8-63, repeats and
   out-of-range words mixed in), one K1 launch per wave, sampled PMKs
   equal to hashlib; a set at each fused width (256, 1024, 2048 lanes);
   two threads deriving at once; ``verify_batch`` on the card equal to
   the host path over PMKID, keyver 1/2/3 and NC items; K1's time per
   pre-crack launch; (b) ``jobs.precrack`` at the server's defaults
   (limit 100, batch 2048, dict limit 64) on a database of 1,000 nets
   (900 processed, 200 of them cracked; 100 fresh with hits planted
   through every source), on the card and on the host from copies of
   it: equal ``nets`` / ``rkg`` rows, the planted nets cracked, the
   sweep's seconds split into collect, derive and demux; the card leg
   again at batch 131072; (c) the port's WSGI server on 127.0.0.1 with
   the ingest pre-crack on the card and the cron layer's pre-crack on a
   second thread, a capture POSTed, and ``TpuCrackClient.run()`` on
   ``cuda:0`` cracking its nets over HTTP from a 131072-word dict: the
   unit accepted, the PSKs re-verified by ``put_work``, the lease
   released.
13. the server's other paths: (a) the Thomson serial sweep on the card
   over the full default space (years 4-12, weeks 1-53: 22,254,768
   serials) through ``thomson_candidates`` with no device named, at
   chunks 2**20 and 2**22, the planted key found, one year equal to the
   hashlib search list for list, and ``vendor_candidates`` sweeping by
   default; (b) ``jobs.precrack`` at the server's defaults on a fresh
   database of Thomson-shaped and plain nets, exactly the nets whose PSK
   is a planted Thomson key cracked through K1; (c) the chaos soak:
   phase 6's unit (a 131072-word dict) cracked by ``TpuCrackClient.run()``
   on the card against the port's server through ``ChaosTransport`` on
   a virtual clock, fault-free and under a seeded schedule (timeouts,
   5xx, a torn put_work reply, a reject), with the same founds, rows
   and resume state; (d) the operator tools through the server CLI on
   phase 12's 1,000-net database: ``recrack``, ``pack-dict``,
   ``dedup-dicts``, ``fill-pr --native`` (the native capture parser held
   to the Python one on the capture corpus), ``pack-client`` twice (the
   same md5) and the client's ``check_update`` accepting it.
14. streams, builds and slices: (a) ``crack_streams`` on phase 4's unit
   with two streams on ``cuda:0`` (each its own thread, CUDA stream and
   engine) against ``crack_blocks`` on the same blocks: the same founds
   (PSK, NC, endian, PMK) as phase 4 and the same ``on_batch`` sequence,
   through K1 only, PMK/s beside phase 4's; then a crash leg, one stream's
   engine raising on its third block, that block requeued to the other
   stream and the founds unchanged; (b) ``crack_rules_streams`` on 7b's
   ``rules_device`` configuration with two streams, 7b's founds; (c) a
   second ``run()`` of phase 6's unit counting no build in
   ``dwpa_client_recompiles_total``, and ``watch_compiles`` over a fresh
   build directory counting one build per library (K1, K2, K3, the two
   native libraries); (d) a two-process slice, ``python -m
   dwpa_tpu_torch.client --coordinator 127.0.0.1:<port> --num-processes 2
   --process-id {0,1} --device cuda:0``, against the port's WSGI server on
   127.0.0.1 with phase 6's five nets and a 131072-word dict: one
   ``get_work``, one ``put_work``, every net cracked once, each process's
   pass-2 K1 launch covering its half of the dict, and rank 0 alone
   reporting the slice's PMK/s.
15. K3 against its plain version on the card at phase 4's width with a
   ragged tail (B = 131069): thirteen nets, each with its own PSK planted
   (hashlib PMKs among random ones) — PMKID, keyver 1 and keyver 2 (three
   nets each, parts bucket-padded to four rows), keyver 3 at F = 7 with a
   padded and with a complete last CMAC block, at F = 15 complete and at F
   = 16 padded; the AP nonce at offsets 0 and 32 of the PRF's nonce pair
   for each keyver, LE corrections at 0 changing keyver 1/2's PRF block 0
   — with hits in non-zero NC variants of both endians and at column
   B - 1; every part's and every single net's found matrix bit for bit
   equal to the plain version on the card, the step's equal to the CPU
   plain version on sampled columns, and a CMAC with no full block (F = 0)
   both ways; every part's time beside its bounds, and cmac's time at F =
   0, 7 and 15 (V = 21): its slope per AES block beside the block's table
   loads at shared memory's rate, its intercept the SHA-256 side.
   Then pmkid's net sweep: parts of 1, 2, 7 (bucket-padded to 8) and 32
   PMKID nets as a crack step builds them, each exact against the plain
   version on the card and on sampled columns on the CPU, timed: the
   slope a net and the intercept beside the census's; then small batches
   (B = 2048 at 1 and 32 nets, B = 16384 at 32), where the kernel splits
   the nets over the grid, each timed beside the same part with all its
   nets a thread.
   15b: K3's weight in a large ESSID group: one 32-net keyver 2 part, one
   8-net keyver 3 part and one 32-net PMKID part at B = 131072, timed
   beside K1's batch and held to the plain version on 4096 columns.

Every K3 part time is a device time alone (``kernel_ms``: 20 launches
queued behind a sleep between one pair of CUDA events, median of 5 runs;
a run whose sleep ends before the launches are enqueued is discarded and
the sleep doubled, and the smoke fails after 5 such runs); phase 4
prints a single call's time, host issue included, beside each;
``step.verify``'s time in phase 4 is a path time, host issue included.

From phase 6 on, every phase that verifies counts K3's launches (by
entry) and holds the plain verify at 0 calls; K3's ``launches_by_path``
are these counts, every run of a phase included.

It then prints K3's bounds per verify part of phase 4 (the instructions
its function needs, ``ops/opcount.py`` ``verify_census``, at the issue
rate and at the ``sha1_round`` probe's rate, keyver 3's AES table loads
at shared memory's rate, its bytes at the HBM rate; K3's own SASS beside
them; a part faster than its census at the issue rate fails the run),
the kernel records as one JSON line (K1, K2 and K3's three entries) and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
nonzero and the ``ok`` line is not printed.  Without a CUDA device it
exits nonzero before doing anything.
"""

import base64
import collections
import gzip
import hashlib
import json
import re
import shutil
import statistics
import struct
import sys
import threading
import time
import urllib.parse
import zlib
from pathlib import Path

import numpy as np

SEED = 20261016
UNIT_WORDS = 1 << 20
UNIT_BATCH = 131072
PSK = b"h100-slice-psk"
ESSID = b"dwpa-torch-slice"
PLANT_AT = UNIT_WORDS - 77777          # inside the last batch
KERNEL_SOURCE = "dwpa_tpu_torch/csrc/pbkdf2_sha1.cu"
REPLACES = "dwpa_tpu/ops/pbkdf2_pallas.py:88"
PROBE_SOURCE = "dwpa_tpu_torch/csrc/sm_probe.cu"
PROBE_REPLACES = "dwpa_tpu/ops/vpu_probe.py:94"
PROBE_RAGGED = 1037          # not a multiple of the 128-thread block
VERIFY_SOURCE = "dwpa_tpu_torch/csrc/verify.cu"
#: K3's entries and what each replaces: the JAX match function that XLA
#: compiles into verify_step (there is no Pallas kernel).
K3_ENTRIES = {
    "pmkid": "dwpa_tpu/models/m22000.py:272",
    "eapol": "dwpa_tpu/models/m22000.py:285",
    "cmac": "dwpa_tpu/models/m22000.py:316",
}
K3_PARTS = [("pmkid", ()), ("eapol", (1,)), ("eapol", (2,)), ("cmac", (False,))]
K3_B = UNIT_BATCH - 3                  # 15: a ragged width at phase 4's scale
K3_SAMPLE = 512                        # 15: columns held to the CPU plain version
K3_SPLIT_F = (0, 7, 15)                # 15: cmac timed at these F (V = 21)
K3_REPS = 20                           # kernel_ms: launches between one pair of events
K3_RUNS = 5                            # kernel_ms: runs a median takes
K3_SPLIT_RUNS = 9                      # 15: runs a median of the F sweep takes
SLEEP_HZ = 2.0e9                       # kernel_ms: sleep cycles a second (above the max SM clock)
SLEEP_MARGIN_S = 0.02                  # kernel_ms: sleep beyond 4x the host's issue time
SLEEP_RETRIES = 5                      # kernel_ms: runs discarded (sleep doubled) before failing
K3_WIDE = {"eapol": 32, "cmac": 8, "pmkid": 32}   # 15b: nets in one large ESSID group's part
K3_PMKID_NETS = (1, 2, 7, 32)          # 15: pmkid's net sweep (7 bucket-padded to 8)
K3_PMKID_SMALL = ((2048, 1), (2048, 32), (16384, 32))   # 15: pmkid's small batches (B, nets)
K3_WIDE_CHECK = 4096                   # 15b: columns held to the plain version
SMEM_LANES_PER_SM_CLOCK = 32           # shared memory: one warp's 32 lanes a clock an SM
ALU_LANES = 64                         # the ALU pipe: 4 x 16 lanes a clock an SM
K1_SWEEP = (2048, 16384, 65536, 131072)   # 4: K1's widths timed per launch
K1_TRIPS = 2 * 4095                    # K1's loop trips a PMK: half an HMAC iteration a trip
HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3 (NVIDIA data sheet)
STUB_URL = "http://stub/"
STUB_DICT = "dict/phase4.txt.gz"
STUB_CRACKED = "dict/cracked.txt.gz"
STUB_HKEY = "chip-smoke-unit"
CLIENT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
EXPAND_SAMPLE = 4096                   # host-interpreter rows checked per rule
RULES_DEVICE = [":", "u", "c", "$1", "^w", "t", "T0", "$1 $2 $3"]   # bench.py:191
RULES_FLUSHES = 6
RULES_UNIT_WORDS = 2 * UNIT_BATCH
RULES_UNIT_RULES = 16                  # the first rules of wpa.rule
RULES_CRACKED_WORDS = 1 << 16          # pass 1: 16 rules -> 8 full batches
RULE_WORKERS = 4                       # the pooled pass-1 leg (8-core host)
MASK_CASES = [                          # 8a: (mask, custom, start)
    ("?d" * 8, None, 0),
    ("?d" * 8, None, 99_999_980),       # the keyspace end
    ("ab?l?d", None, 7),
    ("?d" * 10, None, 9_999_999_000),   # a start beyond 2**32
    ("?1?b?1?b?d?d", {"1": b"\x00\x7f\x80\xff"}, 123_456_789),   # bytes 0 and >= 128
    ("?l?u" * 31 + "?d", None, 10 ** 85 + 12_345),                 # 63 positions
]
MASK_BENCH_BATCHES = 8                  # bench.py:93 config #5: ?d x 8, 8 x 131072
MASK_NET_PSKS = [b"31415926", b"31425926", b"31435926", b"31445926", b"31455926"]
MASK_SHARDS = [{"mask": "?d" * 8, "custom": {}, "skip": 50_000_000, "limit": 2 * UNIT_BATCH},
               {"mask": "?d" * 8, "custom": {}, "skip": 70_000_000, "limit": 2 * UNIT_BATCH}]
MASK_UNIT_PSKS = [b"50100000", b"50200000", b"70000500", b"70150000", b"50250000"]
STORE_BATCHES = 4                       # bench.py:320 pmkstore: 4 x 131072, overlap 7/8
STORE_PERIOD = 8
STORE_SAMPLE = 256                      # written PMKs held to hashlib per pass
POISON_WORDS = 2 * UNIT_BATCH
FUSED_UNITS = 8                         # 10a: 8 units x 16,000 words in one 131072-lane batch
FUSED_WORDS = 16_000
FUSED_SAMPLE = 8                        # 10a: lanes per unit held to hashlib at 4096
SMALL_UNITS = 8                         # 10b: bench.py:502 small_units, 8 x 1000 words
SMALL_WORDS = 1000
STREAM_UNITS = 32                       # 10c/10d: the executor's stream
UNIT_QUEUE = 4
FUSE_MAX_UNITS = 8
STREAM_SAMPLE = 64                      # 10d: store records held to hashlib per run
DCACHE_FEED_WORDS = 200_000             # 11a: bench.py:398 dict_cache, the feed-only legs
DCACHE_E2E_BATCHES = 2                  # 11b: bench.py:447, the e2e legs at 2 x 131072
DCACHE_RESUME = UNIT_BATCH + 12345      # 11b: a mid-stream resume skip
RBASE_UNIT_WORDS = UNIT_BATCH           # 11d: 7c's base dict cut to one block for time
PRECRACK_ESSIDS = 8                     # 12a: 8 ESSIDs x 1000 words, lengths 8-63
PRECRACK_ESSID_WORDS = 1000
PRECRACK_SAMPLE = 512                   # 12a/12b: derived PMKs held to hashlib
PRECRACK_BATCH = 2048                   # 12b: the server's defaults (server/__main__.py)
PRECRACK_LIMIT = 100
PRECRACK_DICT_LIMIT = 64
PRECRACK_PROCESSED = 900                # 12b: 1,000 nets, 900 processed, 200 of them cracked
PRECRACK_CRACKED = 200
PRECRACK_CORPUS_PSKS = 80
PRECRACK_UNPROCESSED = 100
SERVER_CRON_NETS = 24                   # 12c: nets the cron thread's pre-crack cracks
SERVER_DICT_WORDS = UNIT_BATCH          # 12c: the unit's dict, 131072 words
SERVER_PSK = b"h100-server-psk"
SERVER_ESSID = b"dwpa-torch-server"
THOMSON_SERIAL = (10, 37, "7QX")        # 13a: the planted serial (yy, ww, code)
THOMSON_YEARS = range(4, 13)            # the default space: 9 x 53 x 36**3 serials
THOMSON_WEEKS = range(1, 54)
THOMSON_CHUNKS = (1 << 20, 1 << 22)
THOMSON_NETS = [(b"SpeedTouch", (6, 14, "A1B")), (b"Orange-", (9, 40, "Z9Z")),
                (b"Thomson", (12, 53, "000")), (b"BigPond", None), (b"SpeedTouch", None)]
THOMSON_PLAIN_NETS = 8                  # 13b: nets that are no vendor's
CHAOS_DICT_WORDS = UNIT_BATCH           # 13c: phase 6's five nets, one 131072-word dict
CHAOS_RATE = 0.3
CHAOS_KINDS = ("drop", "timeout", "http_5xx", "slow")
TOOLS_CAPTURES = 100                    # 13d: archived captures for fill-pr
TOOLS_DICT_WORDS = UNIT_BATCH
TOOLS_CLIENT_VERSION = "999.0.1"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs, timed with CUDA events
    around one call: a path time, the host's issue of the call included."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, runs=K3_RUNS, reps=K3_REPS):
    """Device ms of one ``fn()`` (a kernel launch and what the host does to
    issue it), without the host: the median over ``runs`` of ``reps``
    launches between one pair of CUDA events, all enqueued behind
    ``torch.cuda._sleep`` so the device runs them back to back.  The sleep
    is sized from the host's time to issue ``reps`` calls.  An event
    recorded after it must still be pending when the last launch is
    enqueued; a run where it is not (the host stalled, as on a GIL switch)
    is discarded and the sleep doubled, and the run fails after
    ``SLEEP_RETRIES`` such runs: a figure with host time in it is never
    returned."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int((4 * issue_s + SLEEP_MARGIN_S) * SLEEP_HZ)
    times, retries = [], 0
    while len(times) < runs:
        fence = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        fence.record()
        start.record()
        for _ in range(reps):
            fn()
        asleep = not fence.query()
        end.record()
        end.synchronize()
        if asleep:
            times.append(start.elapsed_time(end) / reps)
            continue
        retries += 1
        check(retries <= SLEEP_RETRIES,
              f"kernel_ms: the sleep ended before {reps} launches were enqueued in "
              f"{retries} runs, the last of {cycles} cycles ({issue_s * 1e3:.3f} host ms to "
              f"issue them when timed alone)")
        cycles *= 2
    return statistics.median(times)


def random_words(rng, n, lo, hi):
    """``n`` seeded words of ``lo..hi`` bytes from [a-z0-9]."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    lens = rng.integers(lo, hi + 1, n)
    buf = alphabet[rng.integers(0, len(alphabet), (n, hi))].tobytes()
    return [buf[i * hi: i * hi + int(lens[i])] for i in range(n)]


def phase_kernel(dev, rng, card):
    """Phase 2: the kernel against the plain version and hashlib."""
    import torch

    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops import pbkdf2
    from dwpa_tpu_torch.ops.common import to_numpy, to_torch
    from dwpa_tpu_torch.ops.pbkdf2_cuda import pbkdf2_sha1_pmk_cuda
    from dwpa_tpu_torch.utils import bytesops as bo

    n = 333  # not a multiple of the 128-thread block
    err = 0
    cases = []
    for w in (4, 8, 16):
        words = random_words(rng, n, 8, min(4 * w, 63))
        rows = to_torch(bo.pack_passwords_be(words)[:, :w], dev)
        for rank in (1, 2):
            if rank == 1:
                s1, s2 = (to_torch(s, dev) for s in m.essid_salt_blocks(ESSID))
            else:
                essids = [b"net-%d" % i for i in rng.integers(0, 50, n)]
                s1, s2 = (to_torch(s, dev) for s in m.essid_salt_lanes(essids))
            cases.append((w, rank, rows, s1, s2))
    for w, rank, rows, s1, s2 in cases:
        got = pbkdf2_sha1_pmk_cuda(rows, s1, s2, iterations=2)
        ref = pbkdf2.pbkdf2_sha1_pmk(rows, s1, s2, iterations=2)
        err = max(err, int((got.long() - ref.long()).abs().max()))
        check(torch.equal(got, ref), f"kernel != plain at 2 iterations, W={w} rank={rank}")
    # 4096 iterations: the plain version is launch-bound (one torch op per
    # word operation), so every case rides one plain call — rows padded
    # to 16 words and salts expanded per lane, which is the same function.
    got = [pbkdf2_sha1_pmk_cuda(rows, s1, s2) for _, _, rows, s1, s2 in cases]
    rows16 = torch.cat([torch.nn.functional.pad(r, (0, 16 - r.shape[1])) for _, _, r, _, _ in cases])
    lanes = [tuple(s.expand(n, 16) for s in (s1, s2)) for _, _, _, s1, s2 in cases]
    ref = pbkdf2.pbkdf2_sha1_pmk(rows16, torch.cat([a for a, _ in lanes]).contiguous(),
                                 torch.cat([b for _, b in lanes]).contiguous())
    for i, (w, rank, *_) in enumerate(cases):
        part = ref[:, i * n:(i + 1) * n]
        err = max(err, int((got[i].long() - part.long()).abs().max()))
        check(torch.equal(got[i], part), f"kernel != plain at 4096 iterations, W={w} rank={rank}")
    words = [b"longpassphrase-%04d" % i for i in range(64)]
    out = to_numpy(pbkdf2_sha1_pmk_cuda(
        to_torch(bo.pack_passwords_be(words)[:, :8], dev),
        *(to_torch(s, dev) for s in m.essid_salt_blocks(ESSID))))
    for i, word in enumerate(words):
        check(bo.words_to_bytes_be(out[:, i]) == hashlib.pbkdf2_hmac("sha1", word, ESSID, 4096, 32),
              f"kernel != hashlib for {word!r}")
    print(f"phase 2 kernel: exact vs plain at 2 and 4096 iterations (W 4/8/16, salt rank 1/2, "
          f"B={n}) and vs hashlib (64 words); max_abs_err={err} [{card}]", flush=True)
    return err


def kind_line(k, psk, essid, tag):
    """Net ``k`` (0-4) of the five kinds below, as (line, (NC delta, endian))."""
    from dwpa_tpu_torch import testing as tfx

    if k == 1:
        return tfx.make_pmkid_line(psk, essid, seed=f"{tag}-pmk"), (0, "")
    keyver, nc, endian, name = [(2, 0, "", "k2a"), None, (2, -2, "BE", "k2b"),
                                (1, 0, "", "k1"), (3, 0, "", "k3")][k]
    kw = dict(nc_delta=nc, endian=endian) if nc else {}
    return tfx.make_eapol_line(psk, essid, keyver=keyver, seed=f"{tag}-{name}", **kw), (nc, endian)


def five_kind_lines(psks, tag, essid=ESSID):
    """The mixed, permuted kinds of the JAX package's multi-chip dry run,
    each net with its own PSK, as (line, (NC delta, endian)): keyver 2,
    PMKID, keyver 2 that only cracks with a nonce correction, keyver 1,
    keyver 3."""
    return [kind_line(k, psks[k], essid, tag) for k in range(5)]


def unit_lines():
    return five_kind_lines([PSK] * 5, "u")


def verify_parts(step, nets):
    """The verify parts of a crack step, in ``step.parts`` order, as
    ``(kind, static, real net count, stacked constants without the mask)``."""
    from dwpa_tpu_torch.parallel.step import _partition

    return [(kind, static, len(idxs), consts[1:])
            for ((kind, static, _), idxs), (_, consts) in zip(_partition(nets).items(),
                                                               step.parts)]


def kernel_match(kind, static, pmk, consts):
    """One verify part's match on ``pmk``'s device: K3 on the card."""
    from dwpa_tpu_torch.parallel.step import _KINDS

    return _KINDS[kind][2](pmk, static, *consts)


def k3_function(kind, static):
    """The SASS name of the K3 kernel that runs a verify part."""
    if kind == "eapol":
        return f"verify_eapol_kernelILi{static[0]}E"   # the keyver template
    return f"verify_{kind}_kernel"


def part_label(kind, static, n):
    return f"{kind}{list(static)} x{n}"


def part_shape(kind, consts):
    """(V, rows) of a verify part's stacked constants: its variants and its
    EAPOL or full CMAC blocks (1 and 0 for pmkid)."""
    return (1, 0) if kind == "pmkid" else (consts[0].shape[1], consts[1].shape[1])


def block0_runs(kind, consts):
    """The distinct PRF blocks 0 a keyver 1/2 part's kernel compresses per
    column, summed over its nets: the run starts of its derived variant
    order (``ops/verify_prep``).  None for other kinds."""
    from dwpa_tpu_torch.ops.verify_prep import NEW_BLOCK0

    if kind != "eapol":
        return None
    return int(((consts[3] & NEW_BLOCK0) != 0).sum())


def k3_trips(kind, n, v, rows, runs):
    """One K3 thread's loop trips for ``ops/sass.dynamic_count``, outermost
    first: eapol's runs of variants that share PRF block 0 (``runs`` over
    ``n`` nets, so a thread's mean), the run's variants, the E EAPOL
    blocks; cmac's variants and its F + 2 AES blocks; pmkid's ``n`` nets
    (a pmkid thread takes a column and its group's nets, the others a
    (net, column))."""
    if kind == "pmkid":
        return [n]
    if kind == "eapol":
        return [runs / n, v * n / runs, rows]
    return [v, rows + 2]


def phase_unit(dev, rng, card):
    """Phase 4: the work unit at full size, then a per-stage breakdown.
    Returns, beside K1's numbers, K3's launches by entry and its parts
    at this batch's shapes (``kind, static, N, V, rows, ms, plain_ms``)."""
    import torch

    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda, verify, verify_cuda, verify_prep
    from dwpa_tpu_torch.testing import plain_part

    lines = unit_lines()
    words = random_words(rng, UNIT_WORDS, 8, 20)
    words[PLANT_AT] = PSK
    eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    verify_cuda.LAUNCHES.clear()
    verify.CALLS = 0
    verify_prep.BUILDS, verify_prep.BUILD_SECONDS = 0, 0.0
    t0 = time.perf_counter()
    unit_founds = founds = eng.crack(words)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    k3_launches, verify_calls = dict(verify_cuda.LAUNCHES), verify.CALLS
    prep_builds, prep_s = verify_prep.BUILDS, verify_prep.BUILD_SECONDS
    check(launches > 0, "the unit never launched the PBKDF2 kernel")
    check(plain_calls == 0, f"the unit ran the plain PBKDF2 {plain_calls} times")
    check(set(k3_launches) == set(K3_ENTRIES) and min(k3_launches.values()) > 0,
          f"the unit's K3 launches {k3_launches}")
    check(verify_calls == 0, f"the unit ran the plain verify {verify_calls} times")
    pmk = hashlib.pbkdf2_hmac("sha1", PSK, ESSID, 4096, 32)
    by_line = {f.line.raw: f for f in founds}
    check(len(founds) == len(lines), f"{len(founds)}/{len(lines)} nets cracked")
    for raw, (nc, endian) in lines:
        f = by_line.get(raw)
        check(f is not None, f"net not cracked: {raw[:40]}")
        check((f.psk, f.nc, f.endian, f.pmk) == (PSK, nc, endian, pmk),
              f"wrong find for keyver {f.line.keyver}: {(f.psk, f.nc, f.endian)}")
    unit_pmk_s = UNIT_WORDS / wall
    print(f"phase 4 unit: {len(founds)}/5 nets cracked, {UNIT_WORDS} words in {wall:.3f} s = "
          f"{UNIT_WORDS / wall:.1f} PMK/s; kernel launches {launches}, plain PBKDF2 calls "
          f"{plain_calls}; K3 launches {k3_launches}, plain verify calls {verify_calls}, K3's "
          f"derived constants built {prep_builds} times in {prep_s:.4f} host s (at step build, "
          f"in dispatch); stage host seconds {eng.stage_times} [{card}]", flush=True)

    # Breakdown on one full batch of the same dictionary (a fresh engine).
    eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev)
    essid = next(iter(eng.groups))
    step = eng._step_for(essid)
    prep = eng._prepare(words[:UNIT_BATCH])
    pw = prep[2]
    k1_ms = cuda_ms(lambda: step.compute_pmk(pw), 5)
    pmk_dev = step.compute_pmk(pw)
    verify_ms = cuda_ms(lambda: step.verify(pmk_dev), 5)
    parts, k3_parts = [], []
    unit_parts = verify_parts(step, eng._full[essid])
    check(prep_builds == len(unit_parts),
          f"phase 4: K3's derived constants built {prep_builds} times for {len(unit_parts)} "
          f"parts: once per part, when the step is built")
    for kind, static, n, consts in unit_parts:
        ms = kernel_ms(lambda: kernel_match(kind, static, pmk_dev, consts))
        call_ms = cuda_ms(lambda: kernel_match(kind, static, pmk_dev, consts), 5)
        plain_ms = cuda_ms(lambda: plain_part(kind, static, pmk_dev, consts), 3)
        check(torch.equal(kernel_match(kind, static, pmk_dev, consts),
                          plain_part(kind, static, pmk_dev, consts)),
              f"phase 4: K3 != plain on {part_label(kind, static, n)}")
        v, rows = part_shape(kind, consts)
        runs = block0_runs(kind, consts)
        k3_parts.append((kind, static, consts[0].shape[0], v, rows, runs, ms, plain_ms, call_ms))
        parts.append(f"{part_label(kind, static, n)} (bucket {consts[0].shape[0]}, V {v}"
                     f"{'' if runs is None else f', {runs} distinct PRF blocks 0'}) K3 "
                     f"{ms:.3f} ms on the device ({call_ms:.3f} ms a single call with host "
                     f"issue), plain {plain_ms:.3f} ms")
    dispatched = eng._dispatch(prep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._collect(dispatched)
    gate_ms = (time.perf_counter() - t0) * 1e3
    hit = eng._dispatch(eng._prepare(words[UNIT_WORDS - UNIT_BATCH:]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng._collect(hit)
    decode_ms = (time.perf_counter() - t0) * 1e3
    check(len(got) == len(lines), "breakdown hit batch did not decode every net")
    print(f"phase 4 breakdown per {UNIT_BATCH}-row batch (W={pw.shape[1]}): kernel {k1_ms:.3f} ms "
          f"(median of 5, CUDA events), step.verify {verify_ms:.3f} ms (a path time, host "
          f"issue included: median of 5 single calls, 5 nets; parts, K3 on the device alone "
          f"(median of {K3_RUNS} runs of {K3_REPS} launches queued behind a sleep), a single "
          f"K3 call (median of 5) and plain (median of 3) on the same PMKs: {'; '.join(parts)}), "
          f"gate {gate_ms:.3f} ms (no-hit batch), decode {decode_ms:.3f} ms (hit batch, "
          f"oracle re-check of 5 nets) [{card}]", flush=True)
    sweep = phase_k1_widths(pw, step.salt1, step.salt2, card)
    return (launches, k1_ms, pw, step, words, unit_pmk_s, unit_founds, k3_launches,
            k3_parts, verify_ms, sweep)


def phase_k1_widths(pw, salt1, salt2, card):
    """Phase 4, K1 by width: ms per launch at each width of ``K1_SWEEP``
    (the first rows of ``pw``, the phase's batch, on its salts)."""
    from dwpa_tpu_torch.ops import pbkdf2_cuda

    sweep = {}
    for n in K1_SWEEP:
        rows = pw[:n].contiguous()
        sweep[n] = cuda_ms(lambda: pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(rows, salt1, salt2), 5)
    print("phase 4 K1 by width: ms per launch (median of 5, CUDA events) "
          + "; ".join(f"{n} rows {ms:.3f}" for n, ms in sweep.items()) + f" [{card}]",
          flush=True)
    return sweep


def phase_probe(dev, rng, card):
    """Phase 5: the SM probe kernel against its plain version, then its
    measurement path.  Returns the measurement and the K2 record's
    comparison numbers."""
    import torch

    from dwpa_tpu_torch.ops import sm_probe
    from dwpa_tpu_torch.ops.common import to_torch

    full = torch.cuda.get_device_properties(0).multi_processor_count * sm_probe.MAX_THREADS_PER_SM
    xs = {n: to_torch(rng.integers(0, 2**32, (5, n), dtype=np.uint64).astype(np.uint32), dev)
          for n in (full, PROBE_RAGGED)}
    err = 0
    for n, x in xs.items():
        for mix in sm_probe.MIXES:
            for iters in (1, 2):
                got = sm_probe.probe_cuda(x, mix, iters)
                ref = sm_probe.probe_plain(x, mix, iters)
                err = max(err, int((got.long() - ref.long()).abs().max()))
                check(torch.equal(got, ref), f"probe kernel != plain: {mix}, N={n}, iters={iters}")
    plain_ms = cuda_ms(lambda: sm_probe.probe_plain(xs[full], "sha1_round", 2), 3)
    print(f"phase 5 probe kernel: exact vs plain for {len(sm_probe.MIXES)} mixes at 1 and 2 "
          f"iterations, N={full} and N={PROBE_RAGGED}; max_abs_err={err}; plain sha1_round at "
          f"2 iterations on int32[5, {full}]: {plain_ms:.3f} ms (median of 3, CUDA events) "
          f"[{card}]", flush=True)

    sm_probe.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sm_probe.run()
    wall = time.perf_counter() - t0
    launches = sm_probe.LAUNCHES
    check(launches > 0, "the probe path never launched the probe kernel")
    print(f"phase 5 probe: {wall:.1f} s, {launches} launches; SM clock before {res['sm_clock_before']},"
          f" after {res['sm_clock_after']}, max {res['max_sm_clock']} [{card}]", flush=True)
    sweep = [("full width", r) for r in res["mixes"].values()]
    sweep += [(f"{t} threads/SM", r) for t, r in res["sha1_round_threads_per_sm"].items()]
    for label, r in sweep:
        print(f"phase 5 probe {r['mix']} ({label}): {r['tera_ops_per_s']:.4f} logical Tops/s, "
              f"{r['sass_per_step']:.4f} SASS per step{' (FOLDED)' if r['folded'] else ''}, "
              f"{r['thread_inst_per_sm_clock']:.3f} thread-instructions per SM per max clock; "
              f"t1 {r['seconds_1x']:.6f} s, t3 {r['seconds_3x']:.6f} s, SM clock during t3 "
              f"{r['sm_clock_during_3x']} [{card}]", flush=True)
        check(r["thread_inst_per_sm_clock"] <= 1.05 * sm_probe.ISSUE_PER_SM_CLOCK,
              f"{r['mix']} reads above {sm_probe.ISSUE_PER_SM_CLOCK} thread-instructions per SM "
              "per clock: the timing window or the count is wrong")
    check(not res["mixes"]["sha1_round"]["folded"], "the sha1_round loop was folded")
    print(f"phase 5 probe loop opcodes per {sm_probe.UNROLL}-step iteration: "
          f"{res['loop_opcodes']}", flush=True)
    print(f"phase 5 ceiling: {res['ceiling_pmk_per_s']:.1f} PMK/s = sha1_round "
          f"{res['mixes']['sha1_round']['tera_ops_per_s']:.4f} logical Tops/s / "
          f"{res['element_ops_per_pmk']} logical ops per PMK; folded mixes: "
          f"{res['folded'] or 'none'} [{card}]", flush=True)
    return res, launches, err, plain_ms


class Crash(Exception):
    """Raised by the crash leg's resume writer: a client killed mid-unit."""


def stub_server(lines, rules_text=None, cracked=None, masks=None):
    """The server side of phase 4's work unit, in process.

    A ``ServerAPI`` whose transport answers the client's requests as the
    repo's server would: one ``get_work`` unit (then "No nets"), the
    unit's dictionary at its ``dpath``, an empty version manifest, and
    ``put_work``, which re-checks every submitted PSK with the oracle and
    answers OK only when all verify.  It never asks the client to wait.
    ``rules_text`` (hashcat rule lines) rides the unit base64-encoded, as
    the repo's server attaches a dict's rules; ``cracked`` (gzip bytes) is
    served as the unit's ``cracked.txt.gz``, which the client runs in
    pass 1 (there is no ``rkg.txt.gz``: its download fails, as the client
    allows).  ``masks`` (``{mask, custom, skip, limit}`` shards, as the
    repo's server issues them from its keyspace table) makes the unit a
    pure-mask one: it carries the shards and no dict.
    """
    from dwpa_tpu_torch.client.protocol import ServerAPI
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.oracle import m22000 as oracle

    nets = {}
    for ln in lines:
        h = hl.parse(ln)
        nets.setdefault(h.mac_ap.hex(), []).append(h)

    class StubServer(ServerAPI):
        def __init__(self, blob, dhash):
            super().__init__(STUB_URL, max_tries=1, sleep=self.never_wait)
            self.blob, self.dhash = blob, dhash
            self.issued = 0
            self.verdicts = []   # per put_work: [(bssid, verified), ...]

        @staticmethod
        def never_wait(seconds):
            raise RuntimeError(f"the client asked the stub server to wait {seconds} s")

        def _transport(self, url, body=None, headers=None):
            if url.endswith("hc/dwpa_tpu.version"):
                return b""
            raise ConnectionError(f"stub server: no route to {url}")

        def fetch(self, url, data=None, max_tries=None):
            query = urllib.parse.urlparse(url).query
            if query.startswith("get_work="):
                if self.issued:
                    return b"No nets"
                self.issued += 1
                unit = {"hkey": STUB_HKEY, "epoch": 1,
                        "dicts": [{"dhash": self.dhash, "dpath": STUB_DICT}],
                        "hashes": list(lines)}
                if masks is not None:
                    unit["dicts"], unit["masks"] = [], masks
                if cracked is not None:
                    unit["dicts"].append({"dhash": hashlib.md5(cracked).hexdigest(),
                                          "dpath": STUB_CRACKED})
                if rules_text:
                    unit["rules"] = base64.b64encode(rules_text.encode()).decode()
                return json.dumps(unit).encode()
            if query == "put_work":
                verdict = [(c["k"], any(
                    oracle.check_key_m22000(h, [bytes.fromhex(c["v"])]) is not None
                    for h in nets.get(c["k"], ()))) for c in data["cand"]]
                self.verdicts.append(verdict)
                return b"OK" if verdict and all(ok for _, ok in verdict) else b"Rejected"
            if url.endswith(STUB_DICT):
                return self.blob
            if cracked is not None and url.endswith(STUB_CRACKED):
                return cracked
            raise ConnectionError(f"stub server: no route to {url}")

    return StubServer


def feed_seconds(reg, family, feed):
    """(observations, summed seconds) of a ``dwpa_feed_*`` histogram."""
    for s in reg.snapshot().get(family, {}).get("samples", ()):
        if s["labels"] == {"feed": feed}:
            return int(s["count"]), s["sum"]
    return 0, 0.0


def check_founds(founds, lines, what, psks=None):
    """Every line found once, with its PSK (``psks[i]``, else PSK), NC
    delta and endian."""
    by_line = {f.line.raw: f for f in founds}
    check(len(founds) == len(lines), f"{what}: {len(founds)}/{len(lines)} nets cracked")
    for i, (raw, (nc, endian)) in enumerate(lines):
        f = by_line.get(raw)
        check(f is not None, f"{what}: net not cracked: {raw[:40]}")
        psk = PSK if psks is None else psks[i]
        check((f.psk, f.nc, f.endian) == (psk, nc, endian),
              f"{what}: wrong find for keyver {f.line.keyver}: {(f.psk, f.nc, f.endian)}")


def make_client(server, workdir, feed_workers, label, phase="phase 6", rule_workers=0,
                pmk_cache_dir=None, dict_cache_dir=None):
    """A ``TpuCrackClient`` for the stub server's unit at full batch, with
    its own registry; returns (client, registry)."""
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    cfg = ClientConfig(base_url=STUB_URL, workdir=str(workdir), batch_size=UNIT_BATCH,
                       max_work_units=1, feed_workers=feed_workers, device="cuda:0",
                       rule_workers=rule_workers,
                       pmk_cache_dir=None if pmk_cache_dir is None else str(pmk_cache_dir),
                       dict_cache_dir=None if dict_cache_dir is None else str(dict_cache_dir))
    return TpuCrackClient(cfg, api=server, registry=reg,
                          log=lambda msg: print(f"{phase} {label} client: {msg}", flush=True)), reg


def report_unit(client, reg, label, unit_pmk_s, card, phase="phase 6"):
    res = client.last_result
    p1 = reg.value("dwpa_client_pmk_per_s", **{"pass": "1"})
    p2 = reg.value("dwpa_client_pmk_per_s", **{"pass": "2"})
    prewarm = client.tracer.records("prewarm")[-1]
    starve = feed_seconds(reg, "dwpa_feed_consumer_starve_seconds", "pass2")
    stall = feed_seconds(reg, "dwpa_feed_producer_stall_seconds", "pass2")
    print(f"{phase} {label}: unit {res.elapsed:.3f} s wall, {res.candidates_tried} candidates; "
          f"pass-1 {p1 or 0.0:.1f} PMK/s, pass-2 {p2 or 0.0:.1f} PMK/s (phase 4 crack "
          f"{unit_pmk_s:.1f} PMK/s); stage host seconds {res.stage_times}; pass-2 feed: "
          f"consumer starve {starve[1]:.3f} s over {starve[0]} blocks, producer stall "
          f"{stall[1]:.3f} s over {stall[0]} waits; prewarm "
          f"{prewarm['t1'] - prewarm['t0']:.3f} s [{card}]", flush=True)
    return p2


def phase_client(card, words, unit_pmk_s):
    """Phase 6: the volunteer loop on the card against the stub server.
    Returns K1's launches in the first run() and its pass-2 PMK/s."""
    from dwpa_tpu_torch import native
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    Server = stub_server(raw)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)

    # -- the unit through TpuCrackClient.run(), feed_workers=1 -------------
    packers = collections.Counter()   # thread name -> native pack calls
    real_pack = native.pack_spans     # every native pack: words or a dict's spans

    def counting_pack(*args, **kwargs):
        packers[threading.current_thread().name] += 1
        return real_pack(*args, **kwargs)

    server = Server(blob, dhash)
    client, reg = make_client(server, CLIENT_DIR / "unit", 1, "feed_workers=1")
    native.pack_spans = counting_pack
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    native.CALLS = 0
    try:
        t0 = time.perf_counter()
        done = client.run()
        wall = time.perf_counter() - t0
    finally:
        native.pack_spans = real_pack
    launches, plain_calls, native_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS, native.CALLS
    check(done == 1, f"run() completed {done} units")
    res = client.last_result
    check_founds(res.founds, lines, "phase 6")
    check(res.accepted and len(server.verdicts) == 1 and len(server.verdicts[0]) == len(lines)
          and all(ok for _, ok in server.verdicts[0]),
          f"unit not accepted with every PSK verified: {server.verdicts}")
    check(len(Path(client.potfile).read_text().splitlines()) == len(lines), "potfile lines")
    check(not Path(client.resume_path).exists(), "resume not cleared")
    check(client.outbox.pending_count() == 0, "outbox not empty")
    check(launches > 0, "the client never launched the PBKDF2 kernel")
    check(plain_calls == 0, f"the client ran the plain PBKDF2 {plain_calls} times")
    check(native_calls > 0, "the native packer never ran")
    pass2_blocks = UNIT_WORDS // UNIT_BATCH
    check(packers["dwpa-feed-pass2-0"] >= pass2_blocks,
          f"the pass-2 producer thread packed {packers['dwpa-feed-pass2-0']} blocks")
    print(f"phase 6 run: 1 unit accepted, {len(res.founds)}/5 nets verified by the stub "
          f"server; run() {wall:.3f} s with challenge and prewarm; K1 launches {launches}, plain "
          f"PBKDF2 calls {plain_calls}, native pack calls {native_calls} by thread "
          f"{dict(packers)}; potfile {len(lines)} lines, resume cleared, outbox empty [{card}]",
          flush=True)
    pass2_pmk_s = report_unit(client, reg, "feed_workers=1", unit_pmk_s, card)

    # -- crash after the 4th pass-2 checkpoint, then a fresh client --------
    server = Server(blob, dhash)
    crashed, _ = make_client(server, CLIENT_DIR / "crash", 1, "crashing")
    in_pass2 = []
    checkpoints = []
    real_fetch, real_write = crashed._fetch_pass2_paths, crashed._write_resume

    def fetch_pass2(work):
        in_pass2.append(True)
        return real_fetch(work)

    def write_then_crash(work):
        real_write(work)
        if in_pass2 and "_progress" in work:
            checkpoints.append(work["_progress"]["done"])
            if len(checkpoints) == 4:
                raise Crash

    crashed._fetch_pass2_paths, crashed._write_resume = fetch_pass2, write_then_crash
    try:
        crashed.run()
        check(False, "the crashing client finished its unit")
    except Crash:
        pass
    checkpointed = json.loads(Path(crashed.resume_path).read_text())["_progress"]["done"]
    pass1 = len(list(crashed._pass1_candidates({"hashes": raw}, [], [])))
    check(checkpointed == checkpoints[-1] == pass1 + 4 * UNIT_BATCH,
          f"checkpoint {checkpointed} after pass-2 checkpoints {checkpoints} (pass 1: {pass1})")
    revived, reg = make_client(server, CLIENT_DIR / "crash", 1, "revived")
    check(revived.run() == 1, "the revived client did not complete the unit")
    skipped = int(reg.value("dwpa_client_resume_skipped_total") or 0)
    check(skipped == checkpointed, f"resume skipped {skipped}, checkpointed {checkpointed}")
    check_founds(revived.last_result.founds, lines, "phase 6 resume")
    check(revived.last_result.accepted and server.issued == 1
          and all(ok for _, ok in server.verdicts[-1]), "the replayed unit was not accepted")
    print(f"phase 6 crash and resume: crashed after pass-2 checkpoints {checkpoints}; the fresh "
          f"client skipped {skipped} candidates, tried {revived.last_result.candidates_tried}, "
          f"found {len(revived.last_result.founds)}/5 and was accepted [{card}]", flush=True)

    # -- the same unit with an inline feed ---------------------------------
    server = Server(blob, dhash)
    inline, reg = make_client(server, CLIENT_DIR / "inline", 0, "feed_workers=0")
    check(inline.run() == 1 and inline.last_result.accepted, "inline-feed unit not accepted")
    check_founds(inline.last_result.founds, lines, "phase 6 inline")
    report_unit(inline, reg, "feed_workers=0", unit_pmk_s, card)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    return launches, pass2_pmk_s


def phase_expand(dev, rng, card):
    """Phase 7a: every rule of wpa.rule over one seeded 131072-word base
    batch on the card, against the same function on CPU tensors (all
    rows) and the host interpreter (sampled rows).  Returns the median
    expand ms per rule."""
    import torch

    from dwpa_tpu_torch.ops.common import to_numpy
    from dwpa_tpu_torch.rules import wpa_rules
    from dwpa_tpu_torch.rules.device import encode_rule, expand_batch, simulate_lens
    from dwpa_tpu_torch.utils import bytesops as bo

    lens = rng.integers(1, 64, UNIT_BATCH)
    blob = rng.integers(1, 256, int(lens.sum()), dtype=np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    words = [blob[offs[i]:offs[i + 1]] for i in range(UNIT_BATCH)]
    packed = torch.from_numpy(bo.pack_passwords_be(words).view(np.int32))
    lens_t = torch.from_numpy(lens.astype(np.int32))
    packed_dev, lens_dev = packed.to(dev), lens_t.to(dev)
    sample = rng.choice(UNIT_BATCH, EXPAND_SAMPLE, replace=False)
    rules = wpa_rules()
    check(len(rules) == 105, f"wpa.rule has {len(rules)} rules")
    times, valid_rows, excused = [], 0, 0
    for rule in rules:
        steps = encode_rule(rule)
        got = expand_batch(packed_dev, lens_dev, steps)
        ref = expand_batch(packed, lens_t, steps)
        check(torch.equal(got.cpu(), ref), f"expand on the card != CPU for rule {rule.text!r}")
        out = to_numpy(got)
        out_lens, hostneed = simulate_lens(rule, lens[sample])
        for k, i in enumerate(sample):
            want = rule.apply(words[i])
            if want is not None and not 8 <= len(want) <= 63:
                want = None
            if hostneed[k]:
                excused += 1
                check(not out[i].any(), f"rule {rule.text!r}: overflow row {i} not zeroed")
                continue
            have = (bo.words_to_bytes_be(out[i])[: int(out_lens[k])]
                    if out[i].any() else None)
            check(have == want, f"rule {rule.text!r} on row {i}: {have!r} != host {want!r}")
            valid_rows += want is not None
        times.append(cuda_ms(lambda: expand_batch(packed_dev, lens_dev, steps), 5))
    med = statistics.median(times)
    print(f"phase 7a expand: {len(rules)} rules x {UNIT_BATCH} words exact on the card vs CPU "
          f"(all rows) and vs the host interpreter ({EXPAND_SAMPLE} rows a rule: {valid_rows} "
          f"valid candidates, {excused} overflow rows excused); expand ms per rule median "
          f"{med:.3f}, min {min(times):.3f}, max {max(times):.3f} (CUDA events, median of 5 "
          f"each) [{card}]", flush=True)
    return med


def phase_rules_engine(dev, rng, card, expand_ms):
    """Phase 7b: crack_rules_blocks on the JAX bench's rules_device
    configuration.  Returns K1's launches and its error against the plain
    version on an expanded batch."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import frame_blocks
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.rules import parse_rules
    from dwpa_tpu_torch.rules.device import encode_rule, expand
    from dwpa_tpu_torch.utils import bytesops as bo

    rules = parse_rules(RULES_DEVICE)
    base = [b"devrule%07d" % i for i in range(UNIT_BATCH * RULES_FLUSHES)]
    psk = rules[-1].apply(base[-1])
    line = tfx.make_pmkid_line(psk, b"bench-essid", seed="rulesdev")
    warm = M22000Engine([line], batch_size=UNIT_BATCH, device=dev)
    warm.crack_rules_blocks(frame_blocks((b"warm%07d" % i for i in range(UNIT_BATCH)), UNIT_BATCH),
                            [rules[0], rules[-1]])

    # K1 on the rules path's shape: 16-column rows expanded on the card,
    # against the plain version (2 iterations) and hashlib (4096).
    eng = M22000Engine([line], batch_size=UNIT_BATCH, device=dev)
    step = eng._step_for(b"bench-essid")
    rows = torch.from_numpy(bo.pack_passwords_be(base[:UNIT_BATCH]).view(np.int32)).to(dev)
    lens = torch.full((UNIT_BATCH,), len(base[0]), dtype=torch.int32, device=dev)
    pw = expand(rows, lens, encode_rule(rules[-1]))
    got = pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(pw, step.salt1, step.salt2, iterations=2)
    ref = pbkdf2.pbkdf2_sha1_pmk(pw, step.salt1, step.salt2, iterations=2)
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "K1 != plain on the expanded 16-column batch")
    pmk = step.compute_pmk(pw)[:, :64].cpu().numpy().astype(np.int32).view(np.uint32)
    for i in range(64):
        want = hashlib.pbkdf2_hmac("sha1", rules[-1].apply(base[i]), b"bench-essid", 4096, 32)
        check(bo.words_to_bytes_be(pmk[:, i]) == want, f"K1 != hashlib on expanded row {i}")

    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    t0 = time.perf_counter()
    founds = eng.crack_rules_blocks(frame_blocks(iter(base), UNIT_BATCH), rules)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    check(len(founds) == 1 and founds[0].psk == psk, f"rules_device missed the PSK: {founds}")
    check(launches == len(rules) * RULES_FLUSHES, f"K1 launched {launches} times")
    check(plain_calls == 0, f"the rules engine ran the plain PBKDF2 {plain_calls} times")
    n = len(base) * len(rules)
    per_rule_ms = wall / (len(rules) * RULES_FLUSHES) * 1e3
    print(f"phase 7b rules engine: {n} candidates ({len(rules)} rules x {len(base)} base words, "
          f"batch {UNIT_BATCH}) in {wall:.3f} s = {n / wall:.1f} candidates/s; PSK found; K1 "
          f"launches {launches}, plain PBKDF2 calls {plain_calls}; stage host seconds "
          f"{eng.stage_times}; {per_rule_ms:.3f} ms per rule batch, expand {expand_ms:.3f} ms "
          f"= {expand_ms / per_rule_ms:.2%} of it; K1 vs plain on the expanded [{UNIT_BATCH}, 16] "
          f"batch exact at 2 iterations, vs hashlib on 64 rows at 4096 [{card}]", flush=True)
    return launches, err, founds, n / wall


def rules_unit(rng, n_words=RULES_UNIT_WORDS):
    """Phase 7c's unit: phase 6's five nets, each with its own PSK made by
    a different rule of the first 16 of wpa.rule from a base word planted
    in the dict's last block.  Returns the lines (each with its NC delta
    and endian), their PSKs, the dict's ``n_words`` words, the rules text
    and the pass-1 ``cracked.txt.gz`` words (none of them a PSK)."""
    from dwpa_tpu_torch.rules import wpa_rules

    rules = wpa_rules()[:RULES_UNIT_RULES]
    picks = [1, 5, 7, 10, 15]          # 'c', 'C', '$1', '$?', '$9'
    bases = [b"rules7c-net%d-base" % k for k in range(5)]
    psks = [rules[r].apply(b) for r, b in zip(picks, bases)]
    lines = five_kind_lines(psks, "r")
    words = random_words(rng, n_words, 8, 20)
    last = min(n_words, UNIT_BATCH)
    for k, b in enumerate(bases):
        words[n_words - last + (k + 1) * last // 6] = b
    cracked = random_words(rng, RULES_CRACKED_WORDS, 8, 20)
    return lines, psks, words, "\n".join(r.text for r in rules) + "\n", cracked


def phase_rules_client(card, rng, unit_pmk_s):
    """Phase 7c: the volunteer loop on a rules unit (pass-1 rules expanded
    in process), then a crash after the first pass-2 block (pass-1 rules
    expanded on a pool of RULE_WORKERS processes) and a fresh client's
    replay, then the two pass-1 expansions timed alone.  Returns K1's
    launches in the first run()."""
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    lines, psks, words, rules_text, cracked_words = rules_unit(rng)
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    cracked = gzip.compress(b"\n".join(cracked_words) + b"\n", compresslevel=1)
    Server = stub_server(raw, rules_text, cracked)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    phase = "phase 7c"

    def pass1_seconds(client):
        return sum(r["t1"] - r["t0"] for r in client.tracer.records("pass1"))

    server = Server(blob, dhash)
    client, reg = make_client(server, CLIENT_DIR / "rules", 1, "rules unit", phase)
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    t0 = time.perf_counter()
    done = client.run()
    wall = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    check(done == 1, f"run() completed {done} units")
    res = client.last_result
    check_founds(res.founds, lines, phase, psks)
    check(res.accepted and len(server.verdicts) == 1 and len(server.verdicts[0]) == len(lines)
          and all(ok for _, ok in server.verdicts[0]),
          f"rules unit not accepted with every PSK verified: {server.verdicts}")
    check(launches > 0 and plain_calls == 0,
          f"K1 launches {launches}, plain PBKDF2 calls {plain_calls}")
    files = [str(Path(client.dictdir) / "cracked.txt.gz")]
    check(Path(files[0]).exists(), "the client did not fetch cracked.txt.gz")
    rules = client._rules({"rules": base64.b64encode(rules_text.encode()).decode()})
    pass1 = len(list(client._pass1_candidates({"hashes": raw}, rules, files)))
    pass1_cracked = len(list(client._stream_cracked(files, rules)))
    check(pass1_cracked == RULES_CRACKED_WORDS * RULES_UNIT_RULES,
          f"pass 1 expanded cracked.txt.gz into {pass1_cracked} candidates")
    pass2 = RULES_UNIT_WORDS * RULES_UNIT_RULES
    check(res.candidates_tried == pass1 + pass2,
          f"tried {res.candidates_tried}, expected {pass1} + {pass2}")
    p1_serial = (reg.value("dwpa_client_pmk_per_s", **{"pass": "1"}), pass1_seconds(client))
    dev_pairs = reg.value("dwpa_rules_device_expanded_total")
    fallback = {r: reg.value("dwpa_rules_host_fallback_total", reason=r) or 0
                for r in ("purge", "overflow")}
    spans = [r["t1"] - r["t0"] for r in client.tracer.records() if r["name"] == "rules:expand"]
    print(f"{phase} run: 1 rules unit accepted, {len(res.founds)}/5 nets verified by the stub "
          f"server ({RULES_UNIT_RULES} rules, {RULES_UNIT_WORDS} base words, pass 1 {pass1} "
          f"candidates of which {pass1_cracked} from cracked.txt.gz); run() {wall:.3f} s "
          f"with challenge and prewarm; K1 launches {launches}, plain PBKDF2 calls {plain_calls}; "
          f"dwpa_rules_device_expanded_total {dev_pairs}, dwpa_rules_host_fallback_total "
          f"{fallback}; rules:expand spans {len(spans)}, {sum(spans):.3f} s in all [{card}]",
          flush=True)
    report_unit(client, reg, "rules unit", unit_pmk_s, card, phase)

    server = Server(blob, dhash)
    crashed, creg = make_client(server, CLIENT_DIR / "rules-crash", 1, "crashing", phase,
                                rule_workers=RULE_WORKERS)
    in_pass2, checkpoints = [], []
    real_fetch, real_write = crashed._fetch_pass2_paths, crashed._write_resume

    def fetch_pass2(work):
        in_pass2.append(True)
        return real_fetch(work)

    def write_then_crash(work):
        real_write(work)
        if in_pass2 and "_progress" in work:
            checkpoints.append(work["_progress"]["done"])
            raise Crash

    crashed._fetch_pass2_paths, crashed._write_resume = fetch_pass2, write_then_crash
    try:
        crashed.run()
        check(False, "the crashing client finished its unit")
    except Crash:
        pass
    p1_pooled = (creg.value("dwpa_client_pmk_per_s", **{"pass": "1"}), pass1_seconds(crashed))
    checkpointed = json.loads(Path(crashed.resume_path).read_text())["_progress"]["done"]
    check(checkpointed == checkpoints[-1] == pass1 + UNIT_BATCH * RULES_UNIT_RULES,
          f"checkpoint {checkpointed} after pass-2 checkpoints {checkpoints} (pass 1: {pass1})")
    revived, reg = make_client(server, CLIENT_DIR / "rules-crash", 1, "revived", phase)
    check(revived.run() == 1, "the revived client did not complete the rules unit")
    skipped = int(reg.value("dwpa_client_resume_skipped_total") or 0)
    check(skipped == checkpointed, f"resume skipped {skipped}, checkpointed {checkpointed}")
    check_founds(revived.last_result.founds, lines, f"{phase} resume", psks)
    check(revived.last_result.accepted and server.issued == 1
          and all(ok for _, ok in server.verdicts[-1]), "the replayed rules unit was not accepted")
    print(f"{phase} crash and resume: crashed after the first pass-2 block's checkpoint "
          f"{checkpoints}; the fresh client skipped {skipped} candidates, tried "
          f"{revived.last_result.candidates_tried}, found {len(revived.last_result.founds)}/5 and "
          f"was accepted [{card}]", flush=True)

    # The pass-1 host expansion alone, no device work: the same stream in
    # process and on the pool (warm from the crashing run).
    drain = {}
    for n in (0, RULE_WORKERS):
        crashed.cfg.rule_workers = n
        t0 = time.perf_counter()
        got = sum(1 for _ in crashed._stream_cracked(files, rules))
        drain[n] = time.perf_counter() - t0
        check(got == pass1_cracked, f"rule_workers {n} expanded {got} candidates")
    print(f"{phase} pass-1 rules on the host: {pass1_cracked} candidates from "
          f"{RULES_CRACKED_WORDS} cracked words; in run() pass 1 ({pass1} candidates) "
          f"rule_workers 0 {p1_serial[0]:.1f} PMK/s in {p1_serial[1]:.3f} s, rule_workers "
          f"{RULE_WORKERS} {p1_pooled[0]:.1f} PMK/s in {p1_pooled[1]:.3f} s (pool start-up "
          f"included); expansion alone rule_workers 0 {drain[0]:.3f} s = "
          f"{pass1_cracked / drain[0]:.1f} candidates/s, rule_workers {RULE_WORKERS} "
          f"{drain[RULE_WORKERS]:.3f} s = {pass1_cracked / drain[RULE_WORKERS]:.1f} "
          f"candidates/s [{card}]", flush=True)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    return launches


def phase_mask_words(dev, card):
    """Phase 8a: the mask generator on the card against its CPU run and
    the host words + pack, at 131072 rows; then its time."""
    import torch

    from dwpa_tpu_torch.gen.mask import device_mask_words, mask_words
    from dwpa_tpu_torch.ops.common import to_numpy
    from dwpa_tpu_torch.utils import bytesops as bo

    rows = 0
    for mask, custom, start in MASK_CASES:
        got = device_mask_words(mask, start, UNIT_BATCH, custom, device=dev)
        check(got.is_cuda and torch.equal(got.cpu(), device_mask_words(
            mask, start, UNIT_BATCH, custom, device="cpu")), f"mask {mask[:16]}@{start}: card != CPU")
        host = list(mask_words(mask, custom, skip=start, limit=UNIT_BATCH))
        ref = bo.pack_passwords_be(host)[:, :got.shape[1]]
        check(np.array_equal(to_numpy(got)[:len(host)], ref),
              f"mask {mask[:16]}@{start}: card != host words")
        rows += len(host)
    times = {mask: cuda_ms(lambda: device_mask_words(mask, 0, UNIT_BATCH, custom, device=dev), 5)
             for mask, custom, _ in (MASK_CASES[0], MASK_CASES[-1])}
    print(f"phase 8a mask words: {len(MASK_CASES)} masks x {UNIT_BATCH} rows exact on the card vs "
          f"CPU, {rows} rows vs the host words and pack; generate {UNIT_BATCH} rows: ?d x 8 "
          f"{times[MASK_CASES[0][0]]:.3f} ms, 63 positions {times[MASK_CASES[-1][0]]:.3f} ms "
          f"(median of 5, CUDA events) [{card}]", flush=True)


def count_h2d(engine_cls):
    """Patch ``engine_cls._h2d`` to count its calls; returns (counter,
    restore)."""
    calls = [0]
    real = engine_cls._h2d

    def counting(self, rows, stager=None):
        calls[0] += 1
        return real(self, rows, stager)

    engine_cls._h2d = counting
    return calls, lambda: setattr(engine_cls, "_h2d", real)


def phase_mask_engine(dev, card):
    """Phase 8b: crack_mask on the JAX bench's config #5 (one PMKID net,
    ?d x 8, 8 x 131072, all miss), then a five-net slice with planted
    PSKs.  Returns K1's launches on config #5 and its error against the
    plain version on a generated batch."""
    import torch

    from dwpa_tpu_torch import native
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.gen.mask import device_mask_words
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.utils import bytesops as bo

    mask = "?d" * 8
    n = MASK_BENCH_BATCHES * UNIT_BATCH
    eng = M22000Engine([tfx.make_pmkid_line(b"not-in-keyspace", b"bench-essid", seed="mask5")],
                       batch_size=UNIT_BATCH, device=dev)
    eng.crack_mask(mask, skip=n, limit=UNIT_BATCH)   # warm-up, disjoint slice
    # K1 on the mask path's shape: [131072, 4] generated rows.
    step = eng._step_for(b"bench-essid")
    pw = device_mask_words(mask, 0, UNIT_BATCH, device=dev)
    got = pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(pw, step.salt1, step.salt2, iterations=2)
    ref = pbkdf2.pbkdf2_sha1_pmk(pw, step.salt1, step.salt2, iterations=2)
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "K1 != plain on a generated mask batch")
    pmk = step.compute_pmk(pw)[:, :64].cpu().numpy().astype(np.int32).view(np.uint32)
    for i in range(64):
        want = hashlib.pbkdf2_hmac("sha1", b"%08d" % i, b"bench-essid", 4096, 32)
        check(bo.words_to_bytes_be(pmk[:, i]) == want, f"K1 != hashlib on mask row {i}")
    eng.stage_times = dict.fromkeys(eng.stage_times, 0.0)
    h2d, restore = count_h2d(M22000Engine)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    native.CALLS = 0
    try:
        t0 = time.perf_counter()
        founds = eng.crack_mask(mask, skip=0, limit=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches, plain_calls, native_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS, native.CALLS
    check(founds == [], f"config #5 found {founds}")
    check(launches == MASK_BENCH_BATCHES and plain_calls == 0,
          f"K1 launches {launches}, plain PBKDF2 calls {plain_calls}")
    check(h2d[0] == 0 and native_calls == 0,
          f"candidate uploads {h2d[0]}, native pack calls {native_calls}")
    print(f"phase 8b crack_mask (config #5): {n} candidates ({MASK_BENCH_BATCHES} x {UNIT_BATCH}) "
          f"in {wall:.3f} s = {n / wall:.1f} candidates/s, {wall / MASK_BENCH_BATCHES * 1e3:.3f} ms "
          f"per batch; K1 launches {launches}, plain PBKDF2 calls {plain_calls}; candidate H2D "
          f"calls {h2d[0]}, native pack calls {native_calls}; stage host seconds "
          f"{eng.stage_times}; K1 vs plain on the generated [{UNIT_BATCH}, {pw.shape[1]}] batch "
          f"exact at 2 iterations, vs hashlib on 64 rows at 4096 [{card}]", flush=True)

    # five nets, five planted PSKs in one 2-batch slice of the keyspace
    lines = five_kind_lines(MASK_NET_PSKS, "m")
    eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev)
    skip = int(MASK_NET_PSKS[0]) - 12_345
    t0 = time.perf_counter()
    founds = eng.crack_mask(mask, skip=skip, limit=2 * UNIT_BATCH)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    check_founds(founds, lines, "phase 8b five nets", MASK_NET_PSKS)
    missing = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev).crack_mask(
        mask, skip=skip + 2 * UNIT_BATCH, limit=UNIT_BATCH)
    check(missing == [], f"a slice past the PSKs found {missing}")
    print(f"phase 8b five nets: {len(founds)}/5 found in a {2 * UNIT_BATCH}-candidate slice at "
          f"{skip} ({2 * UNIT_BATCH / wall5:.1f} candidates/s); the next {UNIT_BATCH} found "
          f"nothing [{card}]", flush=True)
    return launches, err


def phase_mask_client(card):
    """Phase 8c: TpuCrackClient.run() on a pure-mask unit (two ?d x 8
    shards, five nets each with a PSK inside them), then a crash after the
    first mask checkpoint and a fresh client's replay.  Returns K1's
    launches in the first run()."""
    from dwpa_tpu_torch import native
    from dwpa_tpu_torch.client import main as client_main
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    lines = five_kind_lines(MASK_UNIT_PSKS, "mu")
    raw = [ln for ln, _ in lines]
    Server = stub_server(raw, masks=MASK_SHARDS)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    phase = "phase 8c"
    total = sum(s["limit"] for s in MASK_SHARDS)

    # every mask pass (a crack_blocks call on the client's mask_blocks
    # stream) is timed and its uploads, native packs and K1 launches counted
    mask_io, mask_streams = [], []
    h2d, restore_h2d = count_h2d(M22000Engine)
    real_cb, real_mb = M22000Engine.crack_blocks, client_main.mask_blocks

    def tagged_mask_blocks(*args, **kwargs):
        mask_streams.append(real_mb(*args, **kwargs))
        return mask_streams[-1]

    def crack_blocks(self, blocks, on_batch=None):
        if not any(blocks is s for s in mask_streams):
            return real_cb(self, blocks, on_batch)
        before = (h2d[0], native.CALLS, pbkdf2_cuda.LAUNCHES)
        out = real_cb(self, blocks, on_batch)
        mask_io.append((h2d[0] - before[0], native.CALLS - before[1],
                        pbkdf2_cuda.LAUNCHES - before[2]))
        return out

    M22000Engine.crack_blocks, client_main.mask_blocks = crack_blocks, tagged_mask_blocks
    try:
        server = Server(None, None)
        client, reg = make_client(server, CLIENT_DIR / "mask", 1, "mask unit", phase)
        pbkdf2_cuda.LAUNCHES = 0
        pbkdf2.CALLS = 0
        t0 = time.perf_counter()
        done = client.run()
        wall = time.perf_counter() - t0
        launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
        check(done == 1, f"run() completed {done} units")
        res = client.last_result
        check_founds(res.founds, lines, phase, MASK_UNIT_PSKS)
        check(res.accepted and len(server.verdicts) == 1 and len(server.verdicts[0]) == len(lines)
              and all(ok for _, ok in server.verdicts[0]),
              f"mask unit not accepted with every PSK verified: {server.verdicts}")
        check(launches > 0 and plain_calls == 0,
              f"K1 launches {launches}, plain PBKDF2 calls {plain_calls}")
        mask_launches = sum(k for _, _, k in mask_io)
        check(len(mask_io) == len(MASK_SHARDS) and all(io[:2] == (0, 0) for io in mask_io),
              f"mask passes (uploads, native packs, K1 launches): {mask_io}")
        pass1 = len(list(client._pass1_candidates({"hashes": raw}, [], [])))
        check(res.candidates_tried == pass1 + total,
              f"tried {res.candidates_tried}, expected {pass1} + {total}")
        pm = reg.value("dwpa_client_pmk_per_s", **{"pass": "mask"})
        print(f"{phase} run: 1 pure-mask unit ({len(MASK_SHARDS)} shards, {total} candidates) "
              f"accepted, {len(res.founds)}/5 nets verified by the stub server; run() {wall:.3f} s "
              f"with challenge and prewarm; unit {res.elapsed:.3f} s; mask pass {pm:.1f} PMK/s; K1 "
              f"launches {launches} ({mask_launches} in the mask pass), plain PBKDF2 calls "
              f"{plain_calls}; mask passes (candidate uploads, native packs, K1 launches) "
              f"{mask_io}; stage host seconds {res.stage_times} [{card}]", flush=True)

        server = Server(None, None)
        crashed, _ = make_client(server, CLIENT_DIR / "mask-crash", 1, "crashing", phase)
        checkpoints = []
        real_write = crashed._write_resume

        def write_then_crash(work):
            real_write(work)
            mdone = work.get("_progress", {}).get("mask_done", 0)
            if mdone:
                checkpoints.append(mdone)
                raise Crash

        crashed._write_resume = write_then_crash
        try:
            crashed.run()
            check(False, "the crashing client finished its unit")
        except Crash:
            pass
        progress = json.loads(Path(crashed.resume_path).read_text())["_progress"]
        check(checkpoints == [UNIT_BATCH] and progress["mask_done"] == UNIT_BATCH,
              f"mask checkpoints {checkpoints}, resume {progress}")
        revived, rreg = make_client(server, CLIENT_DIR / "mask-crash", 1, "revived", phase)
        check(revived.run() == 1, "the revived client did not complete the mask unit")
        rres = revived.last_result
        check(rres.candidates_tried == total - progress["mask_done"],
              f"replayed {rres.candidates_tried}, expected {total} - {progress['mask_done']}")
        skipped = int(rreg.value("dwpa_client_resume_skipped_total") or 0)
        check(skipped == progress["done"] + progress["mask_done"], f"resume skipped {skipped}")
        check(rres.accepted and server.issued == 1 and len(server.verdicts[-1]) == len(lines)
              and all(ok for _, ok in server.verdicts[-1]), "the replayed mask unit was not accepted")
        print(f"{phase} crash and resume: crashed after the first mask checkpoint "
              f"(mask_done {progress['mask_done']}, done {progress['done']}); the fresh client "
              f"skipped {skipped}, replayed exactly {rres.candidates_tried} = {total} - "
              f"{progress['mask_done']} candidates, submitted {len(server.verdicts[-1])} PSKs and "
              f"was accepted [{card}]", flush=True)
    finally:
        M22000Engine.crack_blocks, client_main.mask_blocks = real_cb, real_mb
        restore_h2d()
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    return launches


def count_rows():
    """Patch the engine's K1 entry to record each launch's row count;
    returns (rows list, restore)."""
    from dwpa_tpu_torch.models import m22000 as m

    rows = []
    real = m.pbkdf2_sha1_pmk_cuda

    def counting(pw, *args, **kwargs):
        rows.append(pw.shape[0])
        return real(pw, *args, **kwargs)

    m.pbkdf2_sha1_pmk_cuda = counting
    return rows, lambda: setattr(m, "pbkdf2_sha1_pmk_cuda", real)


def phase_store_engine(dev, card):
    """Phase 9a: the JAX bench's pmkstore configuration (one PMKID net,
    4 x 131072 words, the warm dictionary sharing 7/8 of the cold one):
    cold and warm PMK/s, K1 launches and rows, hit ratios, the producer's
    split and the consumer's write-back per batch, and written PMKs held
    to hashlib.  Returns K1's launches over both passes."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import CandidateFeed
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.pmkstore import PMKStore

    essid = b"bench-store"
    line = tfx.make_pmkid_line(b"not-in-either-dict", essid, seed="pks")
    n = STORE_BATCHES * UNIT_BATCH
    dict_a = [b"storeword-%08d" % i for i in range(n)]
    dict_b = [dict_a[i] if i % STORE_PERIOD else b"freshword-%08d" % i for i in range(n)]
    root = CLIENT_DIR / "pmkstore-9a"
    shutil.rmtree(root, ignore_errors=True)
    reg = MetricsRegistry()
    store = PMKStore(str(root), registry=reg)
    writes = []
    real_put_many = store.put_many

    def timed_put_many(items):
        t0 = time.perf_counter()
        real_put_many(items)
        writes.append(time.perf_counter() - t0)

    store.put_many = timed_put_many
    M22000Engine([line], batch_size=UNIT_BATCH, device=dev).crack_batch(
        [b"storewarm-%08d" % i for i in range(UNIT_BATCH)])   # plain-path warm-up
    launches = 0
    results = []
    for label, words in (("cold", dict_a), ("warm", dict_b)):
        eng = M22000Engine([line], batch_size=UNIT_BATCH, device=dev, pmk_store=store)
        feed = CandidateFeed(iter(words), batch_size=UNIT_BATCH, depth=2, producers=1,
                             prepack=eng.host_packer(), registry=MetricsRegistry(),
                             name=f"pmkstore_{label}")
        hits0, miss0 = (reg.value(f"dwpa_pmkstore_{k}_total") or 0 for k in ("hits", "misses"))
        del writes[:]
        rows, restore = count_rows()
        torch.cuda.synchronize()
        pbkdf2_cuda.LAUNCHES = 0
        pbkdf2.CALLS = 0
        try:
            t0 = time.perf_counter()
            founds = eng.crack_blocks(feed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
            feed.close()
        check(founds == [], f"pmkstore {label} found {founds}")
        check(pbkdf2.CALLS == 0, f"pmkstore {label} ran the plain PBKDF2")
        launches += pbkdf2_cuda.LAUNCHES
        hits = (reg.value("dwpa_pmkstore_hits_total") or 0) - hits0
        miss = (reg.value("dwpa_pmkstore_misses_total") or 0) - miss0
        produce = [r["t1"] - r["t0"] for r in feed.tracer.records("feed:produce")]
        sample = words[::len(words) // STORE_SAMPLE][:STORE_SAMPLE]
        check(store.lookup(essid, sample) == [hashlib.pbkdf2_hmac("sha1", w, essid, 4096, 32)
                                              for w in sample],
              f"pmkstore {label}: a written PMK differs from hashlib")
        results.append((label, wall))
        print(f"phase 9a pmkstore {label}: {n} words in {wall:.3f} s = {n / wall:.1f} PMK/s; K1 "
              f"launches {pbkdf2_cuda.LAUNCHES} covering rows {rows} ({sum(rows)} in all); hit "
              f"ratio {hits / max(1, hits + miss):.4f} ({hits} hits, {miss} misses); producer "
              f"feed:produce per batch {', '.join(f'{x:.3f}' for x in produce)} s; consumer "
              f"write-back per batch {', '.join(f'{x:.3f}' for x in writes)} s; stage host "
              f"seconds {eng.stage_times}; {len(sample)} written PMKs equal hashlib [{card}]",
              flush=True)
    store.close()
    shutil.rmtree(root, ignore_errors=True)
    cold_s, warm_s = results[0][1], results[1][1]
    print(f"phase 9a pmkstore: warm / cold speed {cold_s / warm_s:.3f}x (bound 1 / (1 - 7/8) "
          f"= 8x) [{card}]", flush=True)
    return launches


def phase_store_client(card, words, unit_pmk_s):
    """Phase 9b: phase 6's five-net dict unit through run() with a PMK
    store, twice: cold (all miss, written back) and warm (all hit, no K1
    in pass 2).  Returns K1's launches in both runs."""
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    Server = stub_server(raw)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    phase = "phase 9b"
    store_dir = CLIENT_DIR / "pmkstore-9b"
    total = 0
    for label in ("cold", "warm"):
        server = Server(blob, dhash)
        client, reg = make_client(server, CLIENT_DIR / f"store-{label}", 1, label, phase,
                                  pmk_cache_dir=store_dir)
        at_pass2 = []
        real_fetch = client._fetch_pass2_paths

        def fetch_pass2(work):
            at_pass2.append(pbkdf2_cuda.LAUNCHES)
            return real_fetch(work)

        client._fetch_pass2_paths = fetch_pass2
        pbkdf2_cuda.LAUNCHES = 0
        pbkdf2.CALLS = 0
        t0 = time.perf_counter()
        done = client.run()
        wall = time.perf_counter() - t0
        launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
        total += launches
        pass2_launches = launches - at_pass2[0]
        check(done == 1, f"run() completed {done} units")
        res = client.last_result
        check_founds(res.founds, lines, f"{phase} {label}")
        check(res.accepted and all(ok for _, ok in server.verdicts[-1])
              and len(server.verdicts[-1]) == len(lines), f"{label} unit not accepted")
        check(plain_calls == 0, f"{label}: plain PBKDF2 calls {plain_calls}")
        want = UNIT_WORDS // UNIT_BATCH if label == "cold" else 0
        check(pass2_launches == want, f"{label}: {pass2_launches} K1 launches in pass 2")
        hits = reg.value("dwpa_pmkstore_hits_total") or 0
        miss = reg.value("dwpa_pmkstore_misses_total") or 0
        writes = reg.value("dwpa_pmkstore_writes_total") or 0
        client.pmk_store.close()
        print(f"{phase} {label}: accepted with {len(res.founds)}/5; K1 launches {launches} "
              f"({pass2_launches} in pass 2), plain PBKDF2 calls {plain_calls}; store hits "
              f"{hits}, misses {miss}, writes {writes}; run() {wall:.3f} s [{card}]", flush=True)
        report_unit(client, reg, label, unit_pmk_s, card, phase)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    return total


def phase_store_poison(dev, rng, card):
    """Phase 9c: the poisoned-cache control.  Five nets (phase 6's kinds)
    each with its own PSK in one ESSID; the store on disk holds a zero PMK
    for the keyver-1 net's PSK (a segment with one intact, CRC-framed
    record, as a bad writer would leave it).  The cold run (one hit, the
    rest misses: mixed blocks) and the warm run (all hits, no K1) must
    both find exactly the other four."""
    import torch

    from dwpa_tpu_torch.feed import CandidateFeed
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2_cuda
    from dwpa_tpu_torch.pmkstore import PMKStore
    from dwpa_tpu_torch.pmkstore import store as fmt

    psks = [b"poison-net-%d-psk" % k for k in range(5)]
    lines = five_kind_lines(psks, "pz")
    poisoned = 3                                  # the keyver-1 net
    words = random_words(rng, POISON_WORDS, 8, 20)
    for k, psk in enumerate(psks):
        words[(k + 1) * POISON_WORDS // 6] = psk
    root = CLIENT_DIR / "pmkstore-9c"
    shutil.rmtree(root, ignore_errors=True)
    (root / ESSID.hex()).mkdir(parents=True)
    record = fmt.word_digest(psks[poisoned]) + b"\x00" * fmt.PMK_LEN
    (root / ESSID.hex() / "seg-0-0000000000.pmkseg").write_bytes(
        fmt.SEG_MAGIC + fmt.FRAME_MAGIC + struct.pack("<II", 1, zlib.crc32(record)) + record)
    store = PMKStore(str(root), registry=MetricsRegistry())
    for label in ("cold", "warm"):
        eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev,
                           pmk_store=store)
        feed = CandidateFeed(iter(words), batch_size=UNIT_BATCH, prepack=eng.host_packer(),
                             registry=MetricsRegistry(), name=f"poison_{label}")
        pbkdf2_cuda.LAUNCHES = 0
        try:
            founds = eng.crack_blocks(feed)
            torch.cuda.synchronize()
        finally:
            feed.close()
        launches = pbkdf2_cuda.LAUNCHES
        keep = [i for i in range(5) if i != poisoned]
        check_founds(founds, [lines[i] for i in keep], f"phase 9c {label}", [psks[i] for i in keep])
        want = POISON_WORDS // UNIT_BATCH if label == "cold" else 0
        check(launches == want, f"phase 9c {label}: {launches} K1 launches")
        print(f"phase 9c poisoned store {label}: {len(founds)}/5 found, the keyver-1 net (zero PMK "
              f"in the store) missed as it must; K1 launches {launches} [{card}]", flush=True)
    check(store.lookup(ESSID, psks) == [
        b"\x00" * 32 if k == poisoned else hashlib.pbkdf2_hmac("sha1", p, ESSID, 4096, 32)
        for k, p in enumerate(psks)], "phase 9c: the store's PSK records are wrong")
    store.close()
    shutil.rmtree(root, ignore_errors=True)


def phase_fused_step(dev, rng, card):
    """Phase 10a: K1 through the fused step.  One fused batch of 8 units x
    16,000 seeded words (131072 lanes, an [8, 16] salt table): the step
    against the plain version at 2 iterations, and 8 lanes of each unit
    against hashlib under that unit's ESSID at 4096.  Returns (max_abs_err,
    ms of the step at 4096)."""
    import torch

    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.ops.common import to_numpy, to_torch
    from dwpa_tpu_torch.parallel.step import fused_pmk_step
    from dwpa_tpu_torch.sched import fuse_units
    from dwpa_tpu_torch.utils import bytesops as bo

    parts = [(b"fused-step-%d" % u, random_words(rng, FUSED_WORDS, 8, 20), FUSED_WORDS)
             for u in range(FUSED_UNITS)]
    fb = fuse_units(parts, UNIT_BATCH, 1, FUSED_UNITS)
    check((fb.width, fb.table1.shape) == (UNIT_BATCH, (FUSED_UNITS, 16)),
          f"phase 10a: fused width {fb.width}, table {fb.table1.shape}")
    w = 8
    rows, uid, t1, t2 = (to_torch(a, dev) for a in (
        np.ascontiguousarray(fb.miss_rows[:, :w]), fb.unit_id, fb.table1, fb.table2))
    got = fused_pmk_step(rows, uid, t1, t2, iterations=2)
    ref = pbkdf2.pbkdf2_sha1_pmk(rows, t1.index_select(0, uid).contiguous(),
                                 t2.index_select(0, uid).contiguous(), iterations=2)
    err = int((got.long() - ref.long()).abs().max())
    check(torch.equal(got, ref), "phase 10a: fused step != plain at 2 iterations")
    before = pbkdf2_cuda.LAUNCHES
    pmk = to_numpy(fused_pmk_step(rows, uid, t1, t2))
    check(pbkdf2_cuda.LAUNCHES == before + 1, "phase 10a: the fused step did not launch K1 once")
    for u in fb.units:
        for i in rng.choice(u.nvalid, FUSED_SAMPLE, replace=False):
            check(bo.words_to_bytes_be(pmk[:, u.lo + int(i)]) == hashlib.pbkdf2_hmac(
                "sha1", u.words[int(i)], u.key, 4096, 32),
                f"phase 10a: lane {u.lo + int(i)} != hashlib under {u.key!r}")
    ms = cuda_ms(lambda: fused_pmk_step(rows, uid, t1, t2), 5)
    print(f"phase 10a fused step: {FUSED_UNITS} units x {FUSED_WORDS} words in one "
          f"{fb.width}-lane batch (W={w}, table {list(fb.table1.shape)}); exact vs plain at 2 "
          f"iterations, {FUSED_UNITS * FUSED_SAMPLE} lanes vs hashlib at 4096 under their own "
          f"ESSID; gather + K1 {ms:.3f} ms (median of 5, CUDA events) [{card}]", flush=True)
    return err, ms


def small_units(tag):
    """bench.py:502's small_units stream: 8 units, each one PMKID net with
    its PSK planted last among 1000 words; as (line, essid, words, psk)."""
    from dwpa_tpu_torch import testing as tfx

    units = []
    for i in range(SMALL_UNITS):
        psk = ("fusedpass-%s-%03d" % (tag, i)).encode()
        essid = ("bench-small-%s-%d" % (tag, i)).encode()
        words = [("su%s%d-%07d" % (tag, i, j)).encode() for j in range(SMALL_WORDS - 1)] + [psk]
        units.append((tfx.make_pmkid_line(psk, essid, seed=f"su-{tag}-{i}"), essid, words, psk))
    return units


def spy_fused():
    """Record every ``FusedBatch`` the engine packs and each engine's stage
    times after its ``crack_fused``; returns (batches, engines, restore)."""
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.sched import fuse as fuse_mod

    batches, engines = [], []
    real_fuse, real_crack = fuse_mod.fuse_units, M22000Engine.crack_fused

    def fuse(*args, **kwargs):
        fb = real_fuse(*args, **kwargs)
        batches.append(fb)
        return fb

    def crack_fused(self, *args, **kwargs):
        out = real_crack(self, *args, **kwargs)
        engines.append(dict(self.stage_times))
        return out

    fuse_mod.fuse_units, M22000Engine.crack_fused = fuse, crack_fused

    def restore():
        fuse_mod.fuse_units, M22000Engine.crack_fused = real_fuse, real_crack

    return batches, engines, restore


def phase_small_units(dev, card):
    """Phase 10b: the JAX bench's small_units configuration, serial (one
    engine per unit through ``crack``) against fused (one engine through
    ``crack_fused``), both after same-shaped warm-ups.  Returns the fused
    leg's K1 launches."""
    import torch

    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.sched import fused_width

    line, _, words, _ = small_units("warm-serial")[0]
    M22000Engine([line], batch_size=UNIT_BATCH, device=dev).crack(words)
    warm = small_units("warm-fused")
    M22000Engine([u[0] for u in warm], batch_size=UNIT_BATCH, device=dev).crack_fused(
        [(u[1], u[2]) for u in warm], max_units=SMALL_UNITS)
    units = small_units("run")
    n = SMALL_UNITS * SMALL_WORDS
    expected = sorted((e, p) for _, e, _, p in units)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    t0 = time.perf_counter()
    serial = [(f.line.essid, f.psk) for line, _, words, _ in units
              for f in M22000Engine([line], batch_size=UNIT_BATCH, device=dev).crack(words)]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    serial_launches = pbkdf2_cuda.LAUNCHES
    eng = M22000Engine([u[0] for u in units], batch_size=UNIT_BATCH, device=dev)
    stats = []
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    fused = eng.crack_fused([(u[1], u[2]) for u in units], max_units=SMALL_UNITS,
                            on_fused=lambda fb: stats.append((len(fb.units), fb.width, fb.fill)))
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = pbkdf2_cuda.LAUNCHES
    check(pbkdf2.CALLS == 0, "phase 10b ran the plain PBKDF2")
    check(sorted(serial) == expected, f"phase 10b: the serial leg found {sorted(serial)}")
    check(sorted((f.line.essid, f.psk) for f in fused) == sorted(serial),
          "phase 10b: the fused leg's founds differ from the serial leg's")
    width = fused_width(UNIT_BATCH, 1, n)
    check(stats == [(SMALL_UNITS, width, n / width)], f"phase 10b: fused batches {stats}")
    check((serial_launches, fused_launches) == (SMALL_UNITS, 1),
          f"phase 10b: K1 launches serial {serial_launches}, fused {fused_launches}")
    print(f"phase 10b small_units ({SMALL_UNITS} units x {SMALL_WORDS} words, batch "
          f"{UNIT_BATCH}): serial {n / serial_s:.1f} PMK/s ({serial_s:.3f} s), fused "
          f"{n / fused_s:.1f} PMK/s ({fused_s:.3f} s), fused / serial {serial_s / fused_s:.3f}x; "
          f"fused width {width}, fill {n / width:.4f}, {SMALL_UNITS} units per batch; K1 "
          f"launches serial {serial_launches}, fused {fused_launches}; founds identical; fused "
          f"stage host seconds {eng.stage_times} [{card}]", flush=True)
    return fused_launches


def stream_units(rng):
    """Phase 10c's stream: 32 units of 16,000 seeded words, each with one
    net of the five kinds in turn and its PSK at a seeded position; units 0
    and 1 share an ESSID.  As (unit lines with (NC, endian), essid, words,
    psk, plant)."""
    units = []
    for u in range(STREAM_UNITS):
        essid = b"fused-stream-%02d" % (u if u != 1 else 0)
        psk = b"stream-psk-%02d" % u
        words = random_words(rng, FUSED_WORDS, 8, 20)
        plant = int(rng.integers(0, FUSED_WORDS))
        words[plant] = psk
        units.append((kind_line(u % 5, psk, essid, f"st{u}"), essid, words, psk, plant))
    return units


def run_stream(client, units, label, card, want_launches=None):
    """One pass of the stream through ``client.fused_executor``: every unit
    done with its PSK, none failed, K1 launched once per fused batch with
    misses.  Returns (K1 launches, wall s)."""
    import torch

    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.sched import WorkUnit, fused_width

    work = [WorkUnit(uid=u, lines=[line], words=words)
            for u, ((line, _), _, words, _, _) in enumerate(units)]
    ex = client.fused_executor(work)
    batches, engines, restore = spy_fused()
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    try:
        t0 = time.perf_counter()
        done = ex.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = pbkdf2_cuda.LAUNCHES
    check(pbkdf2.CALLS == 0, f"{label} ran the plain PBKDF2")
    check(ex.failed == [] and sorted(u.uid for u in done) == list(range(STREAM_UNITS)),
          f"{label}: done {sorted(u.uid for u in done)}, failed {[u.uid for u in ex.failed]}")
    for u in done:
        (line, (nc, endian)), essid, _, psk, _ = units[u.uid]
        want = [(line, psk, nc, endian, hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32))]
        check([(f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in u.founds] == want,
              f"{label}: unit {u.uid} found {[(f.psk, f.nc, f.endian) for f in u.founds]}")
        check(u.consumed == FUSED_WORDS, f"{label}: unit {u.uid} consumed {u.consumed}")
    with_miss = sum(1 for fb in batches if fb.nmiss)
    check(launches == with_miss, f"{label}: {launches} K1 launches for {with_miss} fused "
                                 f"batches with misses")
    if want_launches is not None:
        check(launches == want_launches, f"{label}: {launches} K1 launches, want {want_launches}")
    for fb in batches:
        check(fb.width == fused_width(UNIT_BATCH, 1, fb.total) and fb.fill == fb.total / fb.width,
              f"{label}: a fused batch of {fb.total} lanes at width {fb.width}")
    full = [fb for fb in batches if len(fb.units) == FUSE_MAX_UNITS]
    check(all((fb.width, fb.total) == (UNIT_BATCH, FUSE_MAX_UNITS * FUSED_WORDS) for fb in full),
          f"{label}: a full wave off width {UNIT_BATCH}")
    shared = [i for i, fb in enumerate(batches) if {b"fused-stream-00"} <= {v.key for v in fb.units}]
    check(len(shared) == 2, f"{label}: the shared ESSID rode {len(shared)} batches, want 2")
    n = STREAM_UNITS * FUSED_WORDS
    print(f"{label}: {STREAM_UNITS} units x {FUSED_WORDS} words in {wall:.3f} s = "
          f"{n / wall:.1f} PMK/s; {len(batches)} fused batches (units, width, miss width, fill): "
          f"{[(len(fb.units), fb.width, fb.miss_width, round(fb.fill, 4)) for fb in batches]}; "
          f"K1 launches {launches}; per wave dispatch / collect s: "
          f"{[(round(e['dispatch'], 3), round(e['collect'], 3)) for e in engines]} [{card}]",
          flush=True)
    return launches, wall


def phase_fused_stream(card, rng):
    """Phases 10c and 10d: the stream through ``MultiUnitExecutor`` (the
    client's ``fused_executor``, unit_queue 4, fuse_max_units 8), then
    through a fresh PMK store cold, fully warm (no K1) and half warm (a
    second dict sharing half of each unit's words: ``mix_step`` runs).
    Returns K1's launches per run."""
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.obs import MetricsRegistry

    def client(label, store=None):
        cfg = ClientConfig(base_url=STUB_URL, workdir=str(CLIENT_DIR / f"fused-{label}"),
                           batch_size=UNIT_BATCH, device="cuda:0", unit_queue=UNIT_QUEUE,
                           fuse_max_units=FUSE_MAX_UNITS,
                           pmk_cache_dir=None if store is None else str(store))
        return TpuCrackClient(cfg, registry=MetricsRegistry(),
                              log=lambda msg: print(f"phase 10 {label}: {msg}", flush=True))

    units = stream_units(rng)
    launches = {}
    c = client("stream")
    launches["10c"], wall = run_stream(c, units, "phase 10c stream", card)
    reg = c.registry
    print(f"phase 10c metrics: dwpa_fused_units_per_batch count "
          f"{reg.value('dwpa_fused_units_per_batch')}, last fill "
          f"{reg.value('dwpa_fused_fill_fraction'):.4f} [{card}]", flush=True)

    root = CLIENT_DIR / "pmkstore-10d"
    shutil.rmtree(root, ignore_errors=True)
    c = client("store", root)
    half = []
    for (line, essid, words, psk, plant) in units:
        fresh = random_words(rng, FUSED_WORDS, 8, 20)
        half.append((line, essid, [w if i % 2 == 0 or i == plant else fresh[i]
                                   for i, w in enumerate(words)], psk, plant))
    walls = {"10c": wall}
    for label, stream, want in (("cold", units, None), ("warm", units, 0), ("half", half, None)):
        key = f"10d {label}"
        launches[key], walls[key] = run_stream(c, stream, f"phase 10d store {label}", card, want)
    sample = [(essid, words[i]) for _, essid, words, _, _ in half
              for i in rng.choice(FUSED_WORDS, STREAM_SAMPLE // STREAM_UNITS, replace=False)]
    check(all(c.pmk_store.lookup(e, [w]) == [hashlib.pbkdf2_hmac("sha1", w, e, 4096, 32)]
              for e, w in sample), "phase 10d: a store record differs from hashlib")
    c.pmk_store.close()
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 10d store: {len(sample)} sampled records equal hashlib; cold / warm / half "
          f"{walls['10d cold']:.3f} / {walls['10d warm']:.3f} / {walls['10d half']:.3f} s against "
          f"{walls['10c']:.3f} s without the store; K1 launches {launches} [{card}]", flush=True)
    return launches


def write_dict(root, words):
    """A gz dict under ``root`` named by its md5, as the client stores
    server dicts; returns the ``(path, dhash)`` unit."""
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    path = Path(root) / f"{dhash}.gz"
    path.write_bytes(blob)
    return str(path), dhash


def count_streams():
    """Count the ``DictStream`` passes (gunzips) the feed sources open;
    returns (opened paths, restore)."""
    from dwpa_tpu_torch.gen import dicts

    real, opened = dicts.DictStream, []

    class Counting(real):
        def __iter__(self):
            opened.append(self.source)
            return super().__iter__()

    dicts.DictStream = Counting
    return opened, lambda: setattr(dicts, "DictStream", real)


def drain_dict(units, cache, prepack=None, skip=0, engine=None, on_batch=None, keep=None):
    """bench.py:427's drain: ``DictFeedSource`` through ``CandidateFeed``
    with two producers, into ``engine.crack_blocks`` or counted (blocks
    appended to ``keep``).  Returns (founds or words, words skipped)."""
    from dwpa_tpu_torch.feed import CandidateFeed, DictFeedSource
    from dwpa_tpu_torch.obs import MetricsRegistry

    src = DictFeedSource(units, batch_size=UNIT_BATCH, cache=cache, skip=skip, name="dcache")
    feed = CandidateFeed(None, batch_size=UNIT_BATCH, frames=src, producers=2, prepack=prepack,
                         registry=MetricsRegistry(), name="dcache")
    try:
        if engine is not None:
            return engine.crack_blocks(feed, on_batch=on_batch), src.skipped
        n = 0
        for blk in feed:
            n += blk.count
            if keep is not None:
                keep.append(blk)
        return n, src.skipped
    finally:
        feed.close()


def cache_blocks(reg):
    """(hit, miss) blocks of a dict cache's registry."""
    return tuple(int(reg.value(f"dwpa_dictcache_{k}_blocks_total") or 0) for k in ("hit", "miss"))


def phase_dict_cache_feed(card):
    """Phase 11a: the JAX bench's dict_cache feed-only legs (bench.py:398):
    a 200,000-word gz dict through ``DictFeedSource`` + ``CandidateFeed``
    with two producers, cold (gunzip, native pack, the cache write) then
    warm (mmap'd packed chunks, materialized on the producers).  Words/s of
    each, the cache's bytes, and the warm stream held to the cold one word
    for word."""
    from dwpa_tpu_torch.feed import DictCache
    from dwpa_tpu_torch.native import pack_candidates_fast
    from dwpa_tpu_torch.obs import MetricsRegistry

    root = CLIENT_DIR / "dcache-11a"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    words = [b"dcachebench-%09d" % i for i in range(DCACHE_FEED_WORDS)]
    units = [write_dict(root, words)]
    reg = MetricsRegistry()
    cache = DictCache(str(root / "dc"), registry=reg)
    rate, blocks = {}, {}
    for label in ("cold", "warm"):
        blocks[label] = []
        t0 = time.perf_counter()
        n, _ = drain_dict(units, cache, keep=blocks[label])
        rate[label] = n / (time.perf_counter() - t0)
        check(n == DCACHE_FEED_WORDS, f"11a {label}: {n} words")
    nblk = len(blocks["cold"])
    check(cache_blocks(reg) == (nblk, nblk), f"11a hit/miss blocks {cache_blocks(reg)}")
    cold, warm = blocks["cold"], blocks["warm"]
    check([(b.offset, b.count) for b in cold] == [(b.offset, b.count) for b in warm],
          "11a: warm block geometry differs from cold")
    for c, w in zip(cold, warm):
        rows, lens, nv = w.prep
        check(w.words == [] and nv == len(c.words), f"11a: warm block at {w.offset}: {nv} rows")
        flat = rows[:nv].astype(">u4").tobytes()
        got = [flat[64 * i:64 * i + int(n)] for i, n in enumerate(lens)]
        check(got == c.words, f"11a: warm words differ from cold at block {w.offset}")
        packed = pack_candidates_fast(c.words, 8, 63, capacity=UNIT_BATCH)
        check(np.array_equal(packed[0], rows), f"11a: warm rows differ from the packer's at {w.offset}")
    nbytes = cache._bytes_used()
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11a dict cache feed: {DCACHE_FEED_WORDS} words in {nblk} blocks of {UNIT_BATCH}, "
          f"two producers; cold {rate['cold']:.1f} words/s, warm {rate['warm']:.1f} words/s, "
          f"warm / cold {rate['warm'] / rate['cold']:.3f}x; cache {nbytes} bytes "
          f"({nbytes / DCACHE_FEED_WORDS:.1f} a word); warm words equal cold word for word, warm "
          f"rows equal the native packer's [{card}]", flush=True)


def phase_dict_cache_engine(dev, card):
    """Phase 11b: the JAX bench's dict_cache e2e legs (bench.py:447): a
    planted-PSK dict of 2 x 131072 words through ``crack_blocks`` with
    ``host_packer()``, cold then warm: the founds, per-batch consumed
    counts and K1 launches identical; a mid-stream resume skip accounted
    identically cold and warm (the warm one opens no gunzip); K1 held to
    the plain version, exactly, at 2 iterations on a batch materialized
    from the warm cache.  Returns K1's launches in the cold and warm legs."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import DictCache, DictFeedSource
    from dwpa_tpu_torch.models.m22000 import M22000Engine, _trim_cols
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    root = CLIENT_DIR / "dcache-11b"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    psk, essid = b"benchpass1", b"bench-dcache"
    n2 = DCACHE_E2E_BATCHES * UNIT_BATCH
    units = [write_dict(root, [b"dcache-e2e-%09d" % i for i in range(n2 - 1)] + [psk])]
    line = tfx.make_pmkid_line(psk, essid, seed="dcache-e2e")
    M22000Engine([line], batch_size=UNIT_BATCH, device=dev).crack_batch(
        [b"dcachewarm0-%07d" % i for i in range(UNIT_BATCH)])       # plain-path warm-up
    reg = MetricsRegistry()
    cache = DictCache(str(root / "dc"), registry=reg)

    def crack(cache_, skip=0):
        eng = M22000Engine([line], batch_size=UNIT_BATCH, device=dev)
        consumed = []
        opened, restore = count_streams()
        torch.cuda.synchronize()
        pbkdf2_cuda.LAUNCHES = 0
        pbkdf2.CALLS = 0
        try:
            t0 = time.perf_counter()
            founds, skipped = drain_dict(units, cache_, prepack=eng.host_packer(), skip=skip,
                                         engine=eng, on_batch=lambda c, f: consumed.append(c))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        check(pbkdf2.CALLS == 0, "11b ran the plain PBKDF2")
        return ([f.psk for f in founds], consumed, pbkdf2_cuda.LAUNCHES, skipped,
                len(opened)), wall

    cold, cold_s = crack(cache)
    warm, warm_s = crack(cache)
    check(cold[0] == [psk] and cold[:3] == warm[:3],
          f"11b cold {cold[:3]} against warm {warm[:3]}")
    check(sum(cold[1]) == n2 and (cold[4], warm[4]) == (1, 0),
          f"11b: consumed {sum(cold[1])}, gunzip passes cold {cold[4]} warm {warm[4]}")
    check(cache_blocks(reg) == (DCACHE_E2E_BATCHES, DCACHE_E2E_BATCHES),
          f"11b hit/miss blocks {cache_blocks(reg)}")
    rcold, _ = crack(None, DCACHE_RESUME)
    rwarm, _ = crack(cache, DCACHE_RESUME)
    check(rcold[:4] == rwarm[:4] and rcold[0] == [psk] and rcold[3] == DCACHE_RESUME
          and sum(rcold[1]) == n2 - DCACHE_RESUME and rwarm[4] == 0,
          f"11b resume at {DCACHE_RESUME}: cold {rcold[1:]} warm {rwarm[1:]}")

    # K1 against the plain version on a batch materialized from the cache.
    blk = next(iter(DictFeedSource(units, UNIT_BATCH, cache=cache)))
    rows, lens, nv = blk.prep.materialize()
    w = _trim_cols(int(lens.max()))
    pw = torch.from_numpy(np.ascontiguousarray(rows[:, :w]).view(np.int32)).to(dev)
    step = M22000Engine([line], batch_size=UNIT_BATCH, device=dev)._step_for(essid)
    got = pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(pw, step.salt1, step.salt2, iterations=2)
    ref = pbkdf2.pbkdf2_sha1_pmk(pw, step.salt1, step.salt2, iterations=2)
    err = int((got.long() - ref.long()).abs().max())
    check(nv == UNIT_BATCH and torch.equal(got, ref), "11b: K1 != plain on the warm batch")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11b dict cache e2e: {n2} words, PSK in the last batch; cold {cold_s:.3f} s = "
          f"{n2 / cold_s:.1f} PMK/s, warm {warm_s:.3f} s = {n2 / warm_s:.1f} PMK/s (warm / cold "
          f"{cold_s / warm_s:.3f}x); founds, consumed {cold[1]} and K1 launches {cold[2]} equal "
          f"cold and warm; resume skip {DCACHE_RESUME}: skipped {rwarm[3]}, consumed {rwarm[1]} "
          f"equal cold and warm, the warm one with {rwarm[4]} gunzip passes; K1 vs plain on a "
          f"[{UNIT_BATCH}, {w}] warm batch exact at 2 iterations, max_abs_err={err} [{card}]",
          flush=True)
    return cold[2] + warm[2]


def pass2_stamps(client):
    """Record the resume stamps a client writes once pass 2 has begun."""
    stamps, real_write, real_fetch = [], client._write_resume, client._fetch_pass2_paths
    started = []

    def fetch(work):
        started.append(True)
        return real_fetch(work)

    def write(work):
        real_write(work)
        if started and "_progress" in work:
            stamps.append(work["_progress"]["done"])

    client._fetch_pass2_paths, client._write_resume = fetch, write
    return stamps


def run_counted(client):
    """``client.run()`` with K1's launches and the feed's gunzip passes
    counted; returns (units done, K1 launches, gunzip passes, wall s)."""
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    opened, restore = count_streams()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    try:
        t0 = time.perf_counter()
        done = client.run()
        wall = time.perf_counter() - t0
    finally:
        restore()
    check(pbkdf2.CALLS == 0, f"the client ran the plain PBKDF2 {pbkdf2.CALLS} times")
    return done, pbkdf2_cuda.LAUNCHES, len(opened), wall


def found_keys(founds):
    return sorted((f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in founds)


def phase_dict_cache_client(card, words, unit_pmk_s, phase6_p2):
    """Phase 11c: phase 6's unit through ``run()`` with ``dict_cache_dir``,
    cold then warm: the warm pass 2 serves only hit blocks and opens no
    ``DictStream``, with the cold run's resume stamps and finds; pass-2
    PMK/s beside phase 6's.  Then a warm run crashed after the 4th pass-2
    checkpoint, and a fresh client's replay by an index-seek skip (no
    gunzip), accepted with the same finds.  Returns K1's launches."""
    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    Server = stub_server(raw)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    phase = "phase 11c"
    dcdir = CLIENT_DIR / "dictcache-11c"
    nblk = UNIT_WORDS // UNIT_BATCH
    runs, total = {}, 0
    for label in ("cold", "warm"):
        server = Server(blob, dhash)
        client, reg = make_client(server, CLIENT_DIR / f"dcache-{label}", 1, label, phase,
                                  dict_cache_dir=dcdir)
        stamps = pass2_stamps(client)
        done, launches, opened, wall = run_counted(client)
        total += launches
        res = client.last_result
        check(done == 1 and res.accepted and all(ok for _, ok in server.verdicts[-1]),
              f"11c {label}: unit not accepted")
        check_founds(res.founds, lines, f"{phase} {label}")
        want = (0, nblk) if label == "cold" else (nblk, 0)
        check(cache_blocks(reg) == want and opened == int(label == "cold"),
              f"11c {label}: hit/miss blocks {cache_blocks(reg)}, gunzip passes {opened}")
        runs[label] = (found_keys(res.founds), stamps, launches)
        print(f"{phase} {label}: accepted with {len(res.founds)}/5; K1 launches {launches}; "
              f"hit/miss blocks {cache_blocks(reg)}; pass-2 gunzip passes {opened}; cache bytes "
              f"{int(reg.value('dwpa_dictcache_bytes'))}; run() {wall:.3f} s [{card}]", flush=True)
        p2 = report_unit(client, reg, label, unit_pmk_s, card, phase)
        runs[label] += (p2,)
    check(runs["cold"][:3] == runs["warm"][:3],
          "11c: warm founds, stamps or K1 launches differ from cold")

    server = Server(blob, dhash)
    crashed, _ = make_client(server, CLIENT_DIR / "dcache-crash", 1, "crashing", phase,
                             dict_cache_dir=dcdir)
    stamps = pass2_stamps(crashed)
    real_write = crashed._write_resume

    def write_then_crash(work):
        real_write(work)
        if len(stamps) == 4:
            raise Crash

    crashed._write_resume = write_then_crash
    try:
        run_counted(crashed)
        check(False, "the crashing client finished its unit")
    except Crash:
        pass
    checkpointed = json.loads(Path(crashed.resume_path).read_text())["_progress"]["done"]
    check(stamps == runs["cold"][1][:4] and checkpointed == stamps[-1],
          f"11c crash: stamps {stamps} against cold {runs['cold'][1][:4]}")
    revived, reg = make_client(server, CLIENT_DIR / "dcache-crash", 1, "revived", phase,
                               dict_cache_dir=dcdir)
    done, launches, opened, wall = run_counted(revived)
    total += launches
    skipped = int(reg.value("dwpa_client_resume_skipped_total") or 0)
    res = revived.last_result
    check(done == 1 and res.accepted and server.issued == 1
          and all(ok for _, ok in server.verdicts[-1]), "11c: the replayed unit was not accepted")
    check(skipped == checkpointed and opened == 0 and cache_blocks(reg) == (nblk - 4, 0)
          and found_keys(res.founds) == runs["cold"][0],
          f"11c replay: skipped {skipped} of {checkpointed}, gunzip passes {opened}, "
          f"hit/miss {cache_blocks(reg)}")
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    print(f"{phase} crash and resume: crashed after pass-2 stamps {stamps} (the cold run's); the "
          f"fresh client skipped {skipped} by an index seek with {opened} gunzip passes, served "
          f"{cache_blocks(reg)[0]} hit blocks, tried {res.candidates_tried}, found the same 5 and "
          f"was accepted in {wall:.3f} s; pass-2 PMK/s cold {runs['cold'][3] or 0.0:.1f}, warm "
          f"{runs['warm'][3] or 0.0:.1f}, phase 6 {phase6_p2 or 0.0:.1f} [{card}]", flush=True)
    return total


def phase_rbase_client(card, rng, unit_pmk_s):
    """Phase 11d: phase 7c's rules unit (five nets, the first 16 rules of
    wpa.rule), its base dict cut to one 131072-word block and no pass-1
    cracked dict, through ``run()`` with ``dict_cache_dir``, cold then warm from
    the ``.rbase`` entry: identical finds and resume stamps, the warm pass
    2 hit-only with no gunzip, ``rules:expand`` timed in both.  Returns
    K1's launches."""
    lines, psks, words, rules_text, _ = rules_unit(rng, RBASE_UNIT_WORDS)
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    Server = stub_server(raw, rules_text)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    phase = "phase 11d"
    dcdir = CLIENT_DIR / "dictcache-11d"
    nblk = -(-RBASE_UNIT_WORDS // UNIT_BATCH)
    runs, total = {}, 0
    for label in ("cold", "warm"):
        server = Server(blob, dhash)
        client, reg = make_client(server, CLIENT_DIR / f"rbase-{label}", 1, label, phase,
                                  dict_cache_dir=dcdir)
        stamps = pass2_stamps(client)
        done, launches, opened, wall = run_counted(client)
        total += launches
        res = client.last_result
        check(done == 1 and res.accepted and all(ok for _, ok in server.verdicts[-1]),
              f"11d {label}: rules unit not accepted")
        check_founds(res.founds, lines, f"{phase} {label}", psks)
        want = (0, nblk) if label == "cold" else (nblk, 0)
        check(cache_blocks(reg) == want and opened == int(label == "cold"),
              f"11d {label}: hit/miss blocks {cache_blocks(reg)}, gunzip passes {opened}")
        rules = client._rules({"rules": base64.b64encode(rules_text.encode()).decode()})
        pass1 = len(list(client._pass1_candidates({"hashes": raw}, rules, [])))
        check(res.candidates_tried == pass1 + RBASE_UNIT_WORDS * RULES_UNIT_RULES,
              f"11d {label}: tried {res.candidates_tried}, pass 1 {pass1}")
        spans = [r["t1"] - r["t0"] for r in client.tracer.records() if r["name"] == "rules:expand"]
        runs[label] = (found_keys(res.founds), stamps, launches, res.candidates_tried)
        print(f"{phase} {label}: accepted with {len(res.founds)}/5 ({RULES_UNIT_RULES} rules x "
              f"{RBASE_UNIT_WORDS} base words); K1 launches {launches}; hit/miss blocks "
              f"{cache_blocks(reg)}; pass-2 gunzip passes {opened}; rules:expand {len(spans)} "
              f"spans, {sum(spans):.3f} s in all; run() {wall:.3f} s [{card}]", flush=True)
        report_unit(client, reg, label, unit_pmk_s, card, phase)
    check(runs["cold"] == runs["warm"],
          "11d: warm founds, stamps, K1 launches or candidates differ from cold")
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)
    return total


def server_rows(db):
    """The ``nets`` and ``rkg`` rows, without the columns stamped with
    the wall clock (the two legs of a sweep run at different times)."""
    out = {}
    for table in ("nets", "rkg"):
        cols = [r[1] for r in db.conn.execute(f"PRAGMA table_info({table})")
                if r[1] not in ("ts", "sts")]
        out[table] = [tuple(r) for r in db.conn.execute(
            f"SELECT {', '.join(cols)} FROM {table} ORDER BY rowid")]
    return out


def check_pmks(batcher, pairs, what):
    """Every pair's PMK in the batcher's memo equals hashlib's."""
    for essid, word in pairs:
        check(batcher.pmk(essid, word) == hashlib.pbkdf2_hmac("sha1", word, essid, 4096, 32),
              f"{what}: PMK of {word!r} under {essid!r} != hashlib")


def phase_precrack_batcher(dev, rng, card):
    """12a: the server's ``PmkBatcher`` on the card.  Returns (K1 launches
    of the prewarms, ms per 2048-lane launch, PMKs derived, derive s)."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.sched.fuse import pack_salted_lanes
    from dwpa_tpu_torch.server.core import SERVER_NC
    from dwpa_tpu_torch.server.precrack import PmkBatcher, verify_batch

    essids = [b"precrack-essid-%d" % i for i in range(PRECRACK_ESSIDS)]
    pairs = [(e, w) for e in essids
             for w in random_words(rng, PRECRACK_ESSID_WORDS, 8, 63)]
    odd = [(essids[0], b"short"), (essids[1], b"x" * 70), (essids[2], b"")]
    shapes = []
    real_kernel = m.pmk_kernel

    def kernel_spy(pw, s1, s2, *args, **kwargs):
        shapes.append(tuple(pw.shape))
        return real_kernel(pw, s1, s2, *args, **kwargs)

    m.pmk_kernel = kernel_spy
    launches = 0
    derived = derive_s = 0.0
    try:
        batcher = PmkBatcher(device="auto")
        check(batcher.device_enabled() and batcher._dev == dev, f"batcher on {batcher._dev}")
        pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
        t0 = time.perf_counter()
        stats = batcher.prewarm(pairs + pairs[:500] + odd)
        derive_s += time.perf_counter() - t0
        derived += stats["derived"]
        waves = -(-len(pairs) // batcher.batch)
        check(pbkdf2_cuda.LAUNCHES == waves and pbkdf2.CALLS == 0,
              f"12a: {pbkdf2_cuda.LAUNCHES} K1 launches for {waves} waves")
        check(stats["unique"] == len(pairs) + len(odd), f"12a stats {stats}")
        launches += pbkdf2_cuda.LAUNCHES
        sample = [pairs[i] for i in rng.choice(len(pairs), PRECRACK_SAMPLE, replace=False)]
        check_pmks(batcher, sample + odd, "12a mixed set")
        mixed_shapes = list(shapes)
        widths = {}
        for n in (200, 900, 2048):   # one set for each fused width: 256, 1024, 2048
            shapes.clear()
            one = PmkBatcher(device="auto")
            sub = [(essids[i % PRECRACK_ESSIDS], w) for i, w in
                   enumerate(random_words(rng, n, 8, 63))]
            pbkdf2_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            stats = one.prewarm(sub)
            derive_s += time.perf_counter() - t0
            derived += stats["derived"]
            check(pbkdf2_cuda.LAUNCHES == 1, f"12a {n} lanes: {pbkdf2_cuda.LAUNCHES} launches")
            launches += 1
            widths[n] = shapes[0]
            check_pmks(one, sub[:64] + sub[-64:], f"12a {n} lanes")
        check([w[0] for w in widths.values()] == [256, 1024, 2048], f"12a widths {widths}")
    finally:
        m.pmk_kernel = real_kernel

    # two threads deriving at once (the ingest pre-crack beside the cron job)
    sets = [[(b"thread-%d-essid" % t, w) for w in random_words(rng, 3000, 8, 40)]
            for t in range(2)]
    batchers = [PmkBatcher(device="auto") for _ in sets]
    barrier = threading.Barrier(2)
    errors = []

    def derive_in_thread(b, ps):
        try:
            barrier.wait()
            b.prewarm(ps)
            torch.cuda.synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    pbkdf2_cuda.LAUNCHES = 0
    threads = [threading.Thread(target=derive_in_thread, args=(b, ps)) for b, ps in zip(batchers, sets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"12a concurrent derives raised {errors}")
    launches += pbkdf2_cuda.LAUNCHES
    for b, ps in zip(batchers, sets):
        check_pmks(b, ps[:128] + ps[-128:], "12a concurrent")

    psk, essid = b"precrack-verify-psk", b"PrecrackVerifyNet"
    items = [
        (tfx.make_pmkid_line(psk, essid, seed="12a-p"), [b"wrong-pmkid-1", psk], None),
        (tfx.make_pmkid_line(psk, b"OtherEssid12a", seed="12a-p2"), [b"wrong-pmkid-2"], None),
        (tfx.make_eapol_line(psk, essid, keyver=1, seed="12a-1"), [psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=2, seed="12a-2"), [b"wrong-two-2", psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=2, nc_delta=-2, endian="BE", seed="12a-n"),
         [psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=3, seed="12a-3"), [psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=3, seed="12a-3m"), [b"wrong-three3"], None),
        (tfx.make_eapol_line(psk, essid, keyver=2, seed="12a-i"), [psk],
         hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32)),
    ]
    pbkdf2_cuda.LAUNCHES = 0
    on_card = verify_batch(items, nc=SERVER_NC, batcher=PmkBatcher(device="auto"))
    launches += pbkdf2_cuda.LAUNCHES
    on_host = verify_batch(items, nc=SERVER_NC, batcher=PmkBatcher(device="off"))
    check(on_card == on_host, f"12a verify_batch card {on_card} != host {on_host}")
    check([r is not None for r in on_card] == [True, False, True, True, True, True, False, True],
          f"12a verdicts {on_card}")
    check(on_card[4][1:3] == (-2, "BE"), f"12a NC verdict {on_card[4]}")

    # K1 per pre-crack launch at each fused width (not a main-path launch)
    times = {}
    for n in (256, 1024, 2048):
        rows, s1, s2, _ = pack_salted_lanes(pairs[:n], 2048, 1)
        args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
                for a in (rows, s1, s2)]
        times[n] = cuda_ms(lambda: pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(*args), 5)
    print(f"phase 12a batcher: {len(pairs)} pairs over {PRECRACK_ESSIDS} ESSIDs (+500 "
          f"repeats, {len(odd)} out-of-range words) in {waves} waves, K1 launches = waves, "
          f"shapes {mixed_shapes}; one set per fused width {widths}; {PRECRACK_SAMPLE} sampled "
          f"PMKs and every out-of-range one = hashlib; two threads deriving at once exact; "
          f"verify_batch on the card = host over PMKID, keyver 1/2/3, NC and injected-PMK "
          f"items {[r and r[1:3] for r in on_card]}; K1 ms per pre-crack launch (CUDA events, "
          f"median of 5): {times} [{card}]", flush=True)
    return launches, times[2048], derived, derive_s


def fleet_net(i, essid, psk, mac_ap=None, keyver=None):
    from dwpa_tpu_torch import testing as tfx

    seed = "12b-%04d" % i
    if keyver is None:
        return tfx.make_pmkid_line(psk, essid, seed=seed, mac_ap=mac_ap)
    return tfx.make_eapol_line(psk, essid, keyver=keyver, seed=seed, mac_ap=mac_ap)


def precrack_fleet(rng):
    """12b's database content: (lines, cracked {line: psk}, processed
    lines, expected {essid: algo} of the nets the sweep must crack)."""
    from dwpa_tpu_torch.gen import vendors
    from dwpa_tpu_torch.gen.psktool import psk_candidates
    from dwpa_tpu_torch.server.jobs import single_mode_candidates

    corpus = random_words(rng, PRECRACK_CORPUS_PSKS, 10, 16)
    lines, cracked, expected = [], {}, {}
    for i in range(PRECRACK_PROCESSED):
        essid = b"FleetNet-%04d" % i
        psk = corpus[i % len(corpus)] if i < PRECRACK_CRACKED else random_words(rng, 1, 12, 20)[0]
        line = fleet_net(i, essid, psk)
        lines.append(line)
        if i < PRECRACK_CRACKED:
            cracked[line] = psk
    processed = list(lines)

    def mac(j):
        return bytes([0x00, 0x1a, 0x2b, 0x3c, j // 256, j % 256])

    def plant(j, essid, algo, psk, keyver=None):
        lines.append(fleet_net(10_000 + j, essid, psk, mac_ap=mac(j), keyver=keyver))
        if algo:
            expected[essid] = algo

    j = 0
    for k in range(4):   # EasyBox: two hits, two misses
        essid = b"EasyBox-%06X" % (0x100000 + k)
        plant(j, essid, "EasyBox" if k < 2 else None,
              list(vendors.easybox_keys(mac(j)))[k % 2] if k < 2 else b"easybox-miss-%d" % k)
        j += 1
    for essid, fn, algo in ((b"belkin.3c4d", vendors.belkin_keys, "Belkin"),
                            (b"SKY12345", vendors.sky_keys, "Sky"),
                            (b"Tenda_3C4D5E", vendors.mac_tail_keys, "MacTail")):
        plant(j, essid, algo, list(fn(mac(j)))[0])
        j += 1
    imei = list(vendors.imei_hotspot_keys())
    for k in range(3):   # IMEI: two hits, one miss
        plant(j, b"AndroidAP-%02d" % k, "IMEI" if k < 2 else None,
              imei[17 + 60 * k] if k < 2 else b"imei-miss-psk")
        j += 1
    for k, keyver in enumerate((1, 2)):   # Single, on EAPOL nets
        essid = b"HomeFleet%02d" % k
        plant(j, essid, "Single", essid.lower() + b"1", keyver=keyver)
        j += 1
    essid = b"PatternFleet"
    single = set(single_mode_candidates(mac(j), essid))
    pattern = next(c for c in psk_candidates(essid, mac(j)) if c not in single and len(c) >= 8)
    plant(j, essid, "Pattern", pattern)
    j += 1
    plant(j, b"FleetNet-0007", "Replay", cracked[processed[7]])   # a cracked sibling's ESSID
    j += 1
    plant(j, b"CorpusFleet", "Dict", corpus[3])   # cracked 3 times: in the top 64
    j += 1
    while j < PRECRACK_UNPROCESSED:   # misses: vendor-shaped and plain ESSIDs
        essid = (b"EasyBox-%06X" % (0x200000 + j) if j % 3 == 0 else
                 b"Tenda_%06X" % j if j % 3 == 1 else b"PlainFleet-%03d" % j)
        plant(j, essid, None, random_words(rng, 1, 12, 24)[0])
        j += 1
    return lines, cracked, processed, expected


def build_precrack_db(path, rng):
    """A port-server database of ``PRECRACK_PROCESSED`` processed nets
    (``PRECRACK_CRACKED`` of them cracked) and ``PRECRACK_UNPROCESSED``
    fresh ones.  Returns the expected {essid: algo}."""
    from dwpa_tpu_torch.oracle import m22000 as oracle
    from dwpa_tpu_torch.server import Database, ServerCore

    lines, cracked, processed, expected = precrack_fleet(rng)
    core = ServerCore(Database(str(path)))
    report = core.add_hashlines(lines)
    check(report["new"] == len(lines), f"12b ingest {report}")
    with core.db.tx():
        for line in processed:
            row = core.db.q1("SELECT net_id, ssid FROM nets WHERE struct = ?", (line,))
            psk = cracked.get(line)
            if psk is None:
                core.db.x("UPDATE nets SET algo = '' WHERE net_id = ?", (row["net_id"],))
            else:
                core.db.x("UPDATE nets SET pass = ?, pmk = ?, n_state = 1, algo = 'Manual' "
                          "WHERE net_id = ?", (psk, oracle.pmk_from_psk(psk, row["ssid"]),
                                               row["net_id"]))
    core.db.close()
    return expected


def timed_sweep(path, dictdir, batch, device):
    """``jobs.precrack`` at the server's defaults on a copy of the 12b
    database; its seconds split into collect, derive (``prewarm``) and
    the per-net demux, timed from outside the engine."""
    import torch

    from dwpa_tpu_torch.server import Database, ServerCore, jobs
    from dwpa_tpu_torch.server.precrack import PrecrackEngine

    core = ServerCore(Database(str(path)), dictdir=str(dictdir))
    eng = core.precrack = PrecrackEngine(core, batch=batch, device=device,
                                         dict_limit=PRECRACK_DICT_LIMIT)
    t = {"collect": 0.0, "derive": 0.0}
    derive_stats, lanes = [], []
    real_collect, real_prewarm = eng._collect, eng.batcher.prewarm
    real_derive = eng.batcher._derive_device

    def counted_derive(items):
        lanes.append(len(items))
        return real_derive(items)

    def timed_collect(*args):
        t0 = time.perf_counter()
        out = real_collect(*args)
        t["collect"] += time.perf_counter() - t0
        return out

    def timed_prewarm(pairs):
        t0 = time.perf_counter()
        out = real_prewarm(pairs)
        t["derive"] += time.perf_counter() - t0
        derive_stats.append(out)
        return out

    eng._collect, eng.batcher.prewarm = timed_collect, timed_prewarm
    eng.batcher._derive_device = counted_derive
    t0 = time.perf_counter()
    out = jobs.precrack(core, limit=PRECRACK_LIMIT, batch=batch, device=device,
                        dict_limit=PRECRACK_DICT_LIMIT)
    if device != "off":
        torch.cuda.synchronize()
    t["sweep"] = time.perf_counter() - t0
    t["demux"] = t["sweep"] - t["collect"] - t["derive"]
    rows = server_rows(core.db)
    cracked = {r["ssid"]: r["algo"] for r in core.db.q(
        "SELECT ssid, algo FROM nets WHERE n_state = 1 AND algo != 'Manual'")}
    core.db.close()
    waves = sum(-(-n // batch) for n in lanes)
    return out, t, derive_stats[0], rows, cracked, eng.batcher, waves


def phase_precrack_sweep(rng, card):
    """12b: the pre-crack sweep at the server's defaults on the card,
    against the host on the same database.  Returns K1's launches."""
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    root = CLIENT_DIR / "precrack"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    expected = build_precrack_db(root / "fleet.db", rng)
    build_s = time.perf_counter() - t0
    legs = {}
    launches = 0
    for label, batch, device in (("card", PRECRACK_BATCH, "auto"), ("host", PRECRACK_BATCH, "off"),
                                 ("card131072", UNIT_BATCH, "auto")):
        path = root / f"{label}.db"
        shutil.copy(root / "fleet.db", path)
        pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
        out, t, stats, rows, cracked, batcher, waves = timed_sweep(path, root / label, batch,
                                                                   device)
        legs[label] = (out, t, stats, rows, cracked, pbkdf2_cuda.LAUNCHES)
        check(pbkdf2.CALLS == 0, f"12b {label}: the plain PBKDF2 ran")
        if device == "off":
            check(pbkdf2_cuda.LAUNCHES == 0, "12b host leg launched K1")
        else:
            check(waves > 0 and pbkdf2_cuda.LAUNCHES == waves, f"12b {label}: {pbkdf2_cuda.LAUNCHES} launches "
                  f"for {waves} waves")
            launches += pbkdf2_cuda.LAUNCHES
            pairs = list(batcher._memo)
            sample = [pairs[i] for i in rng.choice(len(pairs), PRECRACK_SAMPLE, replace=False)]
            check_pmks(batcher, sample, f"12b {label}")
        check(cracked == expected, f"12b {label}: cracked {cracked}, planted {expected}")
        check(out["processed"] == PRECRACK_UNPROCESSED, f"12b {label}: {out}")
    host = legs["host"]
    for label in ("card", "card131072"):
        check(legs[label][3] == host[3], f"12b {label}: nets/rkg rows differ from the host leg")
        check(legs[label][0] == host[0], f"12b {label}: {legs[label][0]} != host {host[0]}")
    for label, (out, t, stats, rows, cracked, n) in legs.items():
        rate = stats["derived"] / t["derive"] if t["derive"] else 0.0
        print(f"phase 12b {label} (batch {PRECRACK_BATCH if label != 'card131072' else UNIT_BATCH}"
              f"): {out['processed']} nets, {out['candidates']} candidates "
              f"({stats['unique']} unique pairs, {stats['derived']} derived, fill "
              f"{stats['fill']:.4f}), {out['cracked']} cracked; K1 launches {n}; derive "
              f"{rate:.1f} PMK/s; sweep {t['sweep']:.3f} s = collect {t['collect']:.3f} + "
              f"derive {t['derive']:.3f} + demux {t['demux']:.3f} [{card}]", flush=True)
    print(f"phase 12b: database of {PRECRACK_PROCESSED + PRECRACK_UNPROCESSED} nets built in "
          f"{build_s:.1f} s; nets and rkg rows of both card legs = the host leg's "
          f"({len(host[3]['nets'])} nets, {len(host[3]['rkg'])} rkg rows); cracked = planted "
          f"{sorted(expected.values())} [{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_server_system(rng, card):
    """12c: the port's server on 127.0.0.1 with the ingest pre-crack on the
    card and the cron layer's pre-crack on a second thread, a capture
    POSTed, and ``TpuCrackClient.run()`` cracking it over HTTP.  Returns
    K1's launches."""
    import socketserver
    import urllib.request
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.server import Database, ServerCore, jobs, make_wsgi_app
    from dwpa_tpu_torch.server.__main__ import _start_materializer
    from dwpa_tpu_torch.server.precrack import PrecrackEngine

    root = CLIENT_DIR / "server"
    shutil.rmtree(root, ignore_errors=True)
    (root / "dicts").mkdir(parents=True)
    db = str(root / "wpa.db")
    serve_core = ServerCore(Database(db), dictdir=str(root / "dicts"), capdir=str(root / "caps"))
    # nets for the cron thread: each cracked by its Single candidate
    serve_core.add_hashlines([fleet_net(20_000 + i, b"CronFleet%02d" % i,
                                        b"cronfleet%02d1" % i) for i in range(SERVER_CRON_NETS)])
    words = random_words(rng, SERVER_DICT_WORDS - 1, 8, 16)
    words.insert(SERVER_DICT_WORDS // 2, SERVER_PSK)
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    (root / "dicts" / "server12c.txt.gz").write_bytes(blob)
    serve_core.add_dict("dict/server12c.txt.gz", "server12c.txt.gz",
                        hashlib.md5(blob).hexdigest(), len(words))
    serve_core.precrack = PrecrackEngine(serve_core, batch=PRECRACK_BATCH, device="auto",
                                         dict_limit=PRECRACK_DICT_LIMIT)
    verified = []
    real_prewarm = serve_core.verifier.prewarm
    serve_core.verifier.prewarm = lambda pairs: (verified.extend(pairs), real_prewarm(pairs))[1]

    class Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class Handler(WSGIRequestHandler):
        def log_message(self, *args):   # no line per request
            pass

    srv = make_server("127.0.0.1", 0, make_wsgi_app(serve_core), server_class=Server,
                      handler_class=Handler)
    url = f"http://127.0.0.1:{srv.server_port}/"
    serving = threading.Thread(target=srv.serve_forever, name="dwpa-serve", daemon=True)
    mat = None
    cron_out, errors = [], []
    jobs_core = ServerCore(Database(db), dictdir=str(root / "dicts"), capdir=str(root / "caps"))

    def cron_precrack():
        try:
            cron_out.append(jobs.precrack(jobs_core, limit=PRECRACK_LIMIT, batch=PRECRACK_BATCH,
                                          device="auto", dict_limit=PRECRACK_DICT_LIMIT))
        except Exception as e:  # reported below
            errors.append(e)

    cap, _ = tfx.make_handshake_capture(SERVER_PSK, SERVER_ESSID, seed="12c")
    pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
    try:
        serving.start()
        mat = _start_materializer(serve_core)
        cron_thread = threading.Thread(target=cron_precrack, name="dwpa-cron")
        cron_thread.start()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(url, data=cap), timeout=120) as r:
            ingest = json.loads(r.read())
        ingest_s = time.perf_counter() - t0
        cron_thread.join()
        check(not errors, f"12c cron pre-crack raised {errors}")
        check(ingest["new"] == 2, f"12c ingest {ingest}")
        rows = serve_core.db.q("SELECT algo, n_state FROM nets WHERE ssid = ?", (SERVER_ESSID,))
        check([(r["algo"], r["n_state"]) for r in rows] == [("", 0)] * 2,
              f"12c capture nets after the ingest pre-crack: {[tuple(r) for r in rows]}")
        check(serve_core.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1 "
                               "AND algo = 'Single'")["c"] == SERVER_CRON_NETS,
              "12c the cron pre-crack did not crack its fleet")
        precrack_launches = pbkdf2_cuda.LAUNCHES
        for eng in (serve_core.precrack, jobs_core.precrack):
            pairs = list(eng.batcher._memo)
            pick = rng.choice(len(pairs), min(128, len(pairs)), replace=False)
            check_pmks(eng.batcher, [pairs[i] for i in pick], "12c pre-crack")
        reg = MetricsRegistry()
        client = TpuCrackClient(
            ClientConfig(base_url=url, workdir=str(root / "client"), device="cuda:0",
                         max_work_units=1),
            registry=reg, log=lambda msg: print(f"phase 12c client: {msg}", flush=True))
        t0 = time.perf_counter()
        done = client.run()
        run_s = time.perf_counter() - t0
    finally:
        if serving.is_alive():
            srv.shutdown()
            serving.join(timeout=10)
        srv.server_close()
        if mat is not None:
            mat[1].set()
            mat[0].join(timeout=5)
    check(pbkdf2.CALLS == 0, "12c ran the plain PBKDF2")
    res = client.last_result
    check(done == 1 and res.accepted, f"12c unit not accepted ({done}, {res})")
    check(sorted(f.psk for f in res.founds) == [SERVER_PSK] * 2, f"12c founds {res.founds}")
    check(sum(1 for e, w in verified if (e, w) == (SERVER_ESSID, SERVER_PSK)) >= 1,
          "12c put_work never re-verified the PSK")
    rows = serve_core.db.q('SELECT n_state, "pass" FROM nets WHERE ssid = ?', (SERVER_ESSID,))
    check(all(r["n_state"] == 1 and r["pass"] == SERVER_PSK for r in rows) and len(rows) == 2,
          f"12c nets {[tuple(r) for r in rows]}")
    leases = serve_core.db.q("SELECT state FROM leases")
    check(leases and all(r["state"] == 1 for r in leases), f"12c leases {[tuple(r) for r in leases]}")
    check(serve_core.db.q1("SELECT COUNT(*) c FROM n2d WHERE hkey IS NOT NULL")["c"] == 0,
          "12c lease rows still held")
    p2 = reg.value("dwpa_client_pmk_per_s", **{"pass": "2"})
    launches = pbkdf2_cuda.LAUNCHES
    print(f"phase 12c system: capture POSTed to {url} ({ingest}) in {ingest_s:.3f} s beside the "
          f"cron pre-crack ({cron_out[0]}); pre-crack K1 launches {precrack_launches}; run() "
          f"{run_s:.3f} s, unit accepted, {len(res.founds)}/2 nets cracked, put_work verified "
          f"{len(verified)} pairs, lease released; pass-2 {p2 or 0.0:.1f} PMK/s over "
          f"{res.candidates_tried} candidates; K1 launches in all {launches} [{card}]", flush=True)
    for c in (serve_core, jobs_core):
        c.db.close()
    shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_server(dev, rng, card):
    """Phase 12: the server's pre-crack on the card, then the whole system.
    Returns (K1 launches of phase 12, K1 ms per 2048-lane launch)."""
    t12 = time.perf_counter()
    launches, ms_2048, _, _ = phase_precrack_batcher(dev, rng, card)
    launches += phase_precrack_sweep(rng, card)
    launches += phase_server_system(rng, card)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s; server-path K1 launches {launches} "
          f"[{card}]", flush=True)
    return launches, ms_2048


def spy_thomson():
    """Wrap the Thomson sweep so a run can show which device it took;
    returns (the device list, a restore callable)."""
    from dwpa_tpu_torch.gen import vendors
    from dwpa_tpu_torch.parallel.device import resolve_device

    real = vendors._thomson_search_device
    devices = []

    def spied_sweep(target, years, weeks, chunk=1 << 20, compress=None, device=None):
        devices.append(resolve_device(device))
        return real(target, years, weeks, chunk=chunk, compress=compress, device=device)

    vendors._thomson_search_device = spied_sweep
    return devices, lambda: setattr(vendors, "_thomson_search_device", real)


def thomson_plant(yy, ww, code):
    """(SSID suffix, key) of one serial of the Thomson scheme."""
    from dwpa_tpu_torch.gen import vendors

    return vendors.thomson_key(vendors._thomson_serial(yy, ww, code))


def phase_thomson_sweep(dev, card):
    """13a: the full default serial space swept on the card through the
    entry points the server calls, at two chunk sizes; one year against
    the hashlib search; ``vendor_candidates`` with no budget."""
    import torch

    from dwpa_tpu_torch.gen import vendors

    sfx, key = thomson_plant(*THOMSON_SERIAL)
    years, weeks = list(THOMSON_YEARS), list(THOMSON_WEEKS)
    total = len(years) * len(weeks) * 36 ** 3
    devices, restore = spy_thomson()
    sweeps = {}
    year = THOMSON_SERIAL[0]
    try:
        # one year on the card against hashlib first: it also warms the sweep
        t0 = time.perf_counter()
        on_card = list(vendors.thomson_candidates(sfx, years=[year], weeks=weeks))
        year_card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_host = list(vendors.thomson_candidates(sfx, years=[year], weeks=weeks, device=False))
        year_host_s = time.perf_counter() - t0
        check(on_card == on_host and key in on_card,
              f"13a: one-year sweep {on_card} != hashlib {on_host}")
        for chunk in THOMSON_CHUNKS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if chunk == 1 << 20:   # the default chunk, through the default route
                keys = list(vendors.thomson_candidates(sfx))
            else:
                keys = list(vendors._thomson_search_device(sfx, years, weeks, chunk=chunk,
                                                           device=dev))
            torch.cuda.synchronize()
            sweeps[chunk] = (time.perf_counter() - t0, keys)
        check(devices == [dev] * (1 + len(THOMSON_CHUNKS)), f"13a: the sweeps took {devices}")
        check(key in sweeps[1 << 20][1], f"13a: planted key {key} not in {sweeps[1 << 20][1]}")
        check(all(s[1] == sweeps[1 << 20][1] for s in sweeps.values()),
              "13a: the sweeps at two chunk sizes differ")
        pairs = list(vendors.vendor_candidates(bytes.fromhex("00147f010203"),
                                               b"SpeedTouch" + sfx.encode()))
        check(("Thomson", key) in pairs and devices[-1] == dev,
              f"13a: vendor_candidates without a budget gave {pairs[:4]}")
    finally:
        restore()
    rates = {c: total / s for c, (s, _) in sweeps.items()}
    print(f"phase 13a thomson: {total} serials (years {years[0]}-{years[-1]}, weeks "
          f"{weeks[0]}-{weeks[-1]}) swept on {dev} for suffix {sfx}: "
          + "; ".join(f"chunk {c}: {s:.3f} s = {rates[c]:.1f} serials/s, {len(k)} keys"
                      for c, (s, k) in sweeps.items())
          + f"; planted key {key.decode()} found; one year ({len(weeks) * 36 ** 3} serials, "
          f"the first sweep) on {dev} {year_card_s:.3f} s = hashlib {year_host_s:.3f} s, list "
          f"for list ({len(on_card)} keys); vendor_candidates swept by default on {dev} [{card}]",
          flush=True)


def phase_thomson_precrack(card, device="auto"):
    """13b: one ``jobs.precrack`` sweep at the server's defaults on a fresh
    database of Thomson-shaped and plain nets; exactly the nets whose PSK
    is a planted Thomson key are cracked.  Returns K1's launches."""
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.server import Database, ServerCore

    root = CLIENT_DIR / "thomson"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    lines, expected = [], {}
    for j, (prefix, serial) in enumerate(THOMSON_NETS):
        if serial is None:   # Thomson-shaped SSID, PSK no serial gives
            essid, psk = prefix + b"%06X" % (0xA10000 + j), b"not-a-thomson-%d" % j
        else:
            sfx, psk = thomson_plant(*serial)
            essid = prefix + sfx.encode()
            expected[essid] = "Thomson"
        lines.append(fleet_net(30_000 + j, essid, psk, mac_ap=bytes([0, 0x14, 0x7f, 0, 0, j])))
    for j in range(THOMSON_PLAIN_NETS):
        lines.append(fleet_net(31_000 + j, b"PlainThomsonRun-%02d" % j, b"plain-miss-%04d" % j))
    core = ServerCore(Database(str(root / "thomson.db")))
    check(core.add_hashlines(lines)["new"] == len(lines), "13b ingest")
    core.db.close()
    devices, restore = spy_thomson()
    pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
    try:
        out, t, stats, rows, cracked, batcher, waves = timed_sweep(
            root / "thomson.db", root / "dicts", PRECRACK_BATCH, device)
    finally:
        restore()
    launches = pbkdf2_cuda.LAUNCHES
    check(cracked == expected, f"13b: cracked {cracked}, planted {expected}")
    check(len(devices) == len(THOMSON_NETS), f"13b: {len(devices)} Thomson sweeps")
    check(pbkdf2.CALLS == 0 and waves > 0 and launches == (waves if device == "auto" else 0),
          f"13b: {launches} K1 launches for {waves} waves, plain PBKDF2 {pbkdf2.CALLS}")
    check(out["processed"] == len(lines) and out["cracked"] == len(expected), f"13b: {out}")
    check_pmks(batcher, list(batcher._memo)[:PRECRACK_SAMPLE], "13b")
    rate = stats["derived"] / t["derive"] if t["derive"] else 0.0
    print(f"phase 13b thomson precrack (batch {PRECRACK_BATCH}, limit {PRECRACK_LIMIT}, dict "
          f"limit {PRECRACK_DICT_LIMIT}): {out['processed']} nets ({len(THOMSON_NETS)} "
          f"Thomson-shaped, {len(expected)} planted), {out['candidates']} candidates "
          f"({stats['unique']} unique pairs), cracked = planted {sorted(expected)}; Thomson "
          f"sweeps {len(devices)} on {sorted(set(map(str, devices)))}; K1 launches {launches}; "
          f"derive {rate:.1f} PMK/s; sweep {t['sweep']:.3f} s = collect {t['collect']:.3f} + "
          f"derive {t['derive']:.3f} + demux {t['demux']:.3f} [{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return launches


def chaos_server(root, lines, words):
    """The port's server core over a fresh in-memory database holding
    ``lines`` and one dict of ``words``."""
    from dwpa_tpu_torch.server import Database, ServerCore

    core = ServerCore(Database(":memory:"), dictdir=str(root / "dicts"), capdir=str(root / "caps"))
    core.add_hashlines(lines)
    core.db.x("UPDATE nets SET algo = ''")
    (root / "dicts").mkdir(parents=True, exist_ok=True)
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    (root / "dicts" / "chaos13c.txt.gz").write_bytes(blob)
    core.add_dict("dict/chaos13c.txt.gz", "chaos13c.txt.gz", hashlib.md5(blob).hexdigest(),
                  len(words))
    return core


def chaos_leg(root, lines, words, plan, label, device):
    """One ``TpuCrackClient.run()`` of the unit against the port's server
    through ``ChaosTransport(WsgiTransport(...), plan)`` on a virtual
    clock, then outbox drains until nothing is pending.  Returns
    (client, server core, registry, drains, seconds)."""
    import random

    from dwpa_tpu_torch.chaos import ChaosTransport, VirtualClock, WsgiTransport
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.client.protocol import CircuitBreaker, ServerAPI
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.server import make_wsgi_app

    core = chaos_server(root / label, lines, words)
    clock = VirtualClock()
    api = ServerAPI("http://loopback/", max_tries=0, backoff=0.5, rng=random.Random(SEED),
                    sleep=clock.sleep,
                    breaker=CircuitBreaker(threshold=3, cooldown=4.0, clock=clock.now))
    api.retry.clock = clock.now
    api._transport = ChaosTransport(WsgiTransport(make_wsgi_app(core)), plan, sleep=clock.sleep)
    reg = MetricsRegistry()
    client = TpuCrackClient(
        ClientConfig(base_url="http://loopback/", workdir=str(root / label / "client"),
                     batch_size=UNIT_BATCH, max_work_units=1, device=device),
        api=api, registry=reg, log=lambda msg: print(f"phase 13c {label} client: {msg}", flush=True))
    t0 = time.perf_counter()
    check(client.run() == 1, f"13c {label}: run() did not complete the unit")
    drains = 0
    while client.outbox.pending_count() and drains < 10:
        drains += 1
        clock.sleep(api.breaker.cooldown)
        try:
            client._drain_outbox()
        except ConnectionError:
            continue
    return client, core, reg, drains, time.perf_counter() - t0


def phase_chaos_soak(card, device="cuda:0"):
    """13c: phase 6's unit (five nets, a 131072-word dict) cracked by the
    port's client against the port's server, fault-free and under a
    seeded fault schedule; the same founds, rows and resume state.
    Returns K1's launches of the chaos leg."""
    from dwpa_tpu_torch.chaos import FaultPlan, sweep_invariants
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    root = CLIENT_DIR / "chaos"
    shutil.rmtree(root, ignore_errors=True)
    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    words = random_words(np.random.default_rng(SEED + 13), CHAOS_DICT_WORDS - 1, 8, 20)
    words.insert(CHAOS_DICT_WORDS // 3, PSK)

    def make_plan():
        return (FaultPlan(SEED, rate=CHAOS_RATE, kinds=CHAOS_KINDS)
                .force("get_work", "timeout").force("get_work", "http_5xx")
                .force("put_work", "truncate").force("put_work", "reject"))

    def outcome(client, core):
        res = client.last_result
        return (sorted((f.line.raw, f.psk, f.nc, f.endian) for f in res.founds),
                sorted(tuple(r) for r in core.db.q('SELECT struct, n_state, "pass", algo FROM nets')),
                core.db.q1("SELECT COUNT(*) c FROM n2d WHERE hkey IS NOT NULL")["c"],
                sorted(r["state"] for r in core.db.q("SELECT state FROM leases")),
                Path(client.resume_path).exists(), client.outbox.pending_count(),
                res.candidates_tried)

    legs = {}
    for label, plan in (("fault-free", FaultPlan(SEED)), ("chaos", make_plan())):
        pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
        client, core, reg, drains, secs = chaos_leg(root, raw, words, plan, label, device)
        legs[label] = (outcome(client, core), plan, reg, drains, secs, pbkdf2_cuda.LAUNCHES)
        check(pbkdf2.CALLS == 0 or device == "cpu", f"13c {label}: the plain PBKDF2 ran")
        check_founds(client.last_result.founds, lines, f"13c {label}")
        check(sweep_invariants(core.db) == [], f"13c {label}: {sweep_invariants(core.db)}")
        core.db.close()
    clean, chaos = legs["fault-free"], legs["chaos"]
    check(chaos[0] == clean[0], f"13c: chaos outcome {chaos[0][1:]} != fault-free {clean[0][1:]}")
    check(clean[0][2:6] == (0, [1], False, 0), f"13c: rows/resume state {clean[0][2:6]}")
    plan = chaos[1]
    check({"timeout", "http_5xx", "truncate", "reject"} <= plan.kinds_injected(),
          f"13c: injected {plan.kinds_injected()}")
    check(not clean[1].kinds_injected(), "13c: the fault-free plan injected a fault")
    replay = make_plan()
    for _, endpoint, _ in plan.schedule():
        replay.next_fault(endpoint)
    check(replay.schedule() == plan.schedule(), "13c: the seed did not replay its schedule")
    kinds = collections.Counter(k for _, _, k in plan.schedule() if k)
    retries = sum(s["value"] for s in chaos[2].snapshot().get("dwpa_client_retries_total", {})
                  .get("samples", ()))
    print(f"phase 13c chaos soak: {len(lines)} nets, {CHAOS_DICT_WORDS}-word dict, batch "
          f"{UNIT_BATCH}, on {device}; fault-free run() {clean[4]:.3f} s, K1 launches {clean[5]}; "
          f"chaos (seed {SEED}, rate {CHAOS_RATE}) run() + {chaos[3]} outbox drains "
          f"{chaos[4]:.3f} s, {len(plan.schedule())} transport calls, faults by kind "
          f"{dict(kinds)}, retries {retries:.0f}, K1 launches {chaos[5]}; founds "
          f"{len(chaos[0][0])}/5, nets rows, n2d, leases and resume state equal to the "
          f"fault-free run; the seed replays its schedule [{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return chaos[5]


def server_cli(argv):
    """``python -m dwpa_tpu_torch.server <argv>`` in process; returns its
    JSON output and seconds."""
    import contextlib
    import io

    from dwpa_tpu_torch.server.__main__ import main as server_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        server_main([str(a) for a in argv])
    return json.loads(out.getvalue()), time.perf_counter() - t0


def phase_operator_tools(card, device="cuda:0"):
    """13d: the operator tools through the server CLI on a copy of phase
    12's 1,000-net database: recrack, pack-dict, dedup-dicts, fill-pr
    with the native parser (held to the Python parser on the same
    capture corpus), pack-client and the client's update check."""
    import io
    import urllib.parse

    from dwpa_tpu_torch import native
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.chaos import WsgiTransport
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.client.protocol import ServerAPI
    from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app, tools
    from dwpa_tpu_torch.server.capture import extract_hashlines

    root = CLIENT_DIR / "tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    db = root / "fleet.db"
    t0 = time.perf_counter()
    build_precrack_db(db, np.random.default_rng(SEED + 12))
    build_s = time.perf_counter() - t0
    captures = []
    core = ServerCore(Database(str(db)), capdir=str(root / "caps"))
    for i in range(TOOLS_CAPTURES):
        blob, _ = tfx.make_handshake_capture(b"tools-psk-%04d" % i, b"ToolsNet-%04d" % i,
                                             seed=f"13d-{i}", probes=(b"Probe-%d" % i, b"Cafe"))
        captures.append(blob)
        core.add_hashlines(extract_hashlines(blob)[0], s_id=core.add_submission(blob))
    core.db.close()
    common = ["--db", db, "--dictdir", root / "dicts", "--capdir", root / "caps"]

    recrack, recrack_s = server_cli(["recrack", *common])
    check(recrack == {"checked": PRECRACK_CRACKED}, f"13d recrack {recrack}")
    words = random_words(np.random.default_rng(SEED + 14), TOOLS_DICT_WORDS, 8, 20)
    (root / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    packed, pack_s = server_cli(["pack-dict", *common, root / "words.txt", "--name", "tools13d"])
    gz = root / "dicts" / "tools13d.txt.gz"
    check(packed["dhash"] == hashlib.md5(gz.read_bytes()).hexdigest()
          and packed["wcount"] == len(words), f"13d pack-dict {packed}")
    half = TOOLS_DICT_WORDS // 2
    tools._write_gz(str(root / "dicts" / "second.txt.gz"), words[half:] + [b"second-only-word"])
    dedup, dedup_s = server_cli(["dedup-dicts", gz, root / "dicts" / "second.txt.gz"])
    check(dedup[str(root / "dicts" / "second.txt.gz")] == {"before": len(words) - half + 1,
                                                            "after": 1}, f"13d dedup {dedup}")
    check(native.load() is not None, "13d: the native capture parser did not load")
    check(tools.get_extractor(native=True) is native.extract_hashlines_fast,
          "13d: fill-pr --native would not take the native parser")
    fill, fill_s = server_cli(["fill-pr", *common, "--native"])
    check(fill == {"submissions": TOOLS_CAPTURES, "probes": 2 * TOOLS_CAPTURES}, f"13d fill-pr {fill}")

    corpus = captures + [tfx.pcap_bytes(tfx.make_handshake_frames(
        b"bulk-psk-13d", b"BulkNet", seed="13d-bulk", probes=(b"one", b"two"))[0] * 200)]
    parsed = {}
    for name, fn in (("native", native.extract_hashlines_fast), ("python", extract_hashlines)):
        t0 = time.perf_counter()
        parsed[name] = ([fn(blob) for blob in corpus], time.perf_counter() - t0)
    check(parsed["native"][0] == parsed["python"][0], "13d: native parser != Python parser")

    hcdir = root / "hc"
    pc, pc_s = server_cli(["pack-client", "--hcdir", hcdir, "--version", TOOLS_CLIENT_VERSION])
    pc2, _ = server_cli(["pack-client", "--hcdir", root / "hc2", "--version", TOOLS_CLIENT_VERSION])
    check(pc["md5"] == pc2["md5"] == hashlib.md5((hcdir / "dwpa_tpu.pyz").read_bytes()).hexdigest(),
          f"13d pack-client not deterministic: {pc} {pc2}")
    api = ServerAPI("http://loopback/", max_tries=1, sleep=lambda s: None)
    api._transport = WsgiTransport(make_wsgi_app(ServerCore(Database(":memory:"), hcdir=str(hcdir))))
    client = TpuCrackClient(ClientConfig(base_url="http://loopback/", workdir=str(root / "client"),
                                         device=device), api=api, log=lambda msg: None)
    check(client.check_update(), "13d: the client refused the packed update")
    got = root / "client" / f"dwpa_tpu-{TOOLS_CLIENT_VERSION}.pyz"
    check(hashlib.md5(got.read_bytes()).hexdigest() == pc["md5"], "13d: update md5")
    print(f"phase 13d tools: database of {PRECRACK_PROCESSED + PRECRACK_UNPROCESSED} nets built "
          f"in {build_s:.1f} s; recrack {recrack} in {recrack_s:.3f} s; pack-dict "
          f"{TOOLS_DICT_WORDS} words in {pack_s:.3f} s; dedup-dicts {dedup_s:.3f} s; fill-pr "
          f"--native {fill} in {fill_s:.3f} s; capture corpus ({len(corpus)} blobs, "
          f"{sum(map(len, corpus))} bytes): native {parsed['native'][1]:.4f} s, Python "
          f"{parsed['python'][1]:.4f} s, equal; pack-client {pc['files']} files md5 {pc['md5']} "
          f"(twice) in {pc_s:.3f} s, check_update accepted {TOOLS_CLIENT_VERSION} [{card}]",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)


def phase_ops(dev, card, k3_paths):
    """Phase 13: the Thomson sweep on the card, a pre-crack that finds
    Thomson nets, the chaos soak, the operator tools.  Returns K1's
    launches of 13b and 13c (K3's go into ``k3_paths``)."""
    t13 = time.perf_counter()
    phase_thomson_sweep(dev, card)
    launches = {"13b": k3_run(k3_paths, "thomson precrack (phase 13b)", phase_thomson_precrack,
                              card),
                "13c": k3_run(k3_paths, "chaos client (phase 13c)", phase_chaos_soak, card)}
    phase_operator_tools(card)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s; K1 launches {launches} [{card}]",
          flush=True)
    return launches


SLICE_BATCH = UNIT_BATCH // 2            # 14d: each process's share of one global block
SLICE_DICT_WORDS = UNIT_BATCH            # 14d: one global block, half per process
SLICE_PLANT_AT = 100_000                 # 14d: in process 1's share
SLICE_TIMEOUT_S = 400
SLICE_DEVICE = "cuda:0"                  # 14d: both processes share the one card
#: 14d: runs ``python -m dwpa_tpu_torch.client <args>`` in this process,
#: counting K1 launches (all, and from pass 2 on), pass 2's valid rows,
#: K3's launches by entry and the plain verify's calls.
SLICE_LAUNCHER = """
import atexit, json, runpy, sys
from dwpa_tpu_torch.client import main as cm
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda, verify, verify_cuda
seen = {"k1_before_pass2": None, "pass2_rows": 0}
real_fetch, real_dispatch = cm.TpuCrackClient._fetch_pass2_paths, tm.M22000Engine._dispatch
def fetch(self, work):
    seen["k1_before_pass2"] = pbkdf2_cuda.LAUNCHES
    return real_fetch(self, work)
def dispatch(self, prep):
    if seen["k1_before_pass2"] is not None:
        seen["pass2_rows"] += prep[1]
    return real_dispatch(self, prep)
cm.TpuCrackClient._fetch_pass2_paths, tm.M22000Engine._dispatch = fetch, dispatch
atexit.register(lambda: print("SLICE_COUNTS " + json.dumps({
    "launches": pbkdf2_cuda.LAUNCHES, "plain_calls": pbkdf2.CALLS,
    "pass2_launches": pbkdf2_cuda.LAUNCHES - (seen["k1_before_pass2"] or 0),
    "pass2_rows": seen["pass2_rows"], "k3_launches": dict(verify_cuda.LAUNCHES),
    "verify_plain_calls": verify.CALLS}), flush=True))
sys.argv = ["dwpa_tpu_torch.client"] + sys.argv[1:]
runpy.run_module("dwpa_tpu_torch.client", run_name="__main__", alter_sys=True)
"""


def found_keys(founds):
    return sorted((f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in founds)


def phase_streams_unit(dev, card, words, unit_founds, unit_pmk_s):
    """14a: crack_streams on phase 4's unit with two streams on the card
    against crack_blocks on the same blocks, then a crash leg.  Returns
    K1's launches of the stream run."""
    import torch

    from dwpa_tpu_torch.feed import frame_blocks
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.parallel.streams import device_label

    raw = [ln for ln, _ in unit_lines()]
    want = found_keys(unit_founds)

    def log_into(into):
        return lambda c, f: into.append((c, sorted(x.psk for x in f)))

    lock_log = []
    eng = M22000Engine(raw, batch_size=UNIT_BATCH, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lock = eng.crack_blocks(frame_blocks(iter(words), UNIT_BATCH), on_batch=log_into(lock_log))
    lock_s = time.perf_counter() - t0
    check(found_keys(lock) == want, "14a crack_blocks founds != phase 4's")

    reg = MetricsRegistry()
    st_log = []
    eng = M22000Engine(raw, batch_size=UNIT_BATCH, device=dev)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
    t0 = time.perf_counter()
    founds = eng.crack_streams(frame_blocks(iter(words), UNIT_BATCH), on_batch=log_into(st_log),
                               devices=[dev, dev], registry=reg)
    streams_s = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    check(found_keys(founds) == want, "14a crack_streams founds != phase 4's (PSK, NC, endian, PMK)")
    check(st_log == lock_log, f"14a on_batch {st_log} != crack_blocks' {lock_log}")
    check(launches == UNIT_WORDS // UNIT_BATCH and plain_calls == 0,
          f"14a K1 launches {launches}, plain PBKDF2 calls {plain_calls}")
    check(not [t for t in threading.enumerate() if t.name.startswith("stream-")],
          "14a left a stream thread running")
    blocks = reg.value("dwpa_stream_blocks_total", device=device_label(dev))
    check(blocks == UNIT_WORDS // UNIT_BATCH, f"14a stream blocks {blocks}")
    print(f"phase 14a streams: phase 4's unit ({UNIT_WORDS} words, 5 nets) on 2 streams on "
          f"{dev} in {streams_s:.3f} s = {UNIT_WORDS / streams_s:.1f} PMK/s against crack_blocks "
          f"{lock_s:.3f} s = {UNIT_WORDS / lock_s:.1f} PMK/s and phase 4's crack "
          f"{unit_pmk_s:.1f} PMK/s; founds and on_batch sequence equal; K1 launches {launches}, "
          f"plain PBKDF2 calls {plain_calls}; stream blocks {blocks} [{card}]", flush=True)

    # -- the crash leg: the first stream's engine raises on its third block
    # (its methods are wrapped per instance; a subclass overriding the
    # engine's method names would add definitions the analyser resolves
    # calls by)
    made, crashed_at, survivor_blocks = [], [], []

    def factory(device):
        eng = M22000Engine(raw, batch_size=UNIT_BATCH, device=device)
        real_prepare, real_dispatch = eng._prepare_block, eng._dispatch
        offsets = []
        if not made:
            def prepare_counted(block, stager=None):
                offsets.append(block.offset)
                return real_prepare(block, stager)

            def dispatch_or_crash(prep):
                if len(offsets) == 3:
                    crashed_at.append(offsets[-1])
                    raise RuntimeError("injected stream fault on the third block")
                return real_dispatch(prep)

            eng._prepare_block, eng._dispatch = prepare_counted, dispatch_or_crash
        else:
            def prepare_late(block, stager=None):
                if not survivor_blocks:
                    time.sleep(0.3)   # the crashing stream takes the first blocks
                survivor_blocks.append(block.offset)
                return real_prepare(block, stager)

            eng._prepare_block = prepare_late
        made.append(eng)
        return eng

    crash_log = []
    eng = M22000Engine(raw, batch_size=UNIT_BATCH, device=dev)
    t0 = time.perf_counter()
    founds = eng.crack_streams(frame_blocks(iter(words), UNIT_BATCH), on_batch=log_into(crash_log),
                               devices=[dev, dev], engine_factory=factory)
    crash_s = time.perf_counter() - t0
    check(len(crashed_at) == 1 and crashed_at[0] in survivor_blocks,
          f"14a the crashed block {crashed_at} was not requeued to the survivor {survivor_blocks}")
    check(found_keys(founds) == want and crash_log == lock_log,
          "14a crash leg: founds or on_batch changed")
    print(f"phase 14a crash leg: stream 0 raised on its third block (offset {crashed_at[0]}), "
          f"requeued and cracked by stream 1 (its blocks at offsets {survivor_blocks}); founds "
          f"and on_batch sequence unchanged; {crash_s:.3f} s [{card}]", flush=True)
    return launches


def phase_rules_streams(dev, card, rules_founds, rules_rate):
    """14b: crack_rules_streams on 7b's rules_device configuration with two
    streams on the card; the founds equal 7b's.  Returns K1's launches."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import frame_blocks
    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.rules import parse_rules

    rules = parse_rules(RULES_DEVICE)
    base = [b"devrule%07d" % i for i in range(UNIT_BATCH * RULES_FLUSHES)]
    psk = rules[-1].apply(base[-1])
    eng = M22000Engine([tfx.make_pmkid_line(psk, b"bench-essid", seed="rulesdev")],
                       batch_size=UNIT_BATCH, device=dev)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = pbkdf2.CALLS = 0
    log = []
    t0 = time.perf_counter()
    founds = eng.crack_rules_streams(frame_blocks(iter(base), UNIT_BATCH), rules,
                                     on_batch=lambda c, f: log.append(c), devices=[dev, dev])
    wall = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    check(found_keys(founds) == found_keys(rules_founds), "14b founds != 7b's")
    check(log == [UNIT_BATCH * len(rules)] * RULES_FLUSHES, f"14b on_batch {log}")
    check(launches == len(rules) * RULES_FLUSHES and plain_calls == 0,
          f"14b K1 launches {launches}, plain PBKDF2 calls {plain_calls}")
    n = len(base) * len(rules)
    print(f"phase 14b rules streams: 7b's configuration on 2 streams on {dev}, {n} candidates "
          f"in {wall:.3f} s = {n / wall:.1f} candidates/s against 7b's {rules_rate:.1f}; founds "
          f"equal 7b's; K1 launches {launches}, plain PBKDF2 calls {plain_calls} [{card}]",
          flush=True)
    return launches


def phase_builds(card, words):
    """14c: a second ``run()`` of phase 6's unit counts no build; the
    build sentinel over a fresh build directory counts one per library."""
    from dwpa_tpu_torch import native
    from dwpa_tpu_torch.analysis import watch_compiles
    from dwpa_tpu_torch.ops import _gxx, _nvcc, pbkdf2_cuda, sm_probe, verify_cuda

    kernels = (pbkdf2_cuda.SOURCE, sm_probe.SOURCE, verify_cuda.SOURCE)
    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    server = stub_server(raw)(blob, hashlib.md5(blob).hexdigest())
    root = CLIENT_DIR / "builds"
    shutil.rmtree(root, ignore_errors=True)
    client, reg = make_client(server, root / "unit", 1, "second run()", phase="phase 14c")
    check(client.run() == 1 and client.last_result.accepted, "14c unit not accepted")
    check_founds(client.last_result.founds, lines, "phase 14c")
    recompiles = reg.value("dwpa_client_recompiles_total") or 0
    check(recompiles == 0, f"14c the second run() counted {recompiles} builds")
    native_dir = Path(native.__file__).resolve().parent
    fresh = root / "fresh-build"
    t0 = time.perf_counter()
    with watch_compiles() as cold:
        _nvcc.build(*kernels, build_dir=fresh)
        for src in ("pack_fast.cpp", "capture_fast.cpp"):
            _gxx.build(native_dir / src, fresh)
    cold_s = time.perf_counter() - t0
    with watch_compiles() as warm:
        _nvcc.build(*kernels, build_dir=fresh)
        for src in ("pack_fast.cpp", "capture_fast.cpp"):
            _gxx.build(native_dir / src, fresh)
    check(cold.count == 5 and warm.count == 0, f"14c builds counted {cold} then {warm}")
    print(f"phase 14c builds: a second run() of phase 6's unit counted "
          f"dwpa_client_recompiles_total {recompiles:.0f}; a fresh build directory counted "
          f"{cold.count} builds ({', '.join(cold.names)}) in {cold_s:.1f} s, then {warm.count} "
          f"[{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def phase_slice(rng, card, k3_paths):
    """14d: a two-process slice of the client CLI on the card against the
    port's WSGI server on 127.0.0.1.  Returns K1's launches over both
    processes (K3's go into ``k3_paths``)."""
    import os
    import socket
    import socketserver
    import subprocess
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app

    root = CLIENT_DIR / "slice"
    shutil.rmtree(root, ignore_errors=True)
    (root / "dicts").mkdir(parents=True)
    core = ServerCore(Database(str(root / "wpa.db")), dictdir=str(root / "dicts"),
                      capdir=str(root / "caps"))
    lines = unit_lines()
    core.add_hashlines([ln for ln, _ in lines])
    core.db.x("UPDATE nets SET algo = ''")
    words = random_words(rng, SLICE_DICT_WORDS, 8, 20)
    words[SLICE_PLANT_AT] = PSK
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    (root / "dicts" / "slice14d.txt.gz").write_bytes(blob)
    core.add_dict("dict/slice14d.txt.gz", "slice14d.txt.gz", hashlib.md5(blob).hexdigest(),
                  len(words))
    hits = {"get_work": 0, "put_work": 0}
    app = make_wsgi_app(core)

    def counting_app(environ, start_response):
        q = environ.get("QUERY_STRING", "")
        for k in hits:
            if k in q:
                hits[k] += 1
        return app(environ, start_response)

    class Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class Handler(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    srv = make_server("127.0.0.1", 0, counting_app, server_class=Server, handler_class=Handler)
    serving = threading.Thread(target=srv.serve_forever, name="dwpa-serve", daemon=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = sk.getsockname()[1]
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = []
    t0 = time.perf_counter()
    try:
        serving.start()
        for pid in (0, 1):
            args = ["--url", f"http://127.0.0.1:{srv.server_port}/", "--workdir",
                    str(root / f"p{pid}"), "-n", "1", "-b", str(SLICE_BATCH),
                    "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "2",
                    "--process-id", str(pid), "--device", SLICE_DEVICE]
            procs.append(subprocess.Popen([sys.executable, "-c", SLICE_LAUNCHER, *args],
                                          cwd=str(repo), env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=SLICE_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        srv.shutdown()
        serving.join(timeout=10)
        srv.server_close()
    wall = time.perf_counter() - t0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"14d process {pid} exited {p.returncode}:\n{out[-3000:]}")
    counts = [json.loads(next(x for x in out.splitlines() if x.startswith("SLICE_COUNTS "))
                         [len("SLICE_COUNTS "):]) for out in outs]
    check(hits == {"get_work": 1, "put_work": 1}, f"14d server calls {hits}")
    rows = core.db.q('SELECT n_state, "pass" FROM nets')
    check(len(rows) == len(lines) and all(r["n_state"] == 1 and r["pass"] == PSK for r in rows),
          f"14d nets {[tuple(r) for r in rows]}")
    for pid, c in enumerate(counts):
        check(c["plain_calls"] == 0 and c["launches"] > 0, f"14d process {pid} counts {c}")
        check(c["verify_plain_calls"] == 0 and sum(c["k3_launches"].values()) > 0,
              f"14d process {pid} K3 counts {c}")
        check(c["pass2_rows"] == SLICE_DICT_WORDS // 2 and c["pass2_launches"] == 1,
              f"14d process {pid}'s pass 2 did not take half the blocks: {c}")
        pot = (root / f"p{pid}" / "potfile").read_text().splitlines()
        check(len(pot) == len(lines), f"14d process {pid} potfile {pot}")
    slice_lines = [[x for x in out.splitlines() if "slice PMK/s" in x] for out in outs]
    check(len(slice_lines[0]) == 1 and not slice_lines[1],
          f"14d slice PMK/s lines: {slice_lines}")
    launches = sum(c["launches"] for c in counts)
    k3_paths["two-process slice (phase 14d)"] = dict(sum(
        (collections.Counter(c["k3_launches"]) for c in counts), collections.Counter()))
    print(f"phase 14d slice: 2 processes of `python -m dwpa_tpu_torch.client` on {SLICE_DEVICE} "
          f"(gloo over 127.0.0.1), {len(lines)} nets, a {SLICE_DICT_WORDS}-word dict at batch "
          f"{SLICE_BATCH}; one get_work, one put_work; every net cracked once, both processes "
          f"decoded all 5; K1 launches per process {[c['launches'] for c in counts]}, pass 2 "
          f"{[c['pass2_launches'] for c in counts]} launches over {[c['pass2_rows'] for c in counts]}"
          f" rows; K3 launches per process {[c['k3_launches'] for c in counts]}; rank 0: {slice_lines[0][0].strip()}; {wall:.1f} s [{card}]", flush=True)
    core.db.close()
    shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_slices(dev, rng, card, words, unit_founds, unit_pmk_s, rules_founds, rules_rate,
                 k3_paths):
    """Phase 14: per-device streams, the build sentinel and a two-process
    slice, all through K1 and K3.  Returns K1's launches of 14a, 14b and
    14d (K3's go into ``k3_paths``)."""
    t14 = time.perf_counter()
    launches = {"14a": k3_run(k3_paths, "streams (phase 14a)", phase_streams_unit, dev, card,
                              words, unit_founds, unit_pmk_s),
                "14b": k3_run(k3_paths, "rules streams (phase 14b)", phase_rules_streams, dev,
                              card, rules_founds, rules_rate)}
    phase_builds(card, words)
    launches["14d"] = phase_slice(rng, card, k3_paths)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s; K1 launches {launches} [{card}]",
          flush=True)
    return launches


def k3_run(paths, label, fn, *args):
    """``fn(*args)``, with K3's launches during it (by entry) recorded
    under ``label`` in ``paths``; the plain verify must not run."""
    from dwpa_tpu_torch.ops import verify, verify_cuda

    before, calls = collections.Counter(verify_cuda.LAUNCHES), verify.CALLS
    out = fn(*args)
    check(verify.CALLS == calls, f"{label}: the plain verify ran {verify.CALLS - calls} times")
    paths[label] = dict(verify_cuda.LAUNCHES - before)
    return out


#: Phase 15's nets as (keyver, NC delta, endian, EAPOL key data, AP nonce
#: offset in the PRF's nonce pair): two PMKID (keyver 100); three keyver 1
#: and three keyver 2 (each a verify part bucket-padded to four rows), at
#: offsets 0 and 32, with LE corrections at offset 0 that change PRF block
#: 0; keyver 3 at both offsets with F = 7 full CMAC blocks and a padded
#: last block, F = 7 complete (29 key-data bytes), F = 15 complete (157)
#: and F = 16 padded (160); hits in non-zero NC variants of both endians.
K3_SPECS = [(100, 0, "", None, None), (100, 0, "", None, None),
            (1, 0, "", None, 0), (1, 2, "LE", None, 0), (1, -1, "BE", None, 32),
            (2, -3, "BE", None, 32), (2, 1, "LE", None, 0), (2, -2, "LE", None, 0),
            (3, 0, "", None, 0), (3, -2, "BE", None, 32), (3, 3, "LE", b"\x30" * 29, 0),
            (3, 2, "LE", b"\x41" * 157, 32), (3, -1, "BE", b"\x42" * 160, 0)]
K3_SHORT = {True: b"sixteen byte msg", False: b"seven b"}   # F = 0, last_complete


def phase_k3(dev, rng, card, k1_ms, rates, sass):
    """Phase 15: K3 against its plain version on the card, at phase 4's
    width with a ragged tail; every part's bounds, and cmac's time at F =
    0, 7 and 15; then 15b.  Returns max_abs_err by entry."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops import verify_cuda
    from dwpa_tpu_torch.ops.common import to_torch
    from dwpa_tpu_torch.oracle import m22000 as oracle
    from dwpa_tpu_torch.parallel.step import build_crack_step

    essid = b"dwpa-torch-k3"
    b = K3_B
    lines = tfx.verify_lines(K3_SPECS, essid, "k3-phase15")
    nets = [m.prep_net(hl.parse(line), device=dev) for line, _ in lines]
    ap_offs = [None if n.keyver == 100 else oracle.nonce_pairs(n.line)[2] for n in nets]
    check(ap_offs == [spec[4] for spec in K3_SPECS], f"phase 15: AP nonce offsets {ap_offs}")
    pmk = rng.integers(0, 2**32, (8, b), dtype=np.uint64).astype(np.uint32)
    # each net at one column spread over the batch and one in the last
    # block; net 0 at column B - 1
    planted = tfx.plant_pmks(pmk, essid, [psk for _, psk in lines],
                             [((i * 12_007 + 4_321) % (b - 256), b - 1 - 7 * i)
                              for i in range(len(lines))])
    want = tfx.planted_hits(nets, K3_SPECS, planted)
    pmk_dev = to_torch(pmk, dev)
    err = dict.fromkeys(K3_ENTRIES, 0)

    def held(entry, got, ref, what):
        err[entry] = max(err[entry], int((got.int() - ref.int()).abs().max()) if got.numel() else 0)
        check(got.shape == ref.shape and torch.equal(got, ref), f"phase 15: K3 != plain, {what}")

    step = build_crack_step(nets, *m.essid_salt_blocks(essid), dev)
    before = collections.Counter(verify_cuda.LAUNCHES)
    hits, found, _ = step.verify(pmk_dev)
    torch.cuda.synchronize()
    launched = dict(verify_cuda.LAUNCHES - before)
    parts = verify_parts(step, nets)
    check(launched == dict(collections.Counter(kind for kind, *_ in parts)),
          f"phase 15: K3 launches {launched} for parts {[p[:3] for p in parts]}")
    check(sum(n == 3 and consts[0].shape[0] == 4 for _, _, n, consts in parts) == 2,
          "phase 15: not two bucket-padded parts of 3 nets")
    check({consts[1].shape[1] for kind, _, _, consts in parts if kind == "cmac"} == {7, 15, 16},
          "phase 15: keyver 3 parts not at F = 7, 15 and 16")
    bounds = []
    for kind, static, n, consts in parts:
        held(kind, kernel_match(kind, static, pmk_dev, consts),
             tfx.plain_part(kind, static, pmk_dev, consts), part_label(kind, static, n))
        ms = kernel_ms(lambda: kernel_match(kind, static, pmk_dev, consts))
        v, rows = part_shape(kind, consts)
        bounds.append(k3_part_bound(kind, static, consts[0].shape[0], v, rows,
                                    block0_runs(kind, consts), b, ms, rates, sass,
                                    f"phase 15 {part_label(kind, static, n)}"))
    for i, net in enumerate(nets):
        entry, static, consts = tfx.stacked_consts([net])
        got = m.net_match(pmk_dev, net)
        held(entry, got, tfx.plain_part(entry, static, pmk_dev, consts)[0],
             f"net {i} alone (keyver {net.keyver})")
        held(entry, found[i, :got.shape[0]], got, f"net {i} in the step")
        check(not found[i, got.shape[0]:].any(), f"phase 15: net {i}'s padded variants hit")
    hit_set = {tuple(int(x) for x in ix) for ix in found.nonzero()}
    check(hit_set == want and int(hits) == len(want),
          f"phase 15: hits {int(hits)} at {sorted(hit_set - want)} / missing {sorted(want - hit_set)}")
    cols = sorted(set(rng.choice(b, K3_SAMPLE, replace=False).tolist()) | set(planted))
    cpu_step = build_crack_step([m.prep_net(hl.parse(line), device="cpu") for line, _ in lines],
                                *m.essid_salt_blocks(essid), torch.device("cpu"))
    idx = torch.tensor(cols, device=dev)
    cpu_hits, cpu_found, _ = cpu_step.verify(pmk_dev.index_select(1, idx).cpu())
    check(torch.equal(cpu_found, found.index_select(2, idx).cpu()),
          f"phase 15: the card's found matrix != the CPU plain version's on {len(cols)} columns")
    # F = 0: a CMAC over one block only, complete and padded, with the hit
    # planted at the first keyver 3 net's columns under its real KCK.
    i = next(j for j, spec in enumerate(K3_SPECS) if spec[0] == 3 and spec[1] == 0)
    cols_i = sorted(c for c, j in planted.items() if j == i)
    split = {}
    for complete, msg in K3_SHORT.items():
        short = tfx.short_cmac_net(nets[i], lines[i][1], essid, msg)
        _, static, consts = tfx.stacked_consts([short, short])
        got = kernel_match("cmac", static, pmk_dev, consts)
        held("cmac", got, tfx.plain_part("cmac", static, pmk_dev, consts),
             f"F = 0, last_complete {complete}")
        check({tuple(int(x) for x in ix) for ix in got.nonzero()} ==
              {(r, 0, c) for r in (0, 1) for c in cols_i},
              f"phase 15: F = 0 (last_complete {complete}) hits {got.nonzero().tolist()}")
        if complete:
            split[0] = (short, static)
    # cmac's time split: one net, V = 21, at F = 0, 7 and 15.
    for net in nets:
        if net.keyver == 3 and net.cmac_full.shape[0] in K3_SPLIT_F:
            split.setdefault(net.cmac_full.shape[0], (net, (net.cmac_last_complete,)))
    split_ms, split_recs = {}, {}
    for f in K3_SPLIT_F:
        net, static = split[f]
        _, _, consts = tfx.stacked_consts([net])
        split_ms[f] = kernel_ms(lambda: kernel_match("cmac", static, pmk_dev, consts),
                                K3_SPLIT_RUNS)
        split_recs[f] = k3_part_bound("cmac", static, 1, consts[0].shape[1], f, None, b,
                                      split_ms[f], rates, sass, f"phase 15 cmac at F = {f}")
    f0, f1 = K3_SPLIT_F[0], K3_SPLIT_F[-1]
    slope = (split_ms[f1] - split_ms[f0]) / (f1 - f0)
    smem_block = (split_recs[f1]["smem_bound_ms"] - split_recs[f0]["smem_bound_ms"]) / (f1 - f0)
    print(f"phase 15 K3: {len(nets)} nets in {len(parts)} parts "
          f"({', '.join(part_label(k, st, n) for k, st, n, _ in parts)}) over B={b}, AP nonce "
          f"offsets by net {ap_offs}: found matrices bit for bit equal to the plain version on "
          f"the card (every part, bucket rows included, and every net alone) and to the CPU "
          f"plain version on {len(cols)} columns; {len(want)} planted hits (NC variants of both "
          f"endians, LE at offset 0, column B-1) found exactly; F = 0 with last_complete True "
          f"and False; K3 launches {launched}; max_abs_err {err} [{card}]", flush=True)
    for (kind, static, n, _), rec in zip(parts, bounds):
        print(f"phase 15 {k3_bound_line(rec, b, part_label(kind, static, n))} [{card}]",
              flush=True)
    print(f"phase 15 cmac time split (one net, V 21, B={b}, on the device alone: median of "
          f"{K3_SPLIT_RUNS} runs of {K3_REPS} launches): "
          + ", ".join(f"F = {f} {split_ms[f]:.3f} ms (smem bound "
                      f"{split_recs[f]['smem_bound_ms']:.3f}, issue-rate census "
                      f"{split_recs[f]['issue_bound_ms']:.3f})" for f in K3_SPLIT_F)
          + f"; slope {slope:.4f} ms per AES block a (variant, column) against its 160 table "
          f"loads at shared memory's rate {smem_block:.4f} ms ({smem_block / slope:.1%}); "
          f"intercept (the SHA-256 side, the key schedule and 2 AES blocks) "
          f"{split_ms[f0] - f0 * slope:.3f} ms [{card}]", flush=True)
    phase_pmkid_sweep(dev, rng, card, rates, sass, held)
    for entry, e in phase_k3_wide(dev, rng, card, k1_ms, rates, sass).items():
        err[entry] = max(err[entry], e)
    return err


def pmkid_part(dev, rng, count, b, held):
    """``count`` PMKID nets as a crack step stacks them (7 bucket-padded
    to 8) over ``b`` columns, each net's PSK planted at a column spread
    over the batch and one in the last block (net 0 at B - 1).  The
    part's found matrix is held to the plain version on the card
    (``held``) and to the CPU plain version on ``K3_SAMPLE`` columns, its
    hits to the planted ones.  -> (static, consts, pmk on the card)."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops.common import to_torch
    from dwpa_tpu_torch.parallel.step import build_crack_step

    essid = b"dwpa-torch-k3-pmkid"
    specs = [(100, 0, "", None)] * count
    lines = tfx.verify_lines(specs, essid, f"k3-pmkid-{count}")
    nets = [m.prep_net(hl.parse(line), device=dev) for line, _ in lines]
    pmk = rng.integers(0, 2**32, (8, b), dtype=np.uint64).astype(np.uint32)
    planted = tfx.plant_pmks(pmk, essid, [psk for _, psk in lines],
                             [((i * 3_989 + 1_234) % (b - 256), b - 1 - i)
                              for i in range(count)])
    want = tfx.planted_hits(nets, specs, planted)
    pmk_dev = to_torch(pmk, dev)
    step = build_crack_step(nets, *m.essid_salt_blocks(essid), dev)
    ((kind, static, _, consts),) = verify_parts(step, nets)
    rows = consts[0].shape[0]
    label = f"pmkid x{count} (bucket {rows}) at B={b}"
    got = kernel_match(kind, static, pmk_dev, consts)
    held(kind, got, tfx.plain_part(kind, static, pmk_dev, consts), label)
    check({tuple(int(x) for x in ix) for ix in got[:count].nonzero()} == want,
          f"phase 15: {label} hits {got.nonzero().tolist()[:8]}")
    check(torch.equal(got[count:], got[count - 1:count].expand(rows - count, -1, -1)),
          f"phase 15: {label}'s bucket rows differ from the net they repeat")
    cols = sorted(set(rng.choice(b, K3_SAMPLE, replace=False).tolist()) | set(planted))
    idx = torch.tensor(cols, device=dev)
    cpu = tfx.plain_part(kind, static, pmk_dev.index_select(1, idx).cpu(),
                         [c.cpu() for c in consts])
    held(kind, got.index_select(2, idx).cpu(), cpu, f"{label} against the CPU")
    return static, consts, pmk_dev


def phase_pmkid_sweep(dev, rng, card, rates, sass, held):
    """Phase 15, pmkid's net sweep: parts of ``K3_PMKID_NETS`` PMKID nets
    over B = 131069 columns (:func:`pmkid_part`), each timed on the device
    alone; the slope a net and the intercept are printed beside the
    census's.  Then the small batches of ``K3_PMKID_SMALL``, where the
    nets are split over the grid: each part also run with all its nets a
    thread, exact against the split, and both timed."""
    import torch

    from dwpa_tpu_torch.ops import verify_cuda

    b = K3_B
    recs = {}
    for count in K3_PMKID_NETS:
        static, consts, pmk_dev = pmkid_part(dev, rng, count, b, held)
        rows = consts[0].shape[0]
        label = f"pmkid x{count} (bucket {rows})"
        ms = kernel_ms(lambda: kernel_match("pmkid", static, pmk_dev, consts))
        recs[rows] = k3_part_bound("pmkid", static, rows, 1, 0, None, b, ms, rates, sass,
                                   f"phase 15 {label}")
        print(f"phase 15 {k3_bound_line(recs[rows], b, label)} [{card}]", flush=True)
    lo, hi = min(recs), max(recs)

    def line(key):
        slope = (recs[hi][key] - recs[lo][key]) / (hi - lo)
        return slope, recs[lo][key] - lo * slope

    ms_net, ms_0 = line("ms")
    census_net, census_0 = line("census_per_column")
    sass_net, sass_0 = line("sass_per_column")
    issue_ms = b / rates["issue"] * 1e3   # ms of one instruction a column at the issue rate
    print(f"phase 15 pmkid net sweep (B={b}, on the device alone, N = "
          f"{', '.join(str(n) for n in recs)}): "
          + ", ".join(f"N = {n} {r['ms']:.4f} ms" for n, r in recs.items())
          + f"; slope {ms_net:.5f} ms a net against the census's {census_net:.0f} instructions "
          f"a column a net at the issue rate {census_net * issue_ms:.5f} ms "
          f"({census_net * issue_ms / ms_net:.1%}) and K3's SASS {sass_net:.0f} "
          f"({sass_net / census_net:.3f}x the census); intercept {ms_0:.5f} ms against the "
          f"census's {census_0:.0f} a column (the pad states) {census_0 * issue_ms:.5f} ms and "
          f"K3's SASS {sass_0:.0f}; every part exact against the plain version on the card "
          f"and on {K3_SAMPLE}+ columns on the CPU [{card}]", flush=True)
    for b, count in K3_PMKID_SMALL:
        static, consts, pmk_dev = pmkid_part(dev, rng, count, b, held)
        blk, tgt, *prep = consts
        rows = blk.shape[0]
        per = verify_cuda.pmkid_nets_per_thread(b, rows, rates["sms"])
        label = f"pmkid x{count} at B={b}"
        ms = kernel_ms(lambda: kernel_match("pmkid", static, pmk_dev, consts))
        rec = k3_part_bound("pmkid", static, rows, 1, 0, None, b, ms, rates, sass,
                            f"phase 15 {label}")
        groups = -(-rows // per)
        out = (f"phase 15 pmkid small batch {k3_bound_line(rec, b, label)}; {per} nets a "
               f"thread, {groups} groups: {-(-b // verify_cuda.PMKID_BLOCK) * groups} blocks "
               f"on {rates['sms']} SMs")
        if per < rows:
            whole = verify_cuda.pmkid_match_cuda(pmk_dev, blk, tgt, prep, nets_per_thread=rows)
            check(torch.equal(whole[:, None], kernel_match("pmkid", static, pmk_dev, consts)),
                  f"phase 15: {label}, all nets a thread != the split")
            one_ms = kernel_ms(lambda: verify_cuda.pmkid_match_cuda(
                pmk_dev, blk, tgt, prep, nets_per_thread=rows))
            one = k3_part_bound("pmkid", static, rows, 1, 0, None, b, one_ms, rates, sass,
                                f"phase 15 {label}, all nets a thread", per=rows)
            out += (f"; all {rows} nets a thread ({-(-b // verify_cuda.PMKID_BLOCK)} blocks) "
                    f"{one_ms:.4f} ms, {one['sass_per_column']:.0f} SASS a column: the split "
                    f"{one_ms / ms:.2f}x faster")
        print(f"{out}; exact against the plain version [{card}]", flush=True)


def phase_k3_wide(dev, rng, card, k1_ms, rates, sass):
    """Phase 15b: K3's weight in a large ESSID group.  One 32-net keyver 2
    part, one 8-net keyver 3 part (F = 7) and one 32-net PMKID part at B =
    131072, timed against K1's time per batch (phase 4), each held to its
    plain version on its first ``K3_WIDE_CHECK`` columns, where every
    net's PSK is planted.  Returns max_abs_err by entry."""
    import torch

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops.common import to_torch

    essid = b"dwpa-torch-k3-wide"
    b = UNIT_BATCH
    ncs = [(0, ""), (1, "LE"), (-2, "LE"), (2, "BE"), (-1, "BE"), (3, "LE"), (-3, "BE")]
    err = {}
    for kind, n in K3_WIDE.items():
        keyver = {"eapol": 2, "cmac": 3, "pmkid": 100}[kind]
        specs = [(keyver, *ncs[i % len(ncs)], None, 32 * (i % 2)) for i in range(n)]
        lines = tfx.verify_lines(specs, essid, f"k3-wide-{kind}")
        nets = [m.prep_net(hl.parse(line), device=dev) for line, _ in lines]
        pmk = rng.integers(0, 2**32, (8, b), dtype=np.uint64).astype(np.uint32)
        planted = tfx.plant_pmks(pmk, essid, [psk for _, psk in lines],
                                 [(17 + 97 * i,) for i in range(n)])
        want = tfx.planted_hits(nets, specs, planted)
        _, static, consts = tfx.stacked_consts(nets)
        pmk_dev = to_torch(pmk, dev)
        got = kernel_match(kind, static, pmk_dev, consts)
        ref = tfx.plain_part(kind, static, pmk_dev[:, :K3_WIDE_CHECK].contiguous(), consts)
        sl = got[:, :, :K3_WIDE_CHECK]
        err[kind] = int((sl.int() - ref.int()).abs().max())
        check(torch.equal(sl, ref), f"phase 15b: K3 != plain on {kind} x{n}")
        check({tuple(int(x) for x in ix) for ix in got.nonzero()} == want,
              f"phase 15b: {kind} x{n} hits {got.nonzero().tolist()[:8]}")
        ms = kernel_ms(lambda: kernel_match(kind, static, pmk_dev, consts))
        v, rows = part_shape(kind, consts)
        rec = k3_part_bound(kind, static, n, v, rows, block0_runs(kind, consts), b, ms, rates,
                            sass, f"phase 15b {kind} x{n}")
        print(f"phase 15b {k3_bound_line(rec, b, part_label(kind, static, n))}; held to the "
              f"plain version on {K3_WIDE_CHECK} columns, {len(want)} planted hits; against "
              f"K1's {k1_ms:.3f} ms a batch (phase 4): {ms / k1_ms:.1%} [{card}]", flush=True)
    return err


def k3_rates(res):
    """The card's rates behind K3's bounds, from the probe's result
    ``res`` (phase 5): the issue rate (every SM issues 4 x 32
    thread-instructions a clock at the maximum SM clock), the rate the
    ``sha1_round`` probe sustained (the integer pipes), and shared
    memory's 32 lanes a clock an SM."""
    from dwpa_tpu_torch.ops import sm_probe

    sms = res["sms"]
    clock_hz = float(res["max_sm_clock"].split()[0]) * 1e6
    return {"sms": sms, "issue": sms * sm_probe.ISSUE_PER_SM_CLOCK * clock_hz,
            "probe": res["mixes"]["sha1_round"]["thread_inst_per_s"],
            "smem": sms * SMEM_LANES_PER_SM_CLOCK * clock_hz}


def k3_part_bound(kind, static, n, v, rows, runs, b, ms, rates, sass, what, per=None):
    """One verify part's bounds at ``b`` columns (one launch): the
    instructions its function needs (``ops/opcount.py`` ``verify_census``:
    its plain version's 32-bit ops fused into the card's 3-input
    instructions, a PRF block 0 once per distinct block, AES-128 at the
    T-table model) at the issue rate and at the probe's rate, the census's
    AES table loads at shared memory's rate, and 32 PMK bytes in and N x V
    result bytes out a column at the HBM rate; beside them what K3's own
    SASS issues (each instruction once per trip of the loops around it;
    for pmkid B threads for each group of ``per`` nets, by default as
    ``verify_cuda.pmkid_nets_per_thread`` splits them, N x B threads for
    the others).  Fails if K3 took less than
    the census at the issue rate, or if K3's own SASS issues fewer
    instructions a column than the census counts: the census must stay a
    floor.  -> the part's record."""
    from dwpa_tpu_torch.ops import verify_cuda
    from dwpa_tpu_torch.ops.opcount import verify_census
    from dwpa_tpu_torch.ops.sass import dynamic_count

    census = verify_census(kind, static, n, v, rows, b, runs)
    threads = n   # a column's threads
    if kind == "pmkid":
        threads = -(-n // (per or verify_cuda.pmkid_nets_per_thread(b, n, rates["sms"])))
    inst = dynamic_count(sass, k3_function(kind, static),
                         k3_trips(kind, n / threads if kind == "pmkid" else n, v, rows, runs))
    per_column = inst * threads
    rec = {"part": f"{kind}{list(static)}", "nets": n, "variants": v, "blocks": rows,
           "prf_block0_runs": runs, "census_per_column": census["per_column"],
           "census_by_class": census["by_class"], "thread_inst": inst, "ms": ms,
           "issue_bound_ms": census["ops"] / rates["issue"] * 1e3,
           "probe_bound_ms": census["ops"] / rates["probe"] * 1e3,
           "smem_bound_ms": census["by_class"].get("aes_loads", 0) * b / rates["smem"] * 1e3,
           "bytes_bound_ms": b * (32 + n * v) / HBM_BYTES_PER_S * 1e3,
           "sass_per_column": per_column,
           "sass_bound_ms": per_column * b / rates["issue"] * 1e3}
    rec["bound_ms"] = max(rec["issue_bound_ms"], rec["bytes_bound_ms"])
    check(rec["issue_bound_ms"] <= ms,
          f"{what}: K3 {ms:.3f} ms under its census bound {rec['issue_bound_ms']:.3f} ms")
    check(per_column >= census["per_column"],
          f"{what}: K3's own SASS issues {per_column:.0f} instructions a column, fewer than "
          f"the census's {census['per_column']}")
    return rec


def k3_bound_line(rec, b, label):
    """The printed form of a :func:`k3_part_bound` record."""
    ms = rec["ms"]
    smem = (f", its {rec['census_by_class']['aes_loads']} table loads a column at shared "
            f"memory's rate {rec['smem_bound_ms']:.3f} ms ({rec['smem_bound_ms'] / ms:.1%})"
            if rec["smem_bound_ms"] else "")
    runs = "" if rec["prf_block0_runs"] is None else \
        f", {rec['prf_block0_runs']} distinct PRF blocks 0"
    return (f"K3 bound {label}: {rec['nets']} nets x {b} columns (V {rec['variants']}, "
            f"{'E' if rec['part'].startswith('eapol') else 'F'} {rec['blocks']}{runs}), the "
            f"function {rec['census_per_column']} instructions a column "
            f"{rec['census_by_class']}: at the issue rate {rec['issue_bound_ms']:.3f} ms (K3 at "
            f"{rec['issue_bound_ms'] / ms:.1%}), at the probe rate {rec['probe_bound_ms']:.3f} "
            f"ms ({rec['probe_bound_ms'] / ms:.1%}){smem}; bytes {rec['bytes_bound_ms']:.4f} ms; "
            f"K3 {ms:.3f} ms; K3's own SASS {rec['thread_inst']:.0f} instructions a thread, "
            f"{rec['sass_per_column']:.0f} a column = {rec['sass_bound_ms']:.3f} ms at the issue "
            f"rate")


def k3_bounds(parts, sass, b, rates, card):
    """K3's bounds at phase 4's shapes, one per verify part (one launch
    each; :func:`k3_part_bound`).  An entry's ms, plain ms and bounds are
    the sums over its parts."""
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "issue_bound_ms", "probe_bound_ms",
            "smem_bound_ms", "bytes_bound_ms", "sass_bound_ms")
    k3 = {e: dict.fromkeys(keys, 0.0) | {"parts": []} for e in K3_ENTRIES}
    for kind, static, n, v, rows, runs, ms, p_ms, call_ms in parts:
        rec = k3_part_bound(kind, static, n, v, rows, runs, b, ms, rates, sass,
                            f"phase 4 {kind}{list(static)}")
        rec["plain_ms"], rec["call_ms"] = p_ms, call_ms
        for key in keys:
            k3[kind][key] += rec[key]
        k3[kind]["parts"].append(rec)
        print(f"{k3_bound_line(rec, b, f'{kind}{list(static)}')}; a single call with host "
              f"issue {call_ms:.3f} ms; plain {p_ms:.3f} ms [{card}]", flush=True)
    return k3


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dwpa_tpu_torch.client.challenge import challenge
    from dwpa_tpu_torch.ops import _nvcc, pbkdf2, pbkdf2_cuda, sm_probe, verify_cuda
    from dwpa_tpu_torch.ops.sass import (dynamic_count, loop_opcodes, loop_span, pipe_split,
                                         sass_text)
    from port_bench.census import k1_inst_per_pmk

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = sm_probe.nvidia_smi("name,power.limit")
    print(f"phase 1 device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    so, probe_so, k3_so = _nvcc.build(pbkdf2_cuda.SOURCE, sm_probe.SOURCE, verify_cuda.SOURCE)
    build_s = time.perf_counter() - t0
    for lib in (so, probe_so, k3_so):
        ptxas = lib.with_suffix(".ptxas.txt").read_text()
        regs = re.findall(r"Used \d+ registers.*", ptxas)
        print(f"phase 1 build: {lib.name}; ptxas: {'; '.join(regs) or ptxas.strip()}", flush=True)
    k1_sass = sass_text(so)
    loop_inst, other_inst = loop_span(k1_sass, "pbkdf2_sha1_pmk_kernel")
    steps = {mix: sm_probe.loop_sass(mix) for mix in sm_probe.MIXES}
    print(f"phase 1 build: three libraries in {build_s:.1f} s (one nvcc each, in parallel); "
          f"K1 SASS: {loop_inst} instructions per loop trip (half an HMAC iteration, T1+T2), "
          f"{other_inst} outside the loop; "
          f"probe SASS per {sm_probe.UNROLL}-step loop iteration: "
          f"{', '.join(f'{m} {n[0]} (+{n[1]} outside)' for m, n in steps.items())}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(sm_probe.nvidia_smi("clocks.max.sm").split()[0])
    k1_mix = loop_opcodes(k1_sass, "pbkdf2_sha1_pmk_kernel")
    split = pipe_split(k1_mix)
    # Each pipe's least time for one batch's loop: its instructions over
    # its lanes (ALU_LANES a clock an SM), or all over the issue rate.
    per_ms = UNIT_BATCH * K1_TRIPS / (sms * clock_mhz * 1e3)
    alu_ms = per_ms * split["alu"] / ALU_LANES
    loop_issue_ms = per_ms * loop_inst / sm_probe.ISSUE_PER_SM_CLOCK
    print(f"phase 1 build: K1 loop opcodes {dict(k1_mix.most_common())}; pipes {split} (ALU "
          f"{split['alu'] / loop_inst:.1%}); ALU-pipe ceiling {alu_ms:.3f} ms per {UNIT_BATCH}-row "
          f"batch ({sms} SMs x {ALU_LANES} lanes x {clock_mhz:.0f} MHz), issue ceiling of its "
          f"SASS {loop_issue_ms:.3f} ms", flush=True)
    k3_sass = sass_text(k3_so)
    one_trip = {part: [1] * len(k3_trips(part[0], 1, 1, 1, 1)) for part in K3_PARTS}
    print("phase 1 build: K3 SASS instructions a thread at one trip of each loop "
          + ", ".join(f"{k3_function(*part)} "
                      f"{dynamic_count(k3_sass, k3_function(*part), one_trip[part])}"
                      for part in K3_PARTS), flush=True)

    rng = np.random.default_rng(SEED)
    err = phase_kernel(dev, rng, card)

    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    check(challenge(device=dev), "challenge gate failed")
    check(pbkdf2_cuda.LAUNCHES > 0 and pbkdf2.CALLS == 0, "challenge bypassed the kernel")
    print("phase 3 challenge: passed (aaaa1234 on the PMKID and EAPOL lines)", flush=True)

    (launches, k1_ms, pw, step, words, unit_pmk_s, unit_founds, k3_launches, k3_parts,
     verify_ms, k1_sweep) = phase_unit(dev, rng, card)
    k3_paths = {"unit (phase 4)": k3_launches}

    # The plain version at the main path's shape, on the same batch.
    pmk_kernel = step.compute_pmk(pw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmk_plain = pbkdf2.pbkdf2_sha1_pmk(pw, step.salt1, step.salt2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, int((pmk_kernel.long() - pmk_plain.long()).abs().max()))
    check(torch.equal(pmk_kernel, pmk_plain), "kernel != plain on the main-path batch")

    res, probe_launches, probe_err, probe_plain_ms = phase_probe(dev, rng, card)
    client_launches, phase6_p2 = k3_run(k3_paths, "client (phase 6)", phase_client, card,
                                        words, unit_pmk_s)
    expand_ms = phase_expand(dev, rng, card)
    rules_launches, rules_err, rules_founds, rules_rate = k3_run(
        k3_paths, "rules engine (phase 7b)", phase_rules_engine, dev, rng, card, expand_ms)
    err = max(err, rules_err)
    rules_client_launches = k3_run(k3_paths, "rules client (phase 7c)", phase_rules_client,
                                   card, rng, unit_pmk_s)
    phase_mask_words(dev, card)
    mask_launches, mask_err = k3_run(k3_paths, "mask (phase 8b)", phase_mask_engine, dev, card)
    err = max(err, mask_err)
    mask_client_launches = k3_run(k3_paths, "mask client (phase 8c)", phase_mask_client, card)
    store_launches = k3_run(k3_paths, "pmkstore (phase 9a)", phase_store_engine, dev, card)
    store_client_launches = k3_run(k3_paths, "pmkstore client (phase 9b)", phase_store_client,
                                   card, words, unit_pmk_s)
    phase_store_poison(dev, rng, card)
    t10 = time.perf_counter()
    fused_err, fused_ms = phase_fused_step(dev, rng, card)
    err = max(err, fused_err)

    def fused_paths():
        out = {"10b": phase_small_units(dev, card)}
        out.update(phase_fused_stream(card, rng))
        return out

    fused_launches = k3_run(k3_paths, "fused (phase 10)", fused_paths)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s; K1 through the fused step "
          f"{fused_ms:.3f} ms per {UNIT_BATCH}-lane batch against {k1_ms:.3f} ms with one "
          f"salt (phase 4); fused-path K1 launches {fused_launches} [{card}]", flush=True)
    t11 = time.perf_counter()
    phase_dict_cache_feed(card)
    dcache_launches = k3_run(k3_paths, "dict cache (phase 11)", lambda: {
        "11b": phase_dict_cache_engine(dev, card),
        "11c": phase_dict_cache_client(card, words, unit_pmk_s, phase6_p2),
        "11d": phase_rbase_client(card, rng, unit_pmk_s)})
    print(f"phase 11: {time.perf_counter() - t11:.1f} s; dict-cache-path K1 launches "
          f"{dcache_launches} [{card}]", flush=True)
    server_launches, precrack_ms = k3_run(k3_paths, "server precrack (phase 12)", phase_server,
                                          dev, rng, card)
    ops_launches = phase_ops(dev, card, k3_paths)
    slice_launches = phase_slices(dev, rng, card, words, unit_founds, unit_pmk_s,
                                  rules_founds, rules_rate, k3_paths)
    rates = k3_rates(res)
    k3_err = phase_k3(dev, rng, card, k1_ms, rates, k3_sass)

    # K1's bounds, on the instructions its function needs (the frozen
    # census, which no rewrite of the kernel moves).  Issue rate: every SM
    # issues 4 x 32 thread-instructions a clock at the maximum SM clock.
    # Probe rate: the thread-instructions per second the sha1_round probe
    # sustained on the whole card.  Beside them, the kernel's own SASS at
    # the issue rate.
    sms = res["sms"]
    clock_hz = float(res["max_sm_clock"].split()[0]) * 1e6
    issue_per_s = sms * sm_probe.ISSUE_PER_SM_CLOCK * clock_hz
    probe_per_s = res["mixes"]["sha1_round"]["thread_inst_per_s"]
    b = pw.shape[0]
    k1_inst = b * k1_inst_per_pmk()
    issue_ms = k1_inst / issue_per_s * 1e3
    probe_ms = k1_inst / probe_per_s * 1e3
    sass_ms = b * (loop_inst * K1_TRIPS + other_inst) / issue_per_s * 1e3
    print(f"K1 bound: {b} rows x {k1_inst_per_pmk()} instructions a PMK (census); issue rate "
          f"({sms} SMs x {sm_probe.ISSUE_PER_SM_CLOCK} x {clock_hz / 1e6:.0f} MHz) "
          f"{issue_ms:.3f} ms, K1 at {issue_ms / k1_ms:.1%} of it; probe rate (sha1_round "
          f"{probe_per_s:.6g} thread-instructions/s) {probe_ms:.3f} ms, K1 at "
          f"{probe_ms / k1_ms:.1%} of it; K1 {k1_ms:.3f} ms; plain version {plain_ms:.1f} ms "
          f"on the same batch; K1's own SASS ({loop_inst} x {K1_TRIPS} + {other_inst} a row) "
          f"at the issue rate {sass_ms:.3f} ms [{card}]", flush=True)

    # K2's bound: the SASS thread-instructions of one full-width sha1_round
    # launch at the issue rate.
    probe_loop, probe_other = steps["sha1_round"]
    sha1 = res["mixes"]["sha1_round"]
    n_full = sms * sha1["threads_per_sm"]
    k2_bound_ms = n_full * (probe_loop * sm_probe.ITERS + probe_other) / issue_per_s * 1e3
    print(f"K2 bound: {n_full} threads x ({probe_loop} x {sm_probe.ITERS} + {probe_other}) SASS "
          f"instructions at the issue rate = {k2_bound_ms:.3f} ms; one launch "
          f"{sha1['seconds_1x'] * 1e3:.3f} ms [{card}]", flush=True)
    b2048 = k1_inst / b * PRECRACK_BATCH / issue_per_s * 1e3
    print(f"K1 per pre-crack launch: {precrack_ms:.3f} ms at {PRECRACK_BATCH} lanes (its work "
          f"at the issue rate {b2048:.3f} ms, K1 at {b2048 / precrack_ms:.1%}: {PRECRACK_BATCH} "
          f"threads fill {PRECRACK_BATCH // 128} of the card's {sms} SMs) against {k1_ms:.3f} ms "
          f"per {b}-row batch (phase 4) [{card}]", flush=True)
    k3 = k3_bounds(k3_parts, k3_sass, b, rates, card)
    print(f"K3 per {b}-row batch (phase 4): {sum(r['ms'] for r in k3.values()):.3f} ms over its "
          f"parts, bound {sum(r['bound_ms'] for r in k3.values()):.3f} ms, the plain verify "
          f"{sum(r['plain_ms'] for r in k3.values()):.3f} ms; step.verify {verify_ms:.3f} ms "
          f"against K1 {k1_ms:.3f} ms; K3 launches by path {k3_paths} [{card}]", flush=True)
    print(f"chip_smoke: phases 1-15 in {time.perf_counter() - t_start:.1f} s [{card}]")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "pbkdf2_sha1_pmk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": min(issue_ms, probe_ms),
        "bound_by": "operations", "library_ms": None,
        "bound_model": "issue_rate" if issue_ms <= probe_ms else "probe_rate",
        "issue_bound_ms": issue_ms, "probe_bound_ms": probe_ms,
        "launches_by_path": {"unit (phase 4)": launches, "client (phase 6)": client_launches,
                             "rules engine (phase 7b)": rules_launches,
                             "rules client (phase 7c)": rules_client_launches,
                             "mask (phase 8b)": mask_launches,
                             "mask client (phase 8c)": mask_client_launches,
                             "pmkstore (phase 9a)": store_launches,
                             "pmkstore client (phase 9b)": store_client_launches,
                             "fused (phase 10)": sum(fused_launches.values()),
                             "dict cache (phase 11)": sum(dcache_launches.values()),
                             "server precrack (phase 12)": server_launches,
                             "thomson precrack (phase 13b)": ops_launches["13b"],
                             "chaos client (phase 13c)": ops_launches["13c"],
                             "streams (phase 14a)": slice_launches["14a"],
                             "rules streams (phase 14b)": slice_launches["14b"],
                             "two-process slice (phase 14d)": slice_launches["14d"]},
        "precrack_ms": precrack_ms, "precrack_lanes": PRECRACK_BATCH,
        "sass_issue_ms": sass_ms, "width_sweep_ms": k1_sweep,
    }, {
        "name": "sm_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": probe_launches, "max_abs_err": probe_err,
        "ms": sha1["seconds_1x"] * 1e3, "plain_ms": probe_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": "operations", "library_ms": None,
    }] + [{
        "name": f"verify_{e}", "route": "cuda", "source": VERIFY_SOURCE,
        "replaces": K3_ENTRIES[e], "launches": k3_launches[e], "max_abs_err": k3_err[e],
        "ms": rec["ms"], "call_ms": rec["call_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": "operations" if rec["issue_bound_ms"] >= rec["bytes_bound_ms"] else "bytes",
        "library_ms": None, "issue_bound_ms": rec["issue_bound_ms"],
        "probe_bound_ms": rec["probe_bound_ms"], "smem_bound_ms": rec["smem_bound_ms"],
        "bytes_bound_ms": rec["bytes_bound_ms"], "sass_bound_ms": rec["sass_bound_ms"],
        "parts": rec["parts"],
        "launches_by_path": {path: c.get(e, 0) for path, c in k3_paths.items()},
    } for e, rec in k3.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
