#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path — one m22000 work unit cracked end to end —
through the entry points a user calls, and holds the PBKDF2 kernel to its
plain torch version and to hashlib.  Phases, each printed as it ends:

1. device and build: the card's name and power limit (``nvidia-smi``),
   then the kernel library built from ``dwpa_tpu_torch/csrc``;
2. the kernel against the plain version on the card at 2 and 4096
   iterations (every row width, both salt ranks, a ragged batch), and
   against ``hashlib.pbkdf2_hmac`` at 4096; equality is exact;
3. the known-PSK challenge gate;
4. the work unit at full size: one ESSID group of five nets (keyver 2,
   PMKID, keyver 2 that needs a nonce correction, keyver 1, keyver 3),
   a seeded 1,048,576-word dictionary in 131072-word batches, the PSK
   planted in the last batch.  Every net must be found with the right
   PSK, NC delta, endian and PMK, through the kernel only;
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
   ``RULE_WORKERS`` processes, and both expansions are also timed alone.

It then prints the kernel records as one JSON line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
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
import sys
import threading
import time
import urllib.parse
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs, timed with CUDA events."""
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


def unit_lines():
    from dwpa_tpu_torch import testing as tfx

    # The mixed, permuted kinds of the JAX package's multi-chip dry run;
    # the second keyver-2 net only cracks with a nonce correction.
    return [
        (tfx.make_eapol_line(PSK, ESSID, keyver=2, seed="u-k2a"), (0, "")),
        (tfx.make_pmkid_line(PSK, ESSID, seed="u-pmk"), (0, "")),
        (tfx.make_eapol_line(PSK, ESSID, keyver=2, nc_delta=-2, endian="BE", seed="u-k2b"),
         (-2, "BE")),
        (tfx.make_eapol_line(PSK, ESSID, keyver=1, seed="u-k1"), (0, "")),
        (tfx.make_eapol_line(PSK, ESSID, keyver=3, seed="u-k3"), (0, "")),
    ]


def phase_unit(dev, rng, card):
    """Phase 4: the work unit at full size, then a per-stage breakdown."""
    import torch

    from dwpa_tpu_torch.models.m22000 import M22000Engine
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
    from dwpa_tpu_torch.parallel.step import _partition

    lines = unit_lines()
    words = random_words(rng, UNIT_WORDS, 8, 20)
    words[PLANT_AT] = PSK
    eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev)
    torch.cuda.synchronize()
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    t0 = time.perf_counter()
    founds = eng.crack(words)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    check(launches > 0, "the unit never launched the PBKDF2 kernel")
    check(plain_calls == 0, f"the unit ran the plain PBKDF2 {plain_calls} times")
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
          f"{plain_calls}; stage host seconds {eng.stage_times} [{card}]", flush=True)

    # Breakdown on one full batch of the same dictionary (a fresh engine).
    eng = M22000Engine([ln for ln, _ in lines], batch_size=UNIT_BATCH, device=dev)
    essid = next(iter(eng.groups))
    step = eng._step_for(essid)
    prep = eng._prepare(words[:UNIT_BATCH])
    pw = prep[2]
    k1_ms = cuda_ms(lambda: step.compute_pmk(pw), 5)
    pmk_dev = step.compute_pmk(pw)
    verify_ms = cuda_ms(lambda: step.verify(pmk_dev), 3)
    parts = []
    for (kind, static, _), idxs in _partition(eng._full[essid]).items():
        fn, consts = step.parts[len(parts)]
        parts.append(f"{kind}{list(static)} x{len(idxs)} "
                     f"{cuda_ms(lambda: fn(pmk_dev, *consts), 3):.3f} ms")
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
          f"(median of 5, CUDA events), verify {verify_ms:.3f} ms (median of 3, 5 nets; "
          f"parts: {', '.join(parts)}), "
          f"gate {gate_ms:.3f} ms (no-hit batch), decode {decode_ms:.3f} ms (hit batch, "
          f"oracle re-check of 5 nets) [{card}]", flush=True)
    return launches, k1_ms, pw, step, words, unit_pmk_s


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


def stub_server(lines, rules_text=None, cracked=None):
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
    allows).
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


def make_client(server, workdir, feed_workers, label, phase="phase 6", rule_workers=0):
    """A ``TpuCrackClient`` for the stub server's unit at full batch, with
    its own registry; returns (client, registry)."""
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    cfg = ClientConfig(base_url=STUB_URL, workdir=str(workdir), batch_size=UNIT_BATCH,
                       max_work_units=1, feed_workers=feed_workers, device="cuda:0",
                       rule_workers=rule_workers)
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
    """Phase 6: the volunteer loop on the card against the stub server."""
    from dwpa_tpu_torch import native
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda

    lines = unit_lines()
    raw = [ln for ln, _ in lines]
    blob = gzip.compress(b"\n".join(words) + b"\n", compresslevel=1)
    dhash = hashlib.md5(blob).hexdigest()
    Server = stub_server(raw)
    shutil.rmtree(CLIENT_DIR, ignore_errors=True)

    # -- the unit through TpuCrackClient.run(), feed_workers=1 -------------
    packers = collections.Counter()   # thread name -> native pack calls
    real_pack = m.pack_candidates_fast

    def counting_pack(*args, **kwargs):
        packers[threading.current_thread().name] += 1
        return real_pack(*args, **kwargs)

    server = Server(blob, dhash)
    client, reg = make_client(server, CLIENT_DIR / "unit", 1, "feed_workers=1")
    m.pack_candidates_fast = counting_pack
    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    native.CALLS = 0
    try:
        t0 = time.perf_counter()
        done = client.run()
        wall = time.perf_counter() - t0
    finally:
        m.pack_candidates_fast = real_pack
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
    report_unit(client, reg, "feed_workers=1", unit_pmk_s, card)

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
    return launches


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
    return launches, err


def rules_unit(rng):
    """Phase 7c's unit: phase 6's five nets, each with its own PSK made by
    a different rule of the first 16 of wpa.rule from a base word planted
    in the dict's second block.  Returns the lines (each with its NC delta
    and endian), their PSKs, the dict's words, the rules text and the
    pass-1 ``cracked.txt.gz`` words (none of them a PSK)."""
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.rules import wpa_rules

    rules = wpa_rules()[:RULES_UNIT_RULES]
    picks = [1, 5, 7, 10, 15]          # 'c', 'C', '$1', '$?', '$9'
    bases = [b"rules7c-net%d-base" % k for k in range(5)]
    psks = [rules[r].apply(b) for r, b in zip(picks, bases)]
    lines = [
        (tfx.make_eapol_line(psks[0], ESSID, keyver=2, seed="r-k2a"), (0, "")),
        (tfx.make_pmkid_line(psks[1], ESSID, seed="r-pmk"), (0, "")),
        (tfx.make_eapol_line(psks[2], ESSID, keyver=2, nc_delta=-2, endian="BE", seed="r-k2b"),
         (-2, "BE")),
        (tfx.make_eapol_line(psks[3], ESSID, keyver=1, seed="r-k1"), (0, "")),
        (tfx.make_eapol_line(psks[4], ESSID, keyver=3, seed="r-k3"), (0, "")),
    ]
    words = random_words(rng, RULES_UNIT_WORDS, 8, 20)
    for k, b in enumerate(bases):
        words[UNIT_BATCH + (k + 1) * UNIT_BATCH // 6] = b
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dwpa_tpu_torch.client.challenge import challenge
    from dwpa_tpu_torch.ops import _nvcc, pbkdf2, pbkdf2_cuda, sm_probe
    from dwpa_tpu_torch.ops.sass import loop_opcodes, loop_span, sass_text

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = sm_probe.nvidia_smi("name,power.limit")
    print(f"phase 1 device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    so, probe_so = _nvcc.build(pbkdf2_cuda.SOURCE, sm_probe.SOURCE)
    build_s = time.perf_counter() - t0
    for lib in (so, probe_so):
        ptxas = lib.with_suffix(".ptxas.txt").read_text()
        regs = re.findall(r"Used \d+ registers.*", ptxas)
        print(f"phase 1 build: {lib.name}; ptxas: {'; '.join(regs) or ptxas.strip()}", flush=True)
    k1_sass = sass_text(so)
    loop_inst, other_inst = loop_span(k1_sass, "pbkdf2_sha1_pmk_kernel")
    k1_mix = loop_opcodes(k1_sass, "pbkdf2_sha1_pmk_kernel")
    steps = {mix: sm_probe.loop_sass(mix) for mix in sm_probe.MIXES}
    print(f"phase 1 build: both libraries in {build_s:.1f} s (one nvcc each, in parallel); "
          f"K1 SASS: {loop_inst} instructions per loop iteration (T1+T2), {other_inst} outside "
          f"the loop; probe SASS per {sm_probe.UNROLL}-step loop iteration: "
          f"{', '.join(f'{m} {n[0]} (+{n[1]} outside)' for m, n in steps.items())}", flush=True)
    print(f"phase 1 build: K1 loop opcodes {dict(k1_mix.most_common())}", flush=True)

    rng = np.random.default_rng(SEED)
    err = phase_kernel(dev, rng, card)

    pbkdf2_cuda.LAUNCHES = 0
    pbkdf2.CALLS = 0
    check(challenge(device=dev), "challenge gate failed")
    check(pbkdf2_cuda.LAUNCHES > 0 and pbkdf2.CALLS == 0, "challenge bypassed the kernel")
    print("phase 3 challenge: passed (aaaa1234 on the PMKID and EAPOL lines)", flush=True)

    launches, k1_ms, pw, step, words, unit_pmk_s = phase_unit(dev, rng, card)

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
    client_launches = phase_client(card, words, unit_pmk_s)
    expand_ms = phase_expand(dev, rng, card)
    rules_launches, rules_err = phase_rules_engine(dev, rng, card, expand_ms)
    err = max(err, rules_err)
    rules_client_launches = phase_rules_client(card, rng, unit_pmk_s)

    # K1's bounds.  Issue rate: every SM issues 4 x 32 thread-instructions
    # a clock at the maximum SM clock.  Probe rate: the thread-instructions
    # per second the sha1_round probe sustained on the whole card.
    sms = res["sms"]
    clock_hz = float(res["max_sm_clock"].split()[0]) * 1e6
    issue_per_s = sms * sm_probe.ISSUE_PER_SM_CLOCK * clock_hz
    probe_per_s = res["mixes"]["sha1_round"]["thread_inst_per_s"]
    b = pw.shape[0]
    k1_inst = b * (loop_inst * 4095 + other_inst)
    issue_ms = k1_inst / issue_per_s * 1e3
    probe_ms = k1_inst / probe_per_s * 1e3
    print(f"K1 bound: {b} rows x ({loop_inst} x 4095 + {other_inst}) SASS instructions; "
          f"issue rate ({sms} SMs x {sm_probe.ISSUE_PER_SM_CLOCK} x {clock_hz / 1e6:.0f} MHz) "
          f"{issue_ms:.3f} ms, K1 at {issue_ms / k1_ms:.1%} of it; probe rate (sha1_round "
          f"{probe_per_s:.6g} thread-instructions/s) {probe_ms:.3f} ms, K1 at "
          f"{probe_ms / k1_ms:.1%} of it; K1 {k1_ms:.3f} ms; plain version {plain_ms:.1f} ms "
          f"on the same batch [{card}]", flush=True)

    # K2's bound: the SASS thread-instructions of one full-width sha1_round
    # launch at the issue rate.
    probe_loop, probe_other = steps["sha1_round"]
    sha1 = res["mixes"]["sha1_round"]
    n_full = sms * sha1["threads_per_sm"]
    k2_bound_ms = n_full * (probe_loop * sm_probe.ITERS + probe_other) / issue_per_s * 1e3
    print(f"K2 bound: {n_full} threads x ({probe_loop} x {sm_probe.ITERS} + {probe_other}) SASS "
          f"instructions at the issue rate = {k2_bound_ms:.3f} ms; one launch "
          f"{sha1['seconds_1x'] * 1e3:.3f} ms [{card}]", flush=True)
    print(f"chip_smoke: phases 1-7 in {time.perf_counter() - t_start:.1f} s [{card}]")
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
                             "rules client (phase 7c)": rules_client_launches},
    }, {
        "name": "sm_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES, "launches": probe_launches, "max_abs_err": probe_err,
        "ms": sha1["seconds_1x"] * 1e3, "plain_ms": probe_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": "operations", "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
