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
   the ``sha1_round`` rate K1's measured bound beside its issue-rate one.

It then prints the kernel records as one JSON line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
nonzero and the ``ok`` line is not printed.  Without a CUDA device it
exits nonzero before doing anything.
"""

import hashlib
import json
import re
import statistics
import sys
import time

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
    return launches, k1_ms, pw, step


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dwpa_tpu_torch.client.challenge import challenge
    from dwpa_tpu_torch.ops import _nvcc, pbkdf2, pbkdf2_cuda, sm_probe
    from dwpa_tpu_torch.ops.sass import loop_opcodes, loop_span, sass_text

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

    launches, k1_ms, pw, step = phase_unit(dev, rng, card)

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
    print(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "pbkdf2_sha1_pmk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": min(issue_ms, probe_ms),
        "bound_by": "operations", "library_ms": None,
        "bound_model": "issue_rate" if issue_ms <= probe_ms else "probe_rate",
        "issue_bound_ms": issue_ms, "probe_bound_ms": probe_ms,
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
