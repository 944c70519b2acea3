"""Measured SM integer-throughput ceiling on the GPU (the K2 probe).

The counterpart of ``dwpa_tpu/ops/vpu_probe.py``: the same four op mixes
(``add``, ``xor``, ``rotl``, ``sha1_round``), each carried by 5 words per
element through ``iters x UNROLL`` dependent applications, then the xor
of the 5 words.  The kernel (``csrc/sm_probe.cu``) keeps one element per
thread in registers; :func:`probe_plain` is the same function in int32
torch ops.  :func:`measure` times a mix with the JAX probe's differential
method, ``(t(3 iters) - t(iters)) / 2 iters``, which cancels the fixed
launch cost, and reports

- the rate of the mix's logical ops (``tera_ops_per_s``, as the JAX probe
  counts them), and
- the rate of its machine instructions: SASS instructions per unrolled
  step, read from the compiled loop (``ops/sass.py``), and the sustained
  thread-instructions per SM per clock.

The ``sha1_round`` rate divided by the op census (``ops/opcount.py``)
gives the attainable PMK/s ceiling; its instruction rate gives K1's
measured bound in ``chip_smoke.py``.

Run on the GPU: ``python -m dwpa_tpu_torch.ops.sm_probe`` (one JSON line).
Without a CUDA device it exits nonzero; there is no CPU fallback.
"""

import ctypes
import functools
import statistics
import subprocess
import sys
import threading

import numpy as np
import torch

from . import _nvcc
from .common import rotl32, s32, to_torch
from .sass import loop_opcodes, loop_span, sass_text

SOURCE = _nvcc.CSRC / "sm_probe.cu"
K0 = 0x5A827999
#: Mix applications per loop iteration (``kUnroll`` in the kernel), and
#: loop iterations of one timed launch (the JAX probe's).
UNROLL = 64
ITERS = 20_000
#: Threads per block (``kBlock``) and the most resident threads per SM.
BLOCK = 128
MAX_THREADS_PER_SM = 2048
#: Thread-instructions an SM can issue per clock: 4 schedulers x 32 lanes.
ISSUE_PER_SM_CLOCK = 128
#: Fewest SASS instructions one step of each mix takes when nothing is
#: folded.  add, xor and rotl write 5 words a step, each read twice (add,
#: xor) or rotated again (rotl) in the next step, so no instruction can
#: serve two steps without algebra.  sha1_round needs a LEA.HI (rotl(a, 5)
#: + e in one), a LOP3 (Ch), an SHF (rotl(b, 30)) and an IADD3 (f + K0).
MIN_SASS_PER_STEP = {"add": 5, "xor": 5, "rotl": 5, "sha1_round": 4}

#: Kernel launches made by :func:`probe_cuda` in this process.
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()  # first use may come from any thread


def _mix_add(st):
    a, b, c, d, e = st
    return (a + b, b + c, c + d, d + e, e + a)


def _mix_xor(st):
    a, b, c, d, e = st
    return (a ^ b, b ^ c, c ^ d, d ^ e, e ^ a)


def _mix_rotl(st):
    return tuple(rotl32(x, 5 + i) for i, x in enumerate(st))


def _mix_sha1_round(st):
    a, b, c, d, e = st
    f = d ^ (b & (c ^ d))
    return (rotl32(a, 5) + f + e + s32(K0), a, rotl32(b, 30), c, d)


MIXES = {
    # name: (body, logical ops per application, kernel name)
    "add": (_mix_add, 5, "sm_probe_add"),
    "xor": (_mix_xor, 5, "sm_probe_xor"),
    "rotl": (_mix_rotl, 15, "sm_probe_rotl"),
    "sha1_round": (_mix_sha1_round, 12, "sm_probe_sha1_round"),
}


def probe_plain(x, mix, iters):
    """The probe in plain torch: int32[5, N] -> int32[N]."""
    body = MIXES[mix][0]
    st = tuple(x[k] for k in range(5))
    for _ in range(iters * UNROLL):
        st = body(st)
    out = st[0]
    for w in st[1:]:
        out = out ^ w
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_nvcc.build(SOURCE)[0]))
            fn = lib.sm_probe_launch
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def probe_cuda(x, mix, iters):
    """The probe kernel on ``x``'s card: contiguous int32[5, N] -> int32[N],
    bit-identical to :func:`probe_plain`.  Launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r}; one of {sorted(MIXES)}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != 5 or x.shape[1] >= 2**31:
        raise ValueError(f"x must be int32[5, N], got {x.dtype}{list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("probe_cuda needs a contiguous tensor")
    if not x.is_cuda:
        raise ValueError("probe_cuda needs a CUDA tensor")
    if not 1 <= iters < 2**31:
        raise ValueError(f"iters out of range: {iters}")
    fn = _library().sm_probe_launch
    n = x.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(list(MIXES).index(mix), x.data_ptr(), out.data_ptr(), n, iters, stream)
    if err != 0:
        raise RuntimeError(f"sm_probe kernel launch failed: cudaError {err}")
    if n:
        LAUNCHES += 1
    return out


def nvidia_smi(query):
    """One ``nvidia-smi --query-gpu`` field set of the first card, as text."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _sass():
    return sass_text(_nvcc.library_path(SOURCE))


def loop_sass(mix):
    """(SASS instructions of the mix's loop, instructions outside it);
    the loop is one iteration of ``UNROLL`` steps."""
    return loop_span(_sass(), MIXES[mix][2])


def _timed(x, mix, iters, reps, sample_clock):
    """Median seconds of ``reps`` launches (CUDA events, after a warm-up
    launch), and ``clocks.sm`` read while they run if ``sample_clock``."""
    probe_cuda(x, mix, iters)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        probe_cuda(x, mix, iters)
        end.record()
    clock = nvidia_smi("clocks.sm") if sample_clock else None
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / 1e3 for s, e in events), clock


def measure(mix, *, threads_per_sm=MAX_THREADS_PER_SM, iters=ITERS, reps=5):
    """Sustained rates of one mix on the whole card, with
    ``threads_per_sm`` resident threads on every SM, by differential
    timing: ``(t(3 iters) - t(iters)) / 2 iters``."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure needs a CUDA device")
    if mix not in MIXES or threads_per_sm % BLOCK or not 0 < threads_per_sm <= MAX_THREADS_PER_SM:
        raise ValueError(f"bad probe shape: mix={mix!r} threads_per_sm={threads_per_sm}")
    _, nops, _ = MIXES[mix]
    props = torch.cuda.get_device_properties(0)
    n = props.multi_processor_count * threads_per_sm
    rng = np.random.default_rng(7)
    x = to_torch(rng.integers(0, 2**32, (5, n), dtype=np.uint64).astype(np.uint32),
                 torch.device("cuda", 0))
    t1, _ = _timed(x, mix, iters, reps, False)
    t3, clock = _timed(x, mix, 3 * iters, reps, True)
    loop, _ = loop_sass(mix)
    dt = max(t3 - t1, 1e-9)
    inst_per_s = 2 * iters * loop * n / dt
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return {
        "mix": mix,
        "threads_per_sm": threads_per_sm,
        "ops_per_iter": nops,
        "seconds_1x": t1,
        "seconds_3x": t3,
        "tera_ops_per_s": 2 * iters * UNROLL * nops * n / dt / 1e12,
        "sass_per_step": loop / UNROLL,
        "folded": loop / UNROLL < MIN_SASS_PER_STEP[mix],
        "thread_inst_per_s": inst_per_s,
        "thread_inst_per_sm_clock": inst_per_s / (props.multi_processor_count * max_clock_hz),
        "sm_clock_during_3x": clock,
    }


def run():
    """The four mixes at full width, the ``sha1_round`` sweep over resident
    threads per SM, and the PMK/s ceiling, as one dict."""
    from .opcount import element_ops_per_pmk, pbkdf2_iteration_census

    out = {
        "device": torch.cuda.get_device_name(0),
        "card": nvidia_smi("name,power.limit"),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "max_sm_clock": nvidia_smi("clocks.max.sm"),
        "sm_clock_before": nvidia_smi("clocks.sm"),
        "mixes": {mix: measure(mix) for mix in MIXES},
    }
    # The sweep's last point is the full-width run above.
    sweep = {str(t): measure("sha1_round", threads_per_sm=t) for t in (128, 256, 512, 1024)}
    sweep[str(MAX_THREADS_PER_SM)] = out["mixes"]["sha1_round"]
    out["sha1_round_threads_per_sm"] = sweep
    out["sm_clock_after"] = nvidia_smi("clocks.sm")
    out["loop_opcodes"] = {mix: dict(loop_opcodes(_sass(), kernel))
                           for mix, (_, _, kernel) in MIXES.items()}
    out["folded"] = [mix for mix, r in out["mixes"].items() if r["folded"]]
    ops_pmk = element_ops_per_pmk(pbkdf2_iteration_census(hoisted=True))
    out["element_ops_per_pmk"] = ops_pmk
    out["ceiling_pmk_per_s"] = out["mixes"]["sha1_round"]["tera_ops_per_s"] * 1e12 / ops_pmk
    return out


def main():
    import json

    if not torch.cuda.is_available():
        print("sm_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
