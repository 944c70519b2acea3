"""The device trace of a window: ``torch.profiler`` over it, reduced to numbers.

The profiler records CUDA activity (kernels, copies, sets, through CUPTI,
whoever launched them: K1 and K3 come through ``ctypes``) and the host's
torch ops.  A marker at the window's open and close ties the trace's
clock to the host clock, so the client's spans (``perf_counter``) can
label the device's idle gaps.  The reduction reads the exported Chrome
trace: device intervals, their union (busy time) inside the window,
time by kernel name, and idle gaps by the innermost client span that
was open at their midpoint.
"""

import json
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OPEN, CLOSE = "port_bench.window_open", "port_bench.window_close"
TOP = 10


def warm_profiler():
    """One short profile in set-up, so the window's start pays no CUPTI
    initialisation."""
    import torch

    with _profile():
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _profile():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


class WindowTrace:
    """Started at the window's open (``begin_trace``), ended after it
    (``end_trace``); ``numbers`` reduces the trace."""

    def __init__(self, out_path):
        self.out_path = out_path
        self.prof = None
        self.pc = {}

    def _stamp(self, name):
        import torch

        with torch.profiler.record_function(name):
            self.pc[name] = time.perf_counter()

    def begin_trace(self):
        self.prof = _profile()
        self.prof.start()
        self._stamp(OPEN)

    def end_trace(self):
        import torch

        torch.cuda.synchronize()
        self._stamp(CLOSE)
        self.prof.stop()
        self.prof.export_chrome_trace(str(self.out_path))
        self.prof = None

    def numbers(self, spans):
        """-> dict: ``busy_s``, ``window_s``, ``device_s`` (summed op time),
        ``by_name`` {kernel: s}, ``device_ops`` and ``idle_gaps`` (top
        lists).  ``spans``: client span records (``t0``/``t1`` on
        ``perf_counter``) to label the gaps with."""
        with open(self.out_path) as f:
            events = json.load(f)["traceEvents"]
        marks = {e["name"]: e["ts"] for e in events if e.get("name") in (OPEN, CLOSE)
                 and e.get("ph") == "X" and e.get("cat") == "user_annotation"}
        t0, t1 = marks[OPEN], marks[CLOSE]
        shift = t0 - self.pc[OPEN] * 1e6          # trace us = perf_counter us + shift
        ivals, by_name = [], defaultdict(float)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            ivals.append((a, b))
            by_name[short_name(e["name"])] += (b - a) / 1e6
        ivals.sort()
        busy, gaps, end = 0.0, [], t0
        for a, b in ivals:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if end < t1:
            gaps.append((end, t1))
        labelled = defaultdict(float)
        for a, b in gaps:
            labelled[_label((a + b) / 2 - shift, spans)] += (b - a) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy / 1e6, "window_s": (t1 - t0) / 1e6,
                "device_s": sum(by_name.values()), "by_name": dict(by_name),
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in
                              sorted(labelled.items(), key=lambda kv: -kv[1])[:TOP]]}


def short_name(name: str) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::`` and its
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip() or name


def _label(t_us, spans):
    """The innermost span open at ``t_us`` (perf_counter microseconds)."""
    best = None
    for s in spans:
        if s["t0"] * 1e6 <= t_us <= s["t1"] * 1e6 and (best is None or s["depth"] > best["depth"]):
            best = s
    return "no client span" if best is None else best["name"]


def kernel_seconds(reduced, *names):
    """Summed device time of the kernels whose name contains any of ``names``."""
    return sum(s for k, s in reduced["by_name"].items() if any(n in k for n in names))
