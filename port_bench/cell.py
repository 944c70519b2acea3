"""One run of one cell: set-up, the measured window, the reference's verdict.

Set-up makes the mix's dicts and the units from the seed, has the
client's dict cache hold the pool where the traffic asks for it (packed
by the first run in a checkout, kept for the next, as a volunteer's
is), puts the pool's dicts where the client downloads them, and starts
``TpuCrackClient.run()`` against the in-process server: the client's
challenge and prewarm, then one warm unit of the cell's own shapes over
one dict.  The window opens at the next ``get_work`` and holds only
whole units; after ``seconds`` the server answers ``No nets`` and the
client's nap ends the run.  Once it has closed and the device's peak
memory is read, the program's state is freed and the reference judges
every unit the window handed out (and the warm one): each planted net
reported with its PSK, each reported PSK cracking its net, the potfile
holding exactly the finds.  Kernel and native-library builds inside the
window are counted beside them: the warm unit leaves none to build.
"""

import contextlib
import os
import shutil
import time
from dataclasses import dataclass, field

from . import census, gen
from . import reference as ref
from .server import BenchServer, WindowClosed


@dataclass
class Window:
    """What the per-layer readers see of a window."""

    seconds: float
    units: list                      # gen.Unit handed out in the window
    results: list                    # the client's WorkResult of each
    pmks: int                        # PMKs of the window's units (candidates x ESSIDs)
    metrics_before: dict
    metrics_after: dict
    spans: list                      # client span records inside the window
    k1_launches: int
    trace: dict = None               # trace.WindowTrace.numbers(), traced runs
    peak_inst_per_s: float = None    # the card's issue rate, where known
    extra: dict = field(default_factory=dict)


def histogram_sum(snapshot, family):
    return sum(s["sum"] for s in snapshot.get(family, {}).get("samples", ()))


def counter_sum(snapshot, family):
    return sum(s["value"] for s in snapshot.get(family, {}).get("samples", ()))


def _fill_cache(root, dicts, registry, rules):
    """Pack every dict of the pool into the client's dict cache (as rules
    bases where the mix has rules)."""
    from dwpa_tpu_torch.feed import DictCache

    cache = DictCache(root, registry=registry)
    for d in dicts:
        reader, writer = cache.entry(d.dhash, rules=bool(rules))
        if reader is not None:
            reader.close()
            continue
        writer.add_many(d.words)
        if not writer.commit():
            raise RuntimeError(f"the dict cache refused dict {d.dhash}")


def judge(units, server, potfile, nc):
    """The reference's counts over ``units``: planted nets not reported
    with their PSK, reported PSKs that do not crack their net, units
    with no ``put_work``, and potfile lines off the planted finds."""
    missed = wrong = unanswered = failed = 0
    expected_pot = set()
    for u in units:
        subs = server.submissions.get(u.hkey)
        expected_pot.update((u.by_bssid[b], psk) for b, psk in u.planted.items())
        if not subs:
            unanswered += 1
            failed += 1
            continue
        reported = {(c["k"], bytes.fromhex(c["v"])) for cand in subs for c in cand}
        miss = sum((b, psk) not in reported for b, psk in u.planted.items())
        bad = sum(u.by_bssid.get(b) is None or not ref.check_psk(u.by_bssid[b], psk, nc)
                  for b, psk in reported)
        missed, wrong, failed = missed + miss, wrong + bad, failed + bool(miss or bad)
    got_pot = set()
    if os.path.exists(potfile):
        with open(potfile, "rb") as f:
            for row in f.read().splitlines():
                line, _, psk = row.partition(b":")
                got_pot.add((line.decode(), psk.decode("utf-8").encode("latin1")))
    return {"missed": missed, "wrong": wrong, "unanswered": unanswered,
            "potfile": len(got_pot ^ expected_pot)}, failed


def run_cell(config, traffic, seed, seconds, trace_path, workdir, device="cuda:0",
             t_start=None, nc=None, log=print, at_open=None, cache_root=None):
    """One run.  ``trace_path``: where the traced run writes its trace (None:
    untraced).  ``cache_root``: where the client's dict cache lives (kept
    from run to run; default ``workdir``, emptied each run).  ``nc``: the nonce error corrections the client runs with
    (default the configuration's; the control runs it lower).  ``at_open``:
    called as the window opens (the tests plant faults there, past the
    client's own challenge).  Returns (Window, checks, setup_s,
    memory_peak_bytes)."""
    import torch

    from dwpa_tpu_torch.analysis.recompile import watch_compiles
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.ops import pbkdf2_cuda

    from . import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
    t = {"torch": time.perf_counter()}
    rng = gen.make_rng(seed)
    dicts = gen.make_dicts(config, traffic)
    t["dicts"] = time.perf_counter()
    rules = gen.traffic_rules(traffic)
    count = 1 + gen.window_units(seconds, config, traffic, len(rules))
    units = gen.make_units(rng, config, traffic, dicts, count, first_dicts=1)
    t["units"] = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    reg = MetricsRegistry()
    cache_dir = None
    if traffic["dict_cache"]:
        cache_dir = os.path.join(cache_root or workdir, "dict_cache")
        _fill_cache(cache_dir, dicts, reg, rules)
    t["cache"] = time.perf_counter()
    wt = None
    if trace_path is not None:
        tr.warm_profiler()
        wt = tr.WindowTrace(trace_path)
    t["profiler"] = time.perf_counter()
    state = {}
    watch = contextlib.ExitStack()

    def on_open():
        t["client"] = time.perf_counter()
        state["metrics"] = reg.snapshot()
        state["k1"] = pbkdf2_cuda.LAUNCHES
        state["builds"] = watch.enter_context(watch_compiles())
        if at_open is not None:
            at_open()
        if wt is not None:
            wt.begin_trace()

    server = BenchServer(units, seconds, on_open=on_open)
    cfg_nc = config["nonce_error_corrections"] if nc is None else nc
    cfg = ClientConfig(base_url=server.base_url, workdir=os.path.join(workdir, "client"),
                       batch_size=config["batch_size"], dictcount=config["dictcount"],
                       nc=cfg_nc, device=device, dict_cache_dir=cache_dir)
    client = TpuCrackClient(cfg, api=server, registry=reg, log=lambda msg: None)
    # a volunteer who has run before holds the server's dicts on disk
    for d in dicts:
        server.download(d.dpath, os.path.join(client.dictdir, d.dhash + ".gz"),
                        expected_md5=d.dhash)
    results = []
    work = client.process_work

    def record_unit(w):
        res = work(w)
        if server.t_open is not None:
            results.append(res)
        return res

    client.process_work = record_unit
    try:
        client.run()
        raise RuntimeError("the client's run ended before the window closed")
    except WindowClosed:
        t_close = time.perf_counter()
    finally:
        watch.close()
    if wt is not None:
        wt.end_trace()
    if cuda:
        torch.cuda.synchronize()
    window_s = t_close - server.t_open
    setup_s = server.t_open - t_start
    marks, last = [], t_start
    for k, v in t.items():
        marks.append(f"{k} {v - last:.3f}")
        last = v
    before = [f"{s['name']} {s['t1'] - s['t0']:.3f}" for s in client.tracer.finished
              if s["t1"] <= server.t_open and s["depth"] == 0]
    log(f"set-up {setup_s:.3f} s: {', '.join(marks)} (client spans: {', '.join(before)})")
    log("window units: " + " ".join(f"{s['t1'] - s['t0']:.3f}" for s in client.tracer.finished
                                     if s["name"] == "work_unit" and s["t0"] >= server.t_open)
        + f" s; window {window_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = [s for s in client.tracer.finished if s["t0"] >= server.t_open]
    win_units = server.units_in_window()
    k1 = pbkdf2_cuda.LAUNCHES - state["k1"]
    metrics_after = reg.snapshot()
    potfile = client.potfile
    if server.ran_out:
        log(f"the server ran out of its {len(units) - 1} window units before {seconds} s")
    del client, work    # the program's state goes before the reference runs

    checks, failed = judge(units[:server.issued], server, potfile,
                           config["nonce_error_corrections"])
    checks["builds"] = state["builds"].count
    if state["builds"].count:
        log(f"built inside the window: {state['builds'].names}")
    pmks = sum(u.words for u in win_units)
    w = Window(seconds=window_s, units=win_units, results=results, pmks=pmks,
               metrics_before=state["metrics"], metrics_after=metrics_after, spans=spans,
               k1_launches=k1)
    if wt is not None:
        w.trace = wt.numbers(spans)
    if cuda:
        w.peak_inst_per_s = issue_rate(torch.cuda.get_device_name(0),
                                       torch.cuda.get_device_properties(0).multi_processor_count)
    w.extra["k3_inst"] = k3_window_inst(win_units, config["nonce_error_corrections"])
    w.extra["failed"] = failed
    return w, checks, setup_s, peak


def issue_rate(kind, sms):
    """Thread-instructions a second the card issues at most: every SM 4
    schedulers x 32 lanes a clock at the maximum SM clock (``peaks.json``);
    None for a card the table lacks."""
    import json
    from pathlib import Path

    peaks = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    p = peaks.get(kind)
    return None if p is None else sms * p["thread_inst_per_sm_clock"] * p["max_sm_clock_hz"]


def k3_window_inst(units, nc):
    """K3's instructions over the window's PMKs (None where the counts
    lack a part)."""
    total = 0
    for u in units:
        per = census.k3_inst_per_column(u.lines, nc)
        if per is None:
            return None
        total += per * u.words
    return total
