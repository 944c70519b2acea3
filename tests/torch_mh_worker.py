"""Subprocess worker for ``tests/test_torch_multihost.py`` (not collected
by pytest): one process of a two-process ``torch.distributed`` slice
over gloo on the CPU, running the port only (no JAX import).

``python torch_mh_worker.py engine <pid> <coord_port>`` joins the slice
and runs the engine paths (sharded dict blocks, a replicated batch,
the flat ``crack_rules``, a mask with shares, a share of invalid words)
and the telemetry merge, printing one ``RESULT <json>`` line.
``python torch_mh_worker.py client <pid> <coord_port> <url> <workdir>
[version]`` runs the port's client CLI as one process of the slice
(``version`` patches this process's client version: the mixed-slice
refusal).  PMKs come from hashlib, as in the port's other CPU tests.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

BATCH = 32
RULES = [":", "u", "c $1 $2", "@a"]


def dict_lines(tfx):
    return [
        tfx.make_pmkid_line(b"stream-pass-a", b"StreamNetA", seed="st1"),
        tfx.make_eapol_line(b"stream-pass-b", b"StreamNetB", keyver=2, seed="st2"),
        tfx.make_eapol_line(b"stream-pass-c", b"StreamNetC", keyver=3, seed="st3"),
        tfx.make_pmkid_line(b"not-in-keyspace", b"StreamNetD", seed="st4"),
    ]


def dict_words():
    """230 words: global blocks of 64 put pass-a in process 0's share of
    block 0, pass-b in process 1's share of block 0 and pass-c in process
    1's share of block 1; the last block (38 words) leaves process 1 only
    words too short to try, so it dispatches padding."""
    words = [b"stjunk%04d" % i for i in range(230)]
    words[3] = b"stream-pass-a"
    words[40] = b"stream-pass-b"
    words[100] = b"stream-pass-c"
    words[211:230] = [b"x%d" % i for i in range(19)]
    return words


def rules_lines(tfx):
    return [tfx.make_pmkid_line(p, b"MeshNet", seed=s) for p, s in (
        (b"MESHWORD77!", "rm1"), (b"Meshtwo88!12", "rm2"), (b"hexword99", "rm4"),
        (b"never-in-keyspace", "rm3"))]


def rules_words():
    words = [b"mshjunk%04d" % i for i in range(96)]
    words[5] = b"meshword77!"
    words[70] = b"meshtwo88!"
    words[40] = b"y" * 70
    words[41] = b"z" * 63
    words[80] = b"$HEX[" + b"hexword99".hex().encode() + b"]"
    return words


MASK = "?d?d?d?d?d?d?d?d"
MASK_PSKS = (b"00000041", b"00000150")   # process 1's share of block 0, block 2's


def mask_lines(tfx):
    return [tfx.make_pmkid_line(p, b"MaskNet%d" % i, seed=f"mk{i}")
            for i, p in enumerate(MASK_PSKS)] + [
        tfx.make_eapol_line(b"00000199", b"MaskNet9", keyver=2, seed="mk9")]


def keys(founds):
    return [[f.line.raw, f.psk.hex(), f.nc, f.endian, f.pmk.hex()] for f in founds]


def engine_paths(pid):
    from torch_fixtures import hashlib_pmk

    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import frame_blocks
    from dwpa_tpu_torch.models import m22000 as tm
    from dwpa_tpu_torch.obs import MetricsRegistry, allgather_json, merged_slice_snapshot
    from dwpa_tpu_torch.rules import parse_rules

    tm._pmk_impl = hashlib_pmk
    out = {}
    reg = MetricsRegistry()
    reg.counter("dwpa_client_founds_total", "founds").inc(pid + 1)
    out["gathered"] = allgather_json({"pid": pid, "tag": "x" * (3 + 40 * pid)})
    out["merged"] = merged_slice_snapshot(reg).value("dwpa_client_founds_total")

    def log_into(into):
        return lambda c, f: into.append([c, sorted(x.psk.hex() for x in f)])

    eng = tm.M22000Engine(dict_lines(tfx), batch_size=BATCH, device="cpu")
    log = []
    founds = eng.crack_blocks(frame_blocks(iter(dict_words()), BATCH, nproc=2, pid=pid),
                              on_batch=log_into(log))
    out["dict"] = {"founds": keys(founds), "log": log,
                   "live": sorted(n.line.raw for n in eng.nets)}

    eng = tm.M22000Engine(dict_lines(tfx), batch_size=BATCH, device="cpu")
    rep = eng.crack_batch([b"stjunk-%04d" % i for i in range(30)] + [b"stream-pass-b"])
    out["replicated"] = keys(rep)

    eng = tm.M22000Engine(rules_lines(tfx), batch_size=BATCH, device="cpu")
    log = []
    founds = eng.crack_rules(iter(rules_words()), parse_rules(RULES),
                             on_batch=log_into(log), skip=22)
    out["rules"] = {"founds": keys(founds), "log": log}

    eng = tm.M22000Engine(mask_lines(tfx), batch_size=BATCH, device="cpu")
    log = []
    founds = eng.crack_mask(MASK, limit=200, on_batch=log_into(log))
    out["mask"] = {"founds": keys(founds), "log": log}
    print("RESULT " + json.dumps(out), flush=True)


def client(pid, port, url, workdir, version):
    from torch_fixtures import hashlib_pmk

    import dwpa_tpu_torch
    import dwpa_tpu_torch.client.main as cm
    from dwpa_tpu_torch.client.__main__ import main as cli_main
    from dwpa_tpu_torch.models import m22000 as tm

    tm._pmk_impl = hashlib_pmk
    if version:
        dwpa_tpu_torch.__version__ = cm.__version__ = version
    valid = []
    real = tm.M22000Engine._dispatch

    def counting(self, prep):
        valid.append(prep[1])
        return real(self, prep)

    tm.M22000Engine._dispatch = counting
    work = os.path.join(workdir, f"p{pid}")
    cli_main(["--url", url, "--workdir", work, "--device", "cpu", "-n", "1",
              "-b", str(BATCH), "--backoff", "0.1", "--coordinator",
              f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid)])
    from dwpa_tpu_torch.obs import default_registry

    reg = default_registry()
    spans = {s["labels"]["span"]: s["sum"] for s in
             reg.snapshot()["dwpa_span_seconds"]["samples"]}
    pot = os.path.join(work, "potfile")
    print("RESULT " + json.dumps({
        "pid": pid, "pot": open(pot).read() if os.path.exists(pot) else "",
        "valid": valid, "pass2_pmk_s": reg.value("dwpa_client_pmk_per_s", **{"pass": "2"}),
        "pass2_s": spans["pass2"]}), flush=True)


def main():
    mode, pid, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if mode == "engine":
        from dwpa_tpu_torch.parallel.mesh import multihost_mesh, process_count

        sl = multihost_mesh(coordinator=f"127.0.0.1:{port}", num_processes=2,
                            process_id=pid, device="cpu", timeout_s=120)
        assert (sl.rank, sl.size, str(sl.device)) == (pid, 2, "cpu") == (
            pid, process_count(), "cpu")
        engine_paths(pid)
        from dwpa_tpu_torch.parallel.mesh import leave_slice

        leave_slice()
    else:
        client(pid, port, sys.argv[4], sys.argv[5], sys.argv[6] if len(sys.argv) > 6 else "")


if __name__ == "__main__":
    main()
