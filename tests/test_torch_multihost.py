"""Multi-process slices of the port (``torch.distributed`` over gloo, on
the CPU) held to the single-process port and to ``dwpa_tpu``.

Two worker processes (``tests/torch_mh_worker.py``) join one slice on
127.0.0.1, each cracking on ``device="cpu"`` with hashlib PMKs:

- the telemetry merge: ``allgather_json`` of unequal payloads and
  ``merged_slice_snapshot``;
- the engine: sharded dict blocks (the planted PSKs in both processes'
  shares, the last share all padding), a replicated batch, the flat
  ``crack_rules`` over the global stream with a resume skip, and a mask
  whose blocks each process generates a share of — every process must
  decode IDENTICAL founds and ``on_batch`` sequences, equal to the
  single-process port's and the JAX engine's on one device;
- the client: a slice whose processes run different versions refuses to
  start on both; the two-process client against the port's server over a
  real socket on 127.0.0.1 cracks a dict unit and a rules unit with
  exactly one ``get_work`` and one ``put_work``, and process 0 alone
  reports the slice's PMK/s.

Every subprocess has its own timeout; a hung collective fails the test
instead of stalling the run.
"""

import gzip
import hashlib
import json
import os
import socket
import socketserver
import subprocess
import sys
import threading

import jax
import pytest
import torch
from torch_fixtures import hashlib_pmk

import torch_mh_worker as W
from dwpa_tpu import testing as jtfx
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.rules import parse_rules as jparse_rules
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.feed import frame_blocks
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.rules import parse_rule, parse_rules
from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mh_worker.py")
CPU = torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the workers' torch runs one intra-op thread: the suite runs beside
#: other test processes on a shared host
WORKER_ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _run_pair(args_of, timeout):
    """Both workers of a slice; kills both if either hangs."""
    procs = [subprocess.Popen([sys.executable, WORKER, *args_of(pid)], env=WORKER_ENV,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    try:
        return procs, [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)
        raise


def _result(out):
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _keys(founds):
    return sorted(W.keys(founds))


@pytest.fixture(scope="module")
def slice_results():
    port = str(_free_port())
    procs, outs = _run_pair(lambda pid: ["engine", str(pid), port], timeout=180)
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    return [_result(o[0]) for o in outs]


@pytest.fixture
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


def _jax_engine(lines):
    return jm.M22000Engine(lines, batch_size=W.BATCH,
                           mesh=default_mesh(devices=jax.devices()[:1]))


def _port_engine(lines):
    return tm.M22000Engine(lines, batch_size=W.BATCH, device=CPU)


def test_slice_telemetry_merge(slice_results):
    """``allgather_json`` returns every process's payload in rank order
    (unequal lengths padded and trimmed); the merged snapshot sums the
    counters, identically on both processes."""
    for res in slice_results:
        assert [g["pid"] for g in res["gathered"]] == [0, 1]
        assert [len(g["tag"]) for g in res["gathered"]] == [3, 43]
        assert res["merged"] == 3


def test_slice_processes_decode_identical_founds(slice_results):
    """Every engine path gives both processes the same founds in the same
    order and the same on_batch sequence: the global hits gate and the
    hit exchange keep the slice's engines in step."""
    p0, p1 = slice_results
    for path in ("dict", "replicated", "rules", "mask"):
        assert p0[path] == p1[path], path


def test_slice_dict_blocks_equal_single_process_and_jax(slice_results, _hashlib_pmks):
    """Sharded dict blocks: the founds equal the single-process port's and
    the JAX engine's over the same words; each global block reports its
    global count (the last, whose second share is padding, too)."""
    res = slice_results[0]["dict"]
    port = _port_engine(W.dict_lines(tfx))
    single = port.crack_blocks(frame_blocks(iter(W.dict_words()), W.BATCH))
    jeng = _jax_engine(W.dict_lines(jtfx))
    jax_founds = jeng.crack(iter(W.dict_words()))
    assert sorted(map(tuple, res["founds"])) == [tuple(k) for k in _keys(single)] == [
        tuple(k) for k in _keys(jax_founds)]
    assert [c for c, _ in res["log"]] == [64, 64, 64, 38]
    assert [len(f) for _, f in res["log"]] == [2, 1, 0, 0]
    assert res["live"] == sorted(n.line.raw for n in port.nets) == sorted(
        n.line.raw for n in jeng.nets)
    rep = _port_engine(W.dict_lines(tfx)).crack_batch(
        [b"stjunk-%04d" % i for i in range(30)] + [b"stream-pass-b"])
    assert slice_results[0]["replicated"] == W.keys(rep)


def test_slice_flat_crack_rules_equals_single_process_and_jax(slice_results, _hashlib_pmks):
    """The flat crack_rules over the global stream (each process uploads
    its row slice, the masks are gathered) finds what the single-process
    port and the JAX engine's crack_rules find from the same skip, and
    reports the same expanded total."""
    res = slice_results[0]["rules"]
    rules = parse_rules(W.RULES)
    single = _port_engine(W.rules_lines(tfx)).crack_rules(iter(W.rules_words()), rules,
                                                          skip=22)
    jax_founds = _jax_engine(W.rules_lines(jtfx)).crack_rules(
        iter(W.rules_words()), jparse_rules(W.RULES), skip=22)
    assert sorted(map(tuple, res["founds"])) == [tuple(k) for k in _keys(single)] == [
        tuple(k) for k in _keys(jax_founds)]
    assert len(res["founds"]) == 3
    assert sum(c for c, _ in res["log"]) == len(W.rules_words()) * len(rules) - 22


def test_slice_mask_shares_equal_single_process(slice_results, _hashlib_pmks):
    """A mask whose every block each process generates half of: the
    founds (in both processes' shares and the short last block) equal the
    single-process port's, and the on_batch sequence is its per block."""
    res = slice_results[0]["mask"]
    log = []
    single = _port_engine(W.mask_lines(tfx)).crack_mask(
        W.MASK, limit=200, on_batch=lambda c, f: log.append([c, sorted(x.psk.hex() for x in f)]))
    assert sorted(map(tuple, res["founds"])) == [tuple(k) for k in _keys(single)]
    assert res["log"] == log and len(single) == 3


def test_mixed_version_slice_refuses_to_start(tmp_path):
    """A slice whose processes run different client builds exits with a
    clear error on EVERY process before any work (stream order is
    version-dependent)."""
    port = str(_free_port())
    procs, outs = _run_pair(
        lambda pid: ["client", str(pid), port, "http://127.0.0.1:9/", str(tmp_path),
                     "0.0.0-mixed" if pid == 1 else ""], timeout=120)
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode != 0, (pid, out, err[-800:])
        assert "mixed client versions" in err, (pid, err[-800:])


@pytest.mark.parametrize("kind", ["dict", "rules"])
def test_two_process_client_single_volunteer(tmp_path, kind):
    """The port's client as ONE two-process volunteer against the port's
    server over a real socket on 127.0.0.1: process 0 makes every server
    call once (one get_work, one put_work), both processes decode the
    find, the net ends cracked server-side, and process 0 alone logs the
    slice's PMK/s.  The dict unit's PSK sits in process 1's share of
    pass 2; the rules unit's is reachable only through a device rule."""
    from wsgiref.simple_server import WSGIServer, make_server

    core = ServerCore(Database(str(tmp_path / "wpa.db")), dictdir=str(tmp_path / "dicts"),
                      capdir=str(tmp_path / "caps"))
    os.makedirs(core.dictdir, exist_ok=True)
    base = [b"mhcword%03d" % i for i in range(100)]
    if kind == "rules":
        psk, rules = parse_rule("u").apply(base[23]), "u\n$Z"
    else:
        psk, rules = base[40], None
    core.add_hashlines([tfx.make_pmkid_line(psk, b"MhcNet", seed="mhc"),
                        tfx.make_eapol_line(psk, b"MhcNet", keyver=2, seed="mhc2")])
    blob = gzip.compress(b"\n".join(base) + b"\n")
    with open(os.path.join(core.dictdir, "mhc.txt.gz"), "wb") as f:
        f.write(blob)
    core.add_dict("dict/mhc.txt.gz", "mhc.txt.gz", hashlib.md5(blob).hexdigest(),
                  len(base), rules=rules)
    core.db.x("UPDATE nets SET algo = ''")

    hits = {"get_work": 0, "put_work": 0}
    app = make_wsgi_app(core)

    def counting_app(environ, start_response):
        q = environ.get("QUERY_STRING", "")
        for k in hits:
            if k in q:
                hits[k] += 1
        return app(environ, start_response)

    class TS(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    srv = make_server("127.0.0.1", 0, counting_app, server_class=TS)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = str(_free_port())
        url = f"http://127.0.0.1:{srv.server_address[1]}/"
        procs, outs = _run_pair(
            lambda pid: ["client", str(pid), port, url, str(tmp_path), ""], timeout=240)
    finally:
        srv.shutdown()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    res = [_result(o[0]) for o in outs]
    for r in res:
        assert r["pot"].count(":" + psk.decode()) == 2, r["pot"]
    # the slice's collects paired up: equal dispatch counts on both
    assert len(res[0]["valid"]) == len(res[1]["valid"])
    rows = core.db.q("SELECT n_state, pass FROM nets")
    assert [(r["n_state"], r["pass"]) for r in rows] == [(1, psk)] * 2
    assert hits == {"get_work": 1, "put_work": 1}, hits
    # each process records its 1/2 share of the slice's pass-2 candidates
    # (the dict's 100 words, times 2 rules for the rules unit) over its
    # own pass-2 time; rank 0 alone logs their sum, the slice's rate
    cands = len(base) * (2 if kind == "rules" else 1)
    for r in res:
        assert r["pass2_pmk_s"] == pytest.approx(cands / 2 / r["pass2_s"], rel=1e-6)
    line = [x for x in outs[0][1].splitlines() if "slice PMK/s" in x]
    assert len(line) == 1 and "slice PMK/s" not in outs[1][1]
    assert f"pass2={sum(r['pass2_pmk_s'] for r in res):.0f}" in line[0]


@pytest.mark.parametrize("pid", [0, 1])
def test_silent_slice_is_fatal(pid):
    """No fallback to one process: a process whose coordinator never
    answers (rank 1), or whose peer never joins (rank 0), raises once the
    slice timeout runs out."""
    code = ("from dwpa_tpu_torch.parallel.mesh import multihost_mesh\n"
            f"multihost_mesh(coordinator='127.0.0.1:{_free_port()}', num_processes=2, "
            f"process_id={pid}, device='cpu', timeout_s=3)\n"
            "print('JOINED')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60, cwd=os.path.dirname(os.path.dirname(WORKER)),
                       env=WORKER_ENV)
    assert p.returncode != 0 and "JOINED" not in p.stdout
    assert "timed out" in p.stderr.lower() or "Timed out" in p.stderr, p.stderr[-800:]


def test_shard_word_blocks_equal_jax():
    """``shard_word_blocks`` (the client's share of a global word stream,
    padded so every process feeds the same number of blocks) yields the
    JAX client's ``(words, global_count)`` sequence for every rank."""
    from dwpa_tpu.client.main import shard_word_blocks as jshard

    from dwpa_tpu_torch.client.main import shard_word_blocks

    words = [b"shard-%04d" % i for i in range(150)]
    for nproc in (1, 2, 3):
        for pid in range(nproc):
            got = list(shard_word_blocks(iter(words), nproc, pid, 32, pad_word=b"pad"))
            assert got == list(jshard(iter(words), nproc, pid, 32, pad_word=b"pad"))
            assert sum(c for _, c in got) == len(words)
