"""The port's build sentinel (``dwpa_tpu_torch.analysis.recompile``).

JAX's ``watch_compiles`` counts XLA compile-cache misses; the port builds
no XLA programs, so its twin counts kernel and native-library builds —
a content-hash miss in ``ops/_nvcc.py`` or ``ops/_gxx.py`` — with the
same contract: ``CompileReport.count``/``names``, ``no_recompiles``
raising ``RecompilationError`` past its budget, and the client adding
``comp.count`` to ``dwpa_client_recompiles_total`` per unit (0 in the
steady state).  ``g++`` builds really run here; the ``nvcc`` hook is
driven through a stand-in compiler, since this host has none.
"""

import os
import shutil
import sys
import threading
from pathlib import Path

import pytest
from test_torch_client import LoopbackAPI, _add_dict, _ingest
from torch_fixtures import hashlib_pmk

from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.analysis import (CompileReport, RecompilationError,
                                     no_recompiles, watch_compiles)
from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.ops import _gxx, _nvcc
from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app

PACK_SRC = Path(tm.__file__).resolve().parents[1] / "native" / "pack_fast.cpp"


def test_gxx_build_counts_once_then_hits_the_cache(tmp_path):
    """A g++ build into a fresh directory counts 1, named by its library;
    the same source again is a cache hit and counts 0."""
    with watch_compiles() as cold:
        so = _gxx.build(PACK_SRC, tmp_path)
    assert so.parent == tmp_path and so.exists()
    assert cold.count == 1 and cold.names == [so.name]
    with watch_compiles() as warm:
        assert _gxx.build(PACK_SRC, tmp_path) == so
    assert warm.count == 0 and warm.names == []
    assert repr(warm) == "CompileReport(count=0, names=[])"


def test_nvcc_build_reports_each_library(tmp_path, monkeypatch):
    """``_nvcc.build`` reports one name per library it compiles (all its
    sources started together) and none for a library already built."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(shutil, "which", lambda name: str(fake))
    srcs = [_nvcc.CSRC / "pbkdf2_sha1.cu", _nvcc.CSRC / "sm_probe.cu"]
    out = tmp_path / "build"
    with watch_compiles() as rep:
        libs = _nvcc.build(*srcs, build_dir=out)
    assert rep.names == [p.name for p in libs] and rep.count == 2
    assert all(p.parent == out for p in libs)
    with watch_compiles() as again:
        _nvcc.build(*srcs, build_dir=out)
    assert again.count == 0


def test_no_recompiles_raises_past_its_budget(tmp_path):
    """``no_recompiles`` raises ``RecompilationError`` (an AssertionError,
    as JAX's) naming the region when it built more than allowed; nested
    and concurrent watchers each see a build made on another thread."""
    with pytest.raises(RecompilationError, match="in pack build"):
        with no_recompiles(label="pack build"):
            _gxx.build(PACK_SRC, tmp_path / "a")
    assert issubclass(RecompilationError, AssertionError)
    with no_recompiles(allowed=1) as rep:
        with watch_compiles() as inner:
            t = threading.Thread(target=_gxx.build, args=(PACK_SRC, tmp_path / "b"))
            t.start()
            t.join()
    assert rep.count == inner.count == 1
    assert isinstance(rep, CompileReport)
    with no_recompiles():
        _gxx.build(PACK_SRC, tmp_path / "b")


def _server(tmp_path):
    core = ServerCore(Database(":memory:"), dictdir=str(tmp_path / "dicts"),
                      capdir=str(tmp_path / "caps"))
    _add_dict(core, [b"recomp-junk-%03d" % i for i in range(40)] + [b"recompile-psk"])
    return core


def test_client_counts_builds_per_unit_and_none_when_steady(tmp_path, monkeypatch):
    """The client adds each unit's builds to
    ``dwpa_client_recompiles_total``: a unit that builds a library (here
    a g++ build forced into a fresh directory mid-unit) counts it, a
    second, steady unit adds 0."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    core = _server(tmp_path)
    reg = MetricsRegistry()
    client = TpuCrackClient(
        ClientConfig(base_url="http://loopback/", workdir=str(tmp_path / "w"),
                     batch_size=32, device="cpu"),
        api=LoopbackAPI(make_wsgi_app(core)), log=lambda *a, **k: None, registry=reg)
    fresh = tmp_path / "fresh-build"
    real = client._fetch_pass2_paths

    def building_fetch(work):
        if not fresh.exists():
            _gxx.build(PACK_SRC, fresh)
        return real(work)

    monkeypatch.setattr(client, "_fetch_pass2_paths", building_fetch)
    results = []
    for i in range(2):
        _ingest(core, [tfx.make_pmkid_line(b"recompile-psk", b"RecompNet%d" % i,
                                           seed=f"rc{i}")])
        work = client.api.get_work(1)
        results.append(client.process_work(work))
        assert reg.value("dwpa_client_recompiles_total") == 1
    assert all(r.accepted and [f.psk for f in r.founds] == [b"recompile-psk"]
               for r in results)
    assert os.listdir(fresh)
