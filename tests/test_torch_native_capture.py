"""The port's native capture parser (``dwpa_tpu_torch.native``, built
from ``native/capture_fast.cpp`` by ``ops/_gxx.py``) against
``dwpa_tpu``'s Python and native parsers.

The corpus is ``tests/test_native_capture.py``'s: every container and
pairing variant, a multi-network capture, every truncation point, 200
seeded bit-flip mutants and garbage input.  Output must be equal to the
JAX package's native parser and, wherever the Python parser accepts the
blob, to the Python specification parser.  The library builds into
``build/dwpa_tpu_torch/``, never into the package.
"""

import random
import shutil

import pytest

from dwpa_tpu import native as jnative
from dwpa_tpu import testing as jtfx
from dwpa_tpu.server.capture import extract_hashlines as jextract
from dwpa_tpu_torch import native as tnative
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.ops import _nvcc
from dwpa_tpu_torch.server import tools
from dwpa_tpu_torch.server.capture import extract_hashlines

PSK = b"native-psk-22"
ESSID = b"NativeDiffNet"


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    assert tnative.load() is not None and jnative.load() is not None
    return tnative.load()


def frames(m):
    return m.make_handshake_frames(PSK, ESSID, seed="nd", probes=(b"net-one", b"net-two"))[0]


def diff(blob, nc_hint=True):
    """Port native == JAX native == both Python parsers; returns them."""
    fast = tnative.extract_hashlines_fast(blob, nc_hint=nc_hint)
    assert fast == jnative.extract_hashlines_fast(blob, nc_hint=nc_hint)
    py = extract_hashlines(blob, nc_hint=nc_hint)
    assert py == jextract(blob, nc_hint=nc_hint)
    assert fast == py
    return fast


WRAPS = {
    "pcap-le": lambda m, f: m.pcap_bytes(f),
    "pcap-be": lambda m, f: m.pcap_bytes(f, endian=">"),
    "pcap-nsec": lambda m, f: m.pcap_bytes(f, nsec=True),
    "pcapng-le": lambda m, f: m.pcapng_bytes(f),
    "pcapng-be": lambda m, f: m.pcapng_bytes(f, endian=">"),
    "pcapng-spb": lambda m, f: m.pcapng_bytes(f, simple=True),
    "radiotap": lambda m, f: m.pcap_bytes(m.radiotap_wrap(f), linktype=127),
    "radiotap24": lambda m, f: m.pcap_bytes(m.radiotap_wrap(f, rt_len=24), linktype=127),
    "ppi": lambda m, f: m.pcap_bytes(m.ppi_wrap(f), linktype=192),
}


@pytest.mark.parametrize("wrap", list(WRAPS))
def test_every_container_matches(wrap):
    blob = WRAPS[wrap](tfx, frames(tfx))
    assert blob == WRAPS[wrap](jtfx, frames(jtfx))
    lines, probes = diff(blob)
    assert len(lines) == 2 and len(probes) == 2


def test_nc_hint_off_and_multi_network_match():
    lines, _ = diff(tfx.pcap_bytes(frames(tfx)), nc_hint=False)
    assert any(ln.split("*")[1] == "02" for ln in lines)
    many = []
    for i in range(4):
        fr, _ = tfx.make_handshake_frames(b"psk-%d-multi" % i, b"MultiNet%d" % i, seed="m%d" % i,
                                          with_pmkid=(i % 2 == 0), probes=(b"probe%d" % i,))
        many += fr
    lines, probes = diff(tfx.pcap_bytes(many))
    assert len(lines) == 6 and len(probes) == 4


def test_truncation_fuzz_matches():
    blob = tfx.pcap_bytes(frames(tfx))
    for cut in range(0, len(blob), 7):
        fast = tnative.extract_hashlines_fast(blob[:cut])
        assert fast == jnative.extract_hashlines_fast(blob[:cut])
        try:
            py = extract_hashlines(blob[:cut])
        except ValueError:
            assert fast == ([], [])
            continue
        assert fast == py


def test_bitflip_fuzz_matches():
    rng = random.Random(42)
    base = bytearray(tfx.pcapng_bytes(frames(tfx)))
    compared = 0
    for _ in range(200):
        blob = bytearray(base)
        for _ in range(rng.randrange(1, 6)):
            blob[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
        blob = bytes(blob)
        fast = tnative.extract_hashlines_fast(blob)
        assert fast == jnative.extract_hashlines_fast(blob)
        try:
            py = extract_hashlines(blob)
        except Exception:
            continue   # the Python parser raised; native behaviour unspecified
        assert fast == py
        compared += 1
    assert compared > 100


def test_garbage_input():
    for blob in (b"", b"\x00" * 64, b"\x0a\x0d\x0d\x0a" + b"\xff" * 60):
        assert tnative.extract_hashlines_fast(blob) == ([], [])


def test_endian_hint_matches():
    from test_capture_containers import _retrans_capture

    for kw in ({"endian": "<"}, {"endian": ">"}, {"endian": "<", "delta": 200}):
        diff(_retrans_capture("nd-eh", **kw))


def test_builds_outside_the_package_and_tools_select_it(libraries):
    path = _nvcc.library_path(tnative._SRC)
    assert path.exists() and path.parent == _nvcc.BUILD_DIR
    assert not list(tnative._DIR.glob("*.so"))
    assert tools.get_extractor(native=True) is tnative.extract_hashlines_fast
    assert tools.get_extractor() is extract_hashlines


def test_unavailable_library_falls_back(monkeypatch):
    monkeypatch.setattr(tnative, "load", lambda auto_build=True: None)
    assert tools.get_extractor(native=True) is extract_hashlines
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.extract_hashlines_fast(b"")
