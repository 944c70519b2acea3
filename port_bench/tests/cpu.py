"""Helpers for the benchmark's CPU tests: a cell at a tiny size on the CPU.

The port's plain PBKDF2 at 4096 iterations takes minutes a batch on a
CPU, so these runs derive the engine's PMKs with ``hashlib`` (on a
thread pool: it releases the interpreter lock).  Everything else of a
run is the real path: the client, the feed, the engine, the plain
verify, the server, the reference.
"""

import hashlib
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TINY = {"dictcount": 2, "dict_words": 384, "batch_size": 128}
TINY_RULES_BASE = 16      # base words a dict of a rules mix
POOL = ThreadPoolExecutor(8)


def _words_be(row) -> bytes:
    return b"".join(struct.pack(">I", int(w) & 0xFFFFFFFF) for w in row)


def _essid(salt_block) -> bytes:
    """The ESSID inside a PBKDF2 salt block ``essid || INT32_BE(1)``, read
    back from the block's length field (64 key bytes + essid + 4)."""
    words = [int(w) & 0xFFFFFFFF for w in salt_block.tolist()]
    return _words_be(words)[:words[15] // 8 - 68]


def hashlib_pmk(pw, salt1, salt2, iterations=4096):
    """Drop-in for ``dwpa_tpu_torch.models.m22000._pmk_impl``."""
    import torch

    rows = pw.cpu().numpy()
    essids = ([_essid(salt1)] * len(rows) if salt1.dim() == 1
              else [_essid(s) for s in salt1])

    def one(i):
        psk = _words_be(rows[i]).rstrip(b"\x00")
        return hashlib.pbkdf2_hmac("sha1", psk, essids[i], iterations, 32)

    out = np.zeros((8, len(rows)), np.uint32)
    for i, key in enumerate(POOL.map(one, range(len(rows)))):
        out[:, i] = np.frombuffer(key, ">u4")
    return torch.from_numpy(out.view(np.int32)).to(pw.device)


def tiny(config: dict) -> dict:
    return {**config, **TINY}


def run_tiny(monkeypatch, tmp_path, config, traffic, seed=7, seconds=2.0, nc=None,
             at_open=None):
    """One run of a cell on the CPU at ``TINY`` sizes."""
    from dwpa_tpu_torch.models import m22000

    from port_bench.cell import run_cell

    monkeypatch.setattr(m22000, "_pmk_impl", hashlib_pmk)
    traffic = {**traffic, "dict_pool": 2}
    config = tiny(config)
    if "dict_words" in traffic:     # a rules mix: one base dict a unit
        traffic["dict_words"], config["dictcount"] = TINY_RULES_BASE, 1
    return run_cell(config, traffic, seed, seconds, None, tmp_path / "work",
                    device="cpu", nc=nc, at_open=at_open)
