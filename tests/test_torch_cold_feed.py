"""The client's pass-2 feed at its defaults (no dict cache) and the
benchmark's cell for it, ``unit5.cache_off``.

- The cold feed as ``client/main.py`` builds it without a dict cache: in
  one process the unit's ``.gz`` dicts as ``DictStream.spans`` framed by
  ``frame_spans`` (packed on the producers), in a slice (and without the
  native packer) the chained ``DictStream`` words into ``CandidateFeed``;
  both against ``port_bench/feed_ref.py``, threaded and inline, from word
  0 and from a resume skip that ends inside the second dict;
- the cold path against the warm one: the same dicts through
  ``DictFeedSource`` over a filled ``DictCache`` give the packed rows of
  the cold blocks;
- the feed's ``feed:frame`` span and ``dwpa_feed_framed_words_total``;
- the cell's entries, and its three new readers on hand-made windows.

No JAX.
"""

import gzip
import hashlib

import numpy as np
import pytest

from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.feed import CandidateFeed, DictCache, DictFeedSource, frame_spans
from dwpa_tpu_torch.gen import DictStream
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.native import pack_candidates_fast
from dwpa_tpu_torch.obs import MetricsRegistry
from port_bench import feed_ref, run
from port_bench.cell import Window

BATCH = 8
#: The words of the three dicts: 42, in five full blocks and one of 2.
SIZES = (13, 8, 21)
#: A resume skip past the first dict and three words of the second.
SKIPS = [0, SIZES[0] + 3]


def _dicts(tmp_path, sizes=SIZES, seed=22):
    """Gzipped dicts of ``sizes`` words, written as a volunteer's client
    keeps them (``<dhash>.gz``): seeded words of 8-20 bytes, one of 70
    bytes and one ``$HEX[...]`` in the first, some lines ending in
    ``\\r\\n``, a blank line and a line of a lone ``\\r`` in each, the last
    dict with no final newline.  -> ([path], [dhash])."""
    rng = np.random.default_rng(seed)
    paths, dhashes = [], []
    for k, n in enumerate(sizes):
        words = [bytes(rng.integers(97, 123, int(m), dtype=np.uint8))
                 for m in rng.integers(8, 21, n)]
        if k == 0:
            words[3] = b"w" * 70
            words[5] = b"$HEX[" + b"hexword1".hex().encode() + b"]"
        lines = [w + (b"\r" if i % 3 == 0 else b"") for i, w in enumerate(words)]
        lines[2:2] = [b"", b"\r"]
        text = b"\n".join(lines) + (b"" if k == len(sizes) - 1 else b"\n")
        gz = gzip.compress(text, mtime=0)
        dhash = hashlib.md5(gz).hexdigest()
        path = tmp_path / f"{dhash}.gz"
        path.write_bytes(gz)
        paths.append(str(path))
        dhashes.append(dhash)
    return paths, dhashes


def _cold_feed(paths, reg, source="spans", producers=1, skip=0, prepack=None):
    """Pass 2's feed at the client's defaults (``client/main.py``): one
    process's spans, or a slice's chained words."""
    if source == "spans":
        spans = (sp for p in paths for sp in DictStream(p).spans())
        return CandidateFeed(None, batch_size=BATCH, producers=producers,
                             frames=frame_spans(spans, BATCH, skip=skip),
                             prepack=prepack, registry=reg, name="pass2")
    words = (w for p in paths for w in DictStream(p))
    return CandidateFeed(words, batch_size=BATCH, producers=producers, skip=skip,
                         prepack=prepack, registry=reg, name="pass2")


def _drain(feed):
    try:
        return list(feed)
    finally:
        feed.close()


def test_reference_keeps_the_line_rules(tmp_path):
    path = tmp_path / "d.gz"
    path.write_bytes(gzip.compress(b"alpha\r\n\r\n\nbr\rvo\r\r\n\rlast"))
    assert feed_ref.dict_words(str(path)) == [b"alpha", b"br\rvo", b"\rlast"]
    assert feed_ref.dict_words(str(path)) == list(DictStream(str(path)))


@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("producers", [0, 1])
@pytest.mark.parametrize("source", ["spans", "words"])
def test_cold_feed_matches_the_reference(tmp_path, source, producers, skip):
    """Every block's ``(offset, count)`` equals the reference's, and its
    packed rows what the native packer makes of the reference's words;
    the words path hands on the words themselves."""
    paths, _ = _dicts(tmp_path)
    feed = _cold_feed(paths, MetricsRegistry(), source, producers=producers, skip=skip)
    blocks = _drain(feed)
    want = feed_ref.blocks(paths, BATCH, skip=skip)
    assert [len(feed_ref.dict_words(p)) for p in paths] == list(SIZES)
    assert [(b.offset, b.count) for b in blocks] == [(o, c) for o, c, _ in want]
    # the dicts' boundaries fall inside blocks: 13 is not a multiple of 8
    assert sum(c for _, c, _ in want) == sum(SIZES) - skip
    for blk, (_, _, words) in zip(blocks, want):
        if source == "words":
            assert blk.words == words and blk.prep is None
            continue
        rows, lens, n = blk.prep
        ref_rows, ref_lens, ref_n = pack_candidates_fast(words, tm.MIN_PSK_LEN, tm.MAX_PSK_LEN,
                                                         capacity=BATCH)
        assert blk.words == [] and n == ref_n
        assert np.array_equal(rows, ref_rows) and np.array_equal(lens, ref_lens)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_spans_over_small_chunks(tmp_path, monkeypatch, chunk):
    """Lines cut by the decompressed chunks (a ``\r`` or a word split
    across two reads) give the words ``DictStream`` yields, and blocks
    that span chunks pack as the reference's words do."""
    paths, _ = _dicts(tmp_path)
    monkeypatch.setattr(DictStream, "CHUNK", chunk)
    for p in paths:
        got = [buf[s:s + n] for buf, starts, lens in DictStream(p).spans()
               for s, n in zip(starts.tolist(), lens.tolist())]
        assert got == list(DictStream(p)) == feed_ref.dict_words(p)
    for skip in SKIPS:
        blocks = _drain(_cold_feed(paths, MetricsRegistry(), skip=skip))
        want = feed_ref.blocks(paths, BATCH, skip=skip)
        assert [(b.offset, b.count) for b in blocks] == [(o, c) for o, c, _ in want]
        for blk, (_, _, words) in zip(blocks, want):
            ref = pack_candidates_fast(words, tm.MIN_PSK_LEN, tm.MAX_PSK_LEN, capacity=BATCH)
            assert blk.prep[2] == ref[2] and np.array_equal(blk.prep[0], ref[0])
            assert np.array_equal(blk.prep[1], ref[1])


def _rows(blocks):
    """Every valid word's packed row and length, in stream order."""
    return (np.concatenate([b.prep[0][:b.prep[2]] for b in blocks]),
            np.concatenate([b.prep[1][:b.prep[2]] for b in blocks]))


@pytest.mark.parametrize("sizes", [(16, 8, 24), SIZES])
def test_cold_and_warm_paths_pack_the_same_rows(tmp_path, sizes):
    """Over dicts of whole batches (the cells' 2**20 words are 8 batches)
    the two paths frame alike and pack alike block for block; over
    ragged dicts the warm source frames each dict alone, the cold feed
    the chained stream, and the rows agree word for word."""
    paths, dhashes = _dicts(tmp_path, sizes)
    eng = tm.M22000Engine([tfx.make_pmkid_line(b"hexword1", b"cold-warm", seed="cw")],
                          batch_size=BATCH, device="cpu")
    cold_reg, warm_reg = MetricsRegistry(), MetricsRegistry()
    cold = _drain(_cold_feed(paths, cold_reg, prepack=eng.host_packer()))
    cache = DictCache(str(tmp_path / "dc"), registry=warm_reg)
    for path, dhash in zip(paths, dhashes):
        _, writer = cache.entry(dhash)
        writer.add_many(feed_ref.dict_words(path))
        assert writer.commit()
    src = DictFeedSource(list(zip(paths, dhashes)), BATCH, cache=cache, name="pass2")
    warm = _drain(CandidateFeed(None, batch_size=BATCH, frames=src,
                                prepack=eng.host_packer(), registry=warm_reg, name="pass2"))
    assert warm_reg.value("dwpa_dictcache_hit_blocks_total") == len(warm)
    for a, b in zip(_rows(cold), _rows(warm)):
        assert np.array_equal(a, b)
    assert _rows(cold)[0].shape[0] == sum(sizes) - 1        # the 70-byte word
    if all(n % BATCH == 0 for n in sizes):
        assert [(b.offset, b.count) for b in cold] == [(b.offset, b.count) for b in warm]
        for c, w in zip(cold, warm):
            assert c.prep[2] == w.prep[2]
            assert np.array_equal(c.prep[0], w.prep[0]) and np.array_equal(c.prep[1], w.prep[1])
    else:
        assert [(b.offset, b.count) for b in cold] != [(b.offset, b.count) for b in warm]
    # both paths record the framed words, the warm one from its pre-framed source
    for reg in (cold_reg, warm_reg):
        assert reg.value("dwpa_feed_framed_words_total", feed="pass2") == sum(sizes)


@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("producers", [0, 1])
@pytest.mark.parametrize("source", ["spans", "words"])
def test_frame_span_and_framed_words(tmp_path, source, producers, skip):
    """One ``feed:frame`` span a framed block and one for the call that
    finds the source exhausted; the counter holds every framed word.
    The words path's resume skip runs in a ``feed:skip`` span, inside the
    first frame span in threaded mode and at construction inline; the
    spans source skips inside its first frame span."""
    paths, _ = _dicts(tmp_path)
    reg = MetricsRegistry()
    feed = _cold_feed(paths, reg, source, producers=producers, skip=skip)
    blocks = _drain(feed)
    assert reg.value("dwpa_feed_framed_words_total", feed="pass2") == sum(SIZES) - skip
    assert reg.value("dwpa_span_seconds", span="feed:frame") == len(blocks) + 1
    assert reg.value("dwpa_span_seconds", span="feed:produce") == len(blocks)
    frames = feed.tracer.records("feed:frame")
    assert len(frames) == len(blocks) + 1 and all(r["t1"] >= r["t0"] for r in frames)
    skips = feed.tracer.records("feed:skip")
    if source == "spans":
        assert skips == []
    else:
        assert [r["parent"] for r in skips] == (
            ["feed:frame"] if producers else [None]) * bool(skip)


# ---------------------------------------------------------------------------
# the cell and its readers
# ---------------------------------------------------------------------------

#: The cell's per-layer metrics and the reader each resolves to.
CELL_METRICS = {"feed.frame_us_per_word": "feed.frame_us_per_word",
                "feed.frame_busy_share": "feed.frame_busy_share",
                "feed.produce_ms_per_batch": "feed.produce_ms_per_batch"}
CELL_METRICS.update((f"{b}.cold", b) for b in (
    "feed.starve_share", "device.idle_share", "step_mfu", "k1_roofline",
    "engine.gate_inflight", "feed.stage_ms_per_batch", "client.unit_overhead_s"))


def test_cold_cell_resolves_to_unit5_without_the_cache():
    cell, config, traffic, e2e, per_layer = run.cell_spec("unit5.cache_off")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("unit5_cold", "cache_off", 1)
    assert config == run.load_json(run.HERE / "configs" / "unit5_cold.json")
    assert traffic == run.load_json(run.HERE / "traffic" / "cache_off.json")
    assert traffic["dict_cache"] is False and traffic["dict_pool"] == 15
    unit5 = run.load_json(run.HERE / "configs" / "unit5.json")
    assert {k: v for k, v in config.items() if k in unit5 and k not in (
        "name", "source", "deployment", "assumed")} == {
        k: v for k, v in unit5.items() if k not in ("name", "source", "deployment", "assumed")}
    assert config["assumed"][:-1] == unit5["assumed"]
    assert [m["name"] for m in e2e] == ["pmk_per_s", "setup_s"]
    assert [m["name"] for m in per_layer] == list(CELL_METRICS)
    base = {m["name"]: m for m in run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]}
    for m in per_layer:
        assert m["workloads"] == ["unit5.cache_off"] and m["moves"] == "pmk_per_s"
        if CELL_METRICS[m["name"]] != m["name"]:
            assert {k: v for k, v in m.items() if k not in ("name", "workloads")} == {
                k: v for k, v in base[CELL_METRICS[m["name"]]].items()
                if k not in ("name", "workloads")}


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_cold_cell_metric_has_a_reader(name):
    read = run.reader(name)
    assert callable(read) and read.__module__ == CELL_METRICS[name]


def _window(before=None, after=None):
    return Window(seconds=120.0, units=[1], results=[], pmks=1, metrics_before=before or {},
                  metrics_after=after or {}, spans=[], k1_launches=0)


def _snap(spans=None, words=None):
    """A registry snapshot: ``spans`` {name: (seconds, count)} in
    ``dwpa_span_seconds``, ``words`` {feed: n} framed."""
    out = {}
    if spans is not None:
        out["dwpa_span_seconds"] = {"type": "histogram", "samples": [
            {"labels": {"span": k}, "count": n, "sum": s, "buckets": []}
            for k, (s, n) in spans.items()]}
    if words is not None:
        out["dwpa_feed_framed_words_total"] = {"type": "counter", "samples": [
            {"labels": {"feed": k}, "value": v} for k, v in words.items()]}
    return out


#: Spans of other names, as large as the window, that no reader may count.
OTHER = {"feed:produce": (90.0, 7), "feed:next": (100.0, 9), "pass2": (110.0, 1)}


def test_frame_us_per_word_reads_the_windows_spans_over_pass2s_words():
    read = run.reader("feed.frame_us_per_word")
    before = _snap({"feed:frame": (1.0, 3), **OTHER}, {"pass2": 1_000_000, "pass1": 5})
    after = _snap({"feed:frame": (4.0, 9), **{k: (2 * s, 2 * n) for k, (s, n) in OTHER.items()}},
                  {"pass2": 2_500_000, "pass1": 900, "prewarm": 10**7})
    assert read(_window(before, after)) == 2.0
    assert read(_window(after=_snap({"feed:frame": (3.0, 2)}, {"pass2": 1_500_000}))) == 2.0
    assert read(_window()) is None
    assert read(_window(after=_snap(OTHER, {"pass2": 10}))) is None
    assert read(_window(after=_snap({"feed:frame": (3.0, 2)}, {"pass1": 10}))) is None


def test_frame_busy_share_reads_the_windows_frame_seconds():
    read = run.reader("feed.frame_busy_share")
    before = _snap({"feed:frame": (6.0, 3), **OTHER})
    after = _snap({"feed:frame": (36.0, 9), **{k: (2 * s, n) for k, (s, n) in OTHER.items()}})
    assert read(_window(before, after)) == 25.0
    assert read(_window(after=_snap({"feed:frame": (30.0, 1)}))) == 25.0
    assert read(_window()) is None
    assert read(_window(after=_snap(OTHER))) is None


def test_produce_ms_per_batch_reads_the_windows_produce_spans():
    read = run.reader("feed.produce_ms_per_batch")
    before = _snap({"feed:produce": (1.0, 10), "feed:frame": (50.0, 10), "feed:next": (9.0, 3)})
    after = _snap({"feed:produce": (1.5, 20), "feed:frame": (80.0, 30), "feed:next": (99.0, 4)})
    assert read(_window(before, after)) == 50.0
    assert read(_window(after=_snap({"feed:produce": (0.25, 5)}))) == 50.0
    assert read(_window()) is None
    assert read(_window(after=_snap({"feed:frame": (1.0, 1), "feed:stage": (1.0, 1)}))) is None
    assert read(_window(before, before)) is None
