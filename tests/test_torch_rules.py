"""The port's on-device rules path held to the JAX package, exactly.

- expansion: ``dwpa_tpu_torch.rules.device.expand`` against JAX
  ``expand_batch`` bit for bit, and ``apply_rule_device`` against the host
  interpreter, for every rule of ``tests/test_rules_device.py`` and of
  the bundled ``wpa.rule``, over its words plus seeded words with bytes
  >= 128;
- the numpy half (``encode_rule``, ``step_bucket``, ``simulate_lens``,
  ``stack_rules``) and the copied host interpreter;
- ``build_rules_step`` against JAX ``build_rules_step`` on a one-device
  CPU mesh: ``hits`` and the packed ``bits``, on a full block and on one
  with pad rows; its K1 launches over a block's real rows;
- ``crack_rules_blocks`` against the JAX engine's ``crack_rules`` and
  ``crack_rules_blocks``: the founds and the ``on_batch`` sequences, with
  ``$HEX``/overlong fallback words, an ``@`` purge rule, overflow pairs
  and resume skips;
- ``RulesFeedSource`` framing over two dicts against the JAX cold path,
  and ``crack_rules_blocks`` over its warm ``.rbase`` blocks against its
  cold run and the JAX engine's cold and warm runs.

The port's PBKDF2 is ``hashlib_pmk`` here (the plain torch PBKDF2 at 4096
iterations takes minutes on a CPU); the JAX side runs its own.
"""

import gzip
import hashlib

import jax
import numpy as np
import pytest
import torch
from test_rules_device import RULES, WORDS
from torch_fixtures import hashlib_pmk

from dwpa_tpu import testing as jtfx
from dwpa_tpu.feed import DictCache as JDictCache
from dwpa_tpu.feed import RulesFeedSource as JRulesFeedSource
from dwpa_tpu.feed import frame_blocks as jframe_blocks
from dwpa_tpu.models import hashline as jhl
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.parallel.step import build_rules_step as jax_build_rules_step
from dwpa_tpu.rules import device as jdev
from dwpa_tpu.rules import parse_rule as jparse_rule
from dwpa_tpu.rules import parse_rules as jparse_rules
from dwpa_tpu.rules import wpa_rules_text as jwpa_rules_text
from dwpa_tpu_torch.feed import DictCache, RulesFeedSource, frame_blocks
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.parallel.step import RULES_CHUNK, build_rules_step
from dwpa_tpu_torch.rules import apply_rules, parse_rule, parse_rules, wpa_rules, wpa_rules_text
from dwpa_tpu_torch.rules import device as tdev
from dwpa_tpu_torch.utils import bytesops as bo

CPU = torch.device("cpu")


def _words():
    """test_rules_device's words, then seeded 0-63-byte words over every
    byte value (bytes >= 128 and case-op edges included)."""
    rng = np.random.default_rng(404)
    rand = [bytes(rng.integers(1, 256, int(k), dtype=np.uint8))
            for k in rng.integers(0, 64, 48)]
    return list(WORDS) + rand


WPA_RULE_TEXTS = [r.text for r in wpa_rules()]


@pytest.mark.parametrize("rtext", RULES + WPA_RULE_TEXTS)
def test_expand_matches_jax_and_host(rtext):
    rule = parse_rule(rtext)
    assert tdev.device_supported(rule)
    words = _words()
    packed = bo.pack_passwords_be(words)
    lens = np.asarray([len(w) for w in words], np.int32)
    steps = tdev.encode_rule(rule)
    ref = np.asarray(jdev.expand_batch(jax.device_put(packed), jax.device_put(lens), steps))
    got = tdev.expand_batch(torch.from_numpy(packed.view(np.int32)),
                            torch.from_numpy(lens), steps)
    assert got.dtype == torch.int32 and got.shape == (len(words), 16)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    # the device result against the host interpreter (overflow rows are
    # the host's by simulate_lens)
    _, hostneed = tdev.simulate_lens(rule, lens)
    for w, g, need in zip(words, tdev.apply_rule_device(words, rule, device=CPU), hostneed):
        exp = rule.apply(w)
        if exp is not None and not tm.MIN_PSK_LEN <= len(exp) <= tm.MAX_PSK_LEN:
            exp = None
        assert g == (None if need else exp), (rtext, w)


def test_numpy_half_and_host_interpreter_match_jax():
    """encode_rule, step_bucket, simulate_lens, stack_rules, the parsed
    ruleset and the host interpreter equal the JAX package's."""
    assert tdev.W == jdev.W and tdev._OPS == jdev._OPS
    assert wpa_rules_text() == jwpa_rules_text()
    texts = RULES + WPA_RULE_TEXTS + ["@a", "$@ $1", "sa@", ""]
    lens = np.arange(0, 80, dtype=np.int32)
    encoded = []
    for t in texts:
        rule, jrule = parse_rule(t), jparse_rule(t)
        assert tdev.device_supported(rule) == jdev.device_supported(jrule)
        for w in _words()[:20]:
            assert rule.apply(w) == jrule.apply(w)
        if not tdev.device_supported(rule):
            continue
        steps = tdev.encode_rule(rule)
        assert steps.dtype == np.int32 and np.array_equal(steps, jdev.encode_rule(jrule))
        encoded.append(steps)
        for got, ref in zip(tdev.simulate_lens(rule, lens), jdev.simulate_lens(jrule, lens)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for n in range(0, 40):
        assert tdev.step_bucket(n) == jdev.step_bucket(n)
    for k in (1, 3, 8):
        chunk = encoded[5 * k: 5 * k + k]
        assert np.array_equal(tdev.stack_rules(chunk, RULES_CHUNK),
                              jdev.stack_rules(chunk, RULES_CHUNK))
    assert len(wpa_rules()) == 105 and len(parse_rules(["@a", "# c", "", "u"])) == 2


def test_apply_rules_pool_keeps_order():
    """The copied pool path yields the serial order (forced past the
    core-count guard, two spawn workers)."""
    rules = parse_rules([":", "u", "$1", "@a", "<5"])
    words = [b"w%05d" % i for i in range(3000)]
    serial = list(apply_rules(rules, words))
    assert list(apply_rules(rules, words, workers=2, force_pool=True)) == serial
    assert len(serial) == 3 * len(words) + len(words)  # '@a' keeps all, '<5' none


# -- the fused step ----------------------------------------------------------

STEP_ESSID = b"rules-step-net"
STEP_PSK = b"Stepword77!"          # base word 'stepword77' through 'c $!'
STEP_RULES = [":", "u", "c", "r", "$1 $2", "T0 T1", "c $!", "d '9"]


def _step_lines():
    return [
        jtfx.make_pmkid_line(STEP_PSK, STEP_ESSID, seed="rs-p1"),
        jtfx.make_pmkid_line(b"not-the-psk-1", STEP_ESSID, seed="rs-p2"),
        jtfx.make_eapol_line(STEP_PSK, STEP_ESSID, keyver=1, seed="rs-k1"),
        jtfx.make_eapol_line(STEP_PSK, STEP_ESSID, keyver=2, nc_delta=3, endian="LE",
                             seed="rs-k2"),
        jtfx.make_eapol_line(STEP_PSK, STEP_ESSID, keyver=3, seed="rs-k3"),
    ]


def test_build_rules_step_matches_jax(monkeypatch):
    """B = 64 base words, 8 rules; the PSK is base word 41 through rule 6,
    and base word 63 — bit 31 of a packed word — is the PSK itself, which
    rules 0 and 2 leave as it is.  hits and the packed bits equal JAX's
    build_rules_step on a one-device CPU mesh."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    words = [b"stepjunk%03d" % i for i in range(64)]
    words[41] = b"stepword77"
    words[63] = STEP_PSK
    words[50] = b"x" * 63
    packed = bo.pack_passwords_be(words)
    lens = np.asarray([len(w) for w in words], np.int32)
    stack = jdev.stack_rules([jdev.encode_rule(jparse_rule(t)) for t in STEP_RULES],
                             RULES_CHUNK)
    lines = _step_lines()
    s1, s2 = jm.essid_salt_blocks(STEP_ESSID)
    mesh = default_mesh(devices=jax.devices()[:1])
    jstep = jax_build_rules_step(mesh, [jm.prep_net(jhl.parse(ln)) for ln in lines], s1, s2)
    jhits, jbits = jstep(jax.device_put(packed), jax.device_put(lens), stack)
    step = build_rules_step([tm.prep_net(tm.hl.parse(ln), device=CPU) for ln in lines],
                            s1, s2, CPU)
    hits, bits = step(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(lens), stack)
    assert hits.dtype == torch.int32 and bits.dtype == torch.int32
    assert bits.shape == (RULES_CHUNK, 2)
    assert int(hits) == int(np.asarray(jhits)) > 0
    assert np.array_equal(bits.numpy().view(np.uint32), np.asarray(jbits))
    hit_cols = np.unpackbits(bits.numpy().view(np.uint8), axis=1, bitorder="little")
    assert hit_cols[6, 41] and hit_cols[0, 63] and hit_cols[2, 63] and hit_cols.sum() == 3


SHORT_PSK = b"12345678"     # an empty row through '$1 $2 $3 $4 $5 $6 $7 $8'
SHORT_RULES = STEP_RULES + ["$1 $2 $3 $4 $5 $6 $7 $8"]


def _short_block(n, B=64):
    """A base block of B rows whose first ``n`` carry a word: the packed
    rows and lengths, zero past ``n`` as the engine pads a block."""
    words = [b"stepjunk%03d" % i for i in range(n)]
    rows = np.zeros((B, 16), np.uint32)
    lens = np.zeros(B, np.int32)
    if n:
        rows[:n] = bo.pack_passwords_be(words)
        lens[:n] = [len(w) for w in words]
    return words, rows, lens


def test_build_rules_step_short_block_matches_jax(monkeypatch):
    """B = 64 with 20 real rows, the 8 step rules and '$1 ... $8', and a
    PMKID net whose PSK is 12345678.  The PSK is base row 12 through rule
    6 and row 19 itself through rules 0 and 2; row 7 is an empty word, so
    the last rule cracks the new net at its column 7, as it would at every
    pad row were the pads hashed.  JAX's step on the padded block hashes
    them: ``bits[:, :20]`` equal its bits there, every pad bit is 0, and
    ``hits`` is JAX's less its 44 pad matches."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    n, B = 20, 64
    _, rows, lens = _short_block(n, B)
    fill = {12: b"stepword77", 19: STEP_PSK, 7: b""}
    rows[list(fill)] = bo.pack_passwords_be(list(fill.values()))
    lens[list(fill)] = [len(w) for w in fill.values()]
    stack = jdev.stack_rules([jdev.encode_rule(jparse_rule(t)) for t in SHORT_RULES],
                             len(SHORT_RULES))
    lines = _step_lines() + [jtfx.make_pmkid_line(SHORT_PSK, STEP_ESSID, seed="rs-p3")]
    s1, s2 = jm.essid_salt_blocks(STEP_ESSID)
    mesh = default_mesh(devices=jax.devices()[:1])
    jstep = jax_build_rules_step(mesh, [jm.prep_net(jhl.parse(ln)) for ln in lines], s1, s2)
    jhits, jbits = jstep(jax.device_put(rows), jax.device_put(lens), stack)
    step = build_rules_step([tm.prep_net(tm.hl.parse(ln), device=CPU) for ln in lines],
                            s1, s2, CPU)
    hits, bits = step(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(lens), stack, n)
    assert bits.dtype == torch.int32 and bits.shape == (len(SHORT_RULES), 2)
    cols = np.unpackbits(bits.numpy().view(np.uint8), axis=1, bitorder="little")
    jcols = np.unpackbits(np.asarray(jbits).view(np.uint8), axis=1, bitorder="little")
    assert np.array_equal(cols[:, :n], jcols[:, :n])
    assert not cols[:, n:].any()
    assert jcols[8, n:].all() and jcols[:, n:].sum() == B - n      # JAX hashed the pads
    assert cols[6, 12] and cols[0, 19] and cols[2, 19] and cols[8, 7] and cols.sum() == 4
    assert 0 < int(hits) == int(np.asarray(jhits)) - (B - n)


@pytest.mark.parametrize("B, n, R, widths", [
    (64, 64, 8, [64] * 8),
    (64, 8, 8, [64]),
    (64, 24, 8, [64] * 3),
    (64, 40, 8, [64] * 5),
    (64, 20, 3, [60]),
    (64, 0, 8, []),
])
def test_build_rules_step_packs_real_rows_into_launches(monkeypatch, B, n, R, widths):
    """The step's K1 launches: the R rules over the ``n`` real rows, laid
    rule-major into R·n columns and cut into launches of at most B, all
    full but the last; an empty block launches nothing.  What each launch
    hashes is the rules' expansions of the real rows, in that order; the
    bits keep their [R, B/32] shape, and a PBKDF2 that cracks nothing
    leaves ``hits`` 0 and every bit 0."""
    launches = []

    def pmk(pw, salt1, salt2):
        launches.append(pw.clone())
        return torch.zeros((8, pw.shape[0]), dtype=torch.int32)

    monkeypatch.setattr(tm, "_pmk_impl", pmk)
    _, rows, lens = _short_block(n, B)
    encoded = [tdev.encode_rule(parse_rule(t)) for t in STEP_RULES[:R]]
    stack = tdev.stack_rules(encoded, R)
    s1, s2 = jm.essid_salt_blocks(STEP_ESSID)
    step = build_rules_step([tm.prep_net(tm.hl.parse(ln), device=CPU) for ln in _step_lines()],
                            s1, s2, CPU)
    base, blens = torch.from_numpy(rows.view(np.int32)), torch.from_numpy(lens)
    hits, bits = step(base, blens, stack, n)
    assert [pw.shape[0] for pw in launches] == widths
    assert int(hits) == 0 and bits.shape == (R, B // 32) and not bits.any()
    if n:
        packed = torch.cat([tdev.expand(base[:n], blens[:n], s) for s in stack])
        assert torch.equal(torch.cat(launches), packed)


# -- the engine --------------------------------------------------------------

BATCH = 32
ESSID = b"MeshNet"
ENGINE_RULES = [":", "u", "c $1 $2", "@a"]
PSK_U = b"MESHWORD77!"      # 'meshword77!' through 'u'  (word 5, block 0)
PSK_C = b"Meshtwo88!12"     # 'meshtwo88!' through 'c $1 $2' (word 70, block 2)
PSK_HEX = b"hexword99"      # '$HEX[...]' base word 80 through ':' (host tail)


def _engine_lines():
    return [
        jtfx.make_pmkid_line(PSK_U, ESSID, seed="rm1"),
        jtfx.make_pmkid_line(PSK_C, ESSID, seed="rm2"),
        jtfx.make_pmkid_line(PSK_HEX, ESSID, seed="rm4"),
        jtfx.make_pmkid_line(b"never-in-keyspace", ESSID, seed="rm3"),
    ]


def _engine_words():
    """3 blocks of 32 (the words of tests/test_rules_mesh.py plus a $HEX
    base).  Word 40 is overlong (host fallback for every rule); word 41 is
    63 bytes, so 'c $1 $2' overflows it into the per-pair host tail."""
    words = [b"mshjunk%04d" % i for i in range(96)]
    words[5] = b"meshword77!"
    words[70] = b"meshtwo88!"
    words[40] = b"y" * 70
    words[41] = b"z" * 63
    words[80] = b"$HEX[" + PSK_HEX.hex().encode() + b"]"
    return words


def _jeng():
    return jm.M22000Engine(_engine_lines(), batch_size=BATCH,
                           mesh=default_mesh(devices=jax.devices()[:1]))


def _teng():
    return tm.M22000Engine(_engine_lines(), batch_size=BATCH, device=CPU)


def _keys(founds):
    return sorted((f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in founds)


def _log(into):
    return lambda c, f: into.append((c, sorted(x.psk for x in f)))


def _jax_run(kind, skip):
    """The JAX engine's (founds, on_batch log) for one entry point."""
    log = []
    eng, rules = _jeng(), jparse_rules(ENGINE_RULES)
    if kind == "flat":
        founds = eng.crack_rules(iter(_engine_words()), rules, on_batch=_log(log), skip=skip)
    else:
        founds = eng.crack_rules_blocks(jframe_blocks(iter(_engine_words()), BATCH), rules,
                                        on_batch=_log(log), skip=skip)
    return _keys(founds), log


@pytest.mark.parametrize("skip", [0, 22, 263])
def test_crack_rules_and_blocks_match_jax(monkeypatch, skip):
    """crack_rules_blocks equals the JAX engine's two entry points, whose
    expansion streams are the same: the founds (PSK, NC, endian, PMK) of
    its crack_rules and crack_rules_blocks, and the per-block on_batch
    sequence of its crack_rules_blocks, at skip 0, at a (word x rule)
    offset inside block 0, and past two whole blocks into block 2."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    rules = parse_rules(ENGINE_RULES)
    total = len(_engine_words()) * len(rules)

    reg = MetricsRegistry()
    eng = _teng()
    blk_log = []
    blk = eng.crack_rules_blocks(frame_blocks(iter(_engine_words()), BATCH), rules,
                                 on_batch=_log(blk_log), skip=skip, registry=reg)
    flat_keys, flat_log = _jax_run("flat", skip)
    assert (_keys(blk), blk_log) == _jax_run("blocks", skip)
    assert _keys(blk) == flat_keys
    assert sum(c for c, _ in blk_log) == sum(c for c, _ in flat_log) == total - skip
    psks = sorted(f.psk for f in blk)
    if skip == 263:
        assert psks == sorted([PSK_C, PSK_HEX]) and len(blk_log) == 1
    else:
        assert psks == sorted([PSK_U, PSK_C, PSK_HEX]) and len(blk_log) == 3
        assert len(eng.nets) == 1 and not eng._rules_steps.keys() - {ESSID}
        # the overlong and the $HEX word take every rule on the host, the
        # 63-byte word its 'c $1 $2' overflow; the other 94 words purge there
        assert reg.value("dwpa_rules_host_fallback_total", reason="overflow") == 4 + 1 + 4
        assert reg.value("dwpa_rules_host_fallback_total", reason="purge") == 96 - 2
        assert reg.value("dwpa_rules_device_expanded_total") > 0


def test_rules_blocks_accept_cached_base_blocks(monkeypatch):
    """A pre-split, pre-packed base block (``RulesPrep``, the dict cache's
    ``.rbase`` layout), once refused, now cracks exactly as the raw word
    block it stands for: the same founds and the same on_batch report."""
    from dwpa_tpu_torch.feed.framing import Block, RulesPrep, rules_base_eligible

    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    words = _engine_words()[32:64]            # the overlong and the 63-byte base
    words[5] = b"meshword77!"                 # PSK_U's base
    plain = [w for w in words if rules_base_eligible(w)]
    prep = RulesPrep(bo.pack_passwords_be(plain), np.array([len(w) for w in plain], np.uint8),
                     len(plain), [w for w in words if not rules_base_eligible(w)])
    rules = parse_rules(ENGINE_RULES)
    got = []
    for blk in (Block(offset=0, count=32, words=words),
                Block(offset=0, count=32, words=[], prep=prep)):
        log = []
        founds = _teng().crack_rules_blocks([blk], rules, on_batch=_log(log))
        got.append((_keys(founds), log))
    assert got[0] == got[1]
    assert got[0][1] == [(32 * len(rules), [PSK_U])]


def _rules_run(source, engine, units, cache, rules, skip=0):
    """(founds, on_batch log) of ``crack_rules_blocks`` over a
    ``RulesFeedSource`` class of either package reading ``cache``, with
    the engine's resume ``skip`` (expanded candidates)."""
    log = []
    src = source(units, batch_size=BATCH, cache=cache)
    founds = engine.crack_rules_blocks(
        iter(src), rules, skip=skip,
        on_batch=lambda c, f: log.append((c, sorted(x.psk for x in f))))
    return _keys(founds), log


def test_crack_rules_blocks_warm_equals_cold_and_jax(monkeypatch, tmp_path):
    """``tests/test_rules_mesh.py::test_rbase_warm_cold_parity`` on the
    port: the cold run (tee write-back) and the warm replay (``RulesPrep``
    blocks: no split, no pack) give the founds and per-block counts of
    the JAX engine's cold and warm runs; an engine skip of block 0's
    expanded candidates on the warm blocks covers exactly the tail."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    blob = gzip.compress(b"\n".join(_engine_words()) + b"\n")
    path = tmp_path / f"{hashlib.md5(blob).hexdigest()}.gz"
    path.write_bytes(blob)
    units = [(str(path), path.stem)]
    reg = MetricsRegistry()
    tc, jc = DictCache(str(tmp_path / "torch"), registry=reg), JDictCache(str(tmp_path / "jax"))
    rules, jrules = parse_rules(ENGINE_RULES), jparse_rules(ENGINE_RULES)

    cold = _rules_run(RulesFeedSource, _teng(), units, tc, rules)
    assert tc.entry(units[0][1], rules=True, fill=False)[0] is not None  # the tee committed
    warm = _rules_run(RulesFeedSource, _teng(), units, tc, rules)
    assert [reg.value(f"dwpa_dictcache_{k}_blocks_total") for k in ("hit", "miss")] == [3, 3]
    jcold = _rules_run(JRulesFeedSource, _jeng(), units, jc, jrules)
    jwarm = _rules_run(JRulesFeedSource, _jeng(), units, jc, jrules)
    assert warm == cold == jcold == jwarm
    assert sorted(k[1] for k in warm[0]) == sorted([PSK_U, PSK_C, PSK_HEX])
    assert sum(c for c, _ in warm[1]) == len(_engine_words()) * len(rules)

    skip = BATCH * len(rules)
    tail = _rules_run(RulesFeedSource, _teng(), units, tc, rules, skip=skip)
    assert tail == _rules_run(JRulesFeedSource, _jeng(), units, jc, jrules, skip=skip)
    assert sorted(k[1] for k in tail[0]) == sorted([PSK_C, PSK_HEX])
    assert tail[1] == warm[1][1:]


# -- the feed source ---------------------------------------------------------


def _two_dicts(tmp_path):
    paths = []
    for i, n in enumerate((70, 45)):
        p = tmp_path / f"d{i}.txt.gz"
        p.write_bytes(gzip.compress(b"\n".join(b"dict%d-word-%04d" % (i, k)
                                               for k in range(n)) + b"\n"))
        paths.append((str(p), None))
    return paths


@pytest.mark.parametrize("batch", [32, 7, 45, 70, 200])
def test_rules_feed_source_framing_matches_jax(tmp_path, batch):
    """Per-dict framing equals the JAX cold path at batch sizes below,
    at, between and above the two dicts' lengths (70 and 45 words)."""
    units = _two_dicts(tmp_path)
    frames = [(b.offset, b.count, b.words) for b in RulesFeedSource(units, batch)]
    assert frames == [(b.offset, b.count, b.words) for b in JRulesFeedSource(units, batch)]
    counts = [c for _, c, _ in frames]
    assert sum(counts) == 115 and [o for o, _, _ in frames] == [0, *np.cumsum(counts)[:-1]]
    if batch == 32:  # dict 0's last block is short
        assert counts == [32, 32, 6, 32, 13]
