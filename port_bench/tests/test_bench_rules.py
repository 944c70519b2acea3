"""The rules mix: the benchmark's rule interpreter against the port's host
interpreter on every rule of the frozen ``wpa.rule``, and a rules cell
end to end on the CPU at a tiny size."""

import random

from port_bench import gen, rules_ref, run
from port_bench.run import HERE, load_json

from cpu import run_tiny


def test_interpreter_matches_the_ports():
    from dwpa_tpu_torch.rules import parse_rules

    text = (HERE / "traffic" / "wpa.rule").read_text()
    mine, theirs = rules_ref.rule_lines(text), parse_rules(text.splitlines())
    assert len(mine) == len(theirs) == 105
    rnd = random.Random(3)
    words = [bytes(rnd.choice(b"abcxyzABCXYZ019@$!so") for _ in range(rnd.randint(0, 40)))
             for _ in range(200)]
    for r, t in zip(mine, theirs):
        assert [rules_ref.apply(r, w) for w in words] == [t.apply(w) for w in words], r


def test_planted_by_rules_and_one_net_uncracked():
    traffic = load_json(HERE / "traffic" / "rules_warm.json")
    config = {**load_json(HERE / "configs" / "unit5.json"), "batch_size": 8, "dictcount": 1}
    rules = gen.traffic_rules(traffic)
    rng = gen.make_rng(4)
    dicts = [gen.Dict(*gen.dict_text(rng, 50, traffic["len_weights"]))]
    for u in gen.make_units(rng, config, traffic, dicts, 3):
        assert len(u.planted) == 4 and u.words == 50 * 105
        for psk in u.planted.values():
            assert 8 <= len(psk) <= 63
            assert any(rules_ref.apply(r, w) == psk for r in rules for w in dicts[0].words)


def test_rules_cell_is_correct(monkeypatch, tmp_path):
    config = load_json(HERE / "configs" / "unit5.json")
    traffic = load_json(HERE / "traffic" / "rules_warm.json")
    w, checks, setup_s, _ = run_tiny(monkeypatch, tmp_path, config, traffic, seed=12,
                                     seconds=1.0)
    assert run.is_correct(checks, w), checks
    assert w.pmks == len(w.units) * 16 * 105
