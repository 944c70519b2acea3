"""The frozen census against a fresh one, and the per-part arithmetic
that applies it against the census at other net counts."""

import pytest

from port_bench import census
from port_bench.census import derive


def test_counts_match_a_fresh_census():
    assert derive.counts() == census.COUNTS


@pytest.mark.parametrize("kind, static, v, rows, n, runs", [
    ("eapol", (2,), 21, 3, 3, 17), ("eapol", (1,), 21, 3, 2, 12),
    ("cmac", (False,), 21, 7, 3, None), ("pmkid", (), 1, 0, 5, None)])
def test_linear_in_nets(kind, static, v, rows, n, runs):
    from dwpa_tpu_torch.ops.opcount import verify_census

    c = census.COUNTS["k3"][derive.part_key(kind, static, v, rows)]
    runs_ = n * v if runs is None else runs
    want = verify_census(kind, static, n, v, rows, 2, runs)["per_column"]
    assert c["p1"] + (n - 1) * c["pn"] - (n * v - runs_) * c["x"] == want


def test_a_part_the_counts_lack_reads_none():
    from test_bench_reference import units

    lines = units()[0].lines
    assert census.k3_inst_per_column(lines, 8) > 0
    kv2 = next(ln for ln in lines if ln.startswith("WPA*02*") and ln.endswith("*80"))
    le_only = kv2[:-2] + "a0"     # little endian only: 11 variants, no counts
    assert census.k3_inst_per_column(lines + [le_only], 8) is None
