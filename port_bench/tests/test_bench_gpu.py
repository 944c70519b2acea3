"""On the card (marked ``gpu``; skips without one): a short window of
``unit5.cache_warm`` at its own sizes is correct, and the control, the
client without nonce error correction, is not.  A unit of the cell has
one net whose router moved its nonce, which the control still finds
where the move is one; three seeds hold three such nets."""

import pytest

from port_bench import run
from port_bench.cell import run_cell

SECONDS = 5.0


def _cell(tmp_path, nc=None, seed=20261018):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _, config, traffic, _, _ = run.cell_spec("unit5.cache_warm")
    return run_cell(config, traffic, seed, SECONDS, None, tmp_path / "work", nc=nc,
                    cache_root=run.BUILD)


@pytest.mark.gpu
def test_cell_on_the_card_is_correct(tmp_path):
    w, checks, _, _ = _cell(tmp_path)
    assert run.is_correct(checks, w), checks


@pytest.mark.gpu
def test_control_on_the_card_is_not(tmp_path):
    runs = [_cell(tmp_path, nc=0, seed=s) for s in (20261019, 20261020, 20261021)]
    assert sum(checks["missed"] for _, checks, _, _ in runs) > 0, [c for _, c, _, _ in runs]
