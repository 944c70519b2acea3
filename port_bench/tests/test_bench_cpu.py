"""A cell end to end on the CPU at a tiny size, and ``correct`` coming out
false for the control and for each fault the timed path can have.

The control is the guarantee the configuration states broken: the
client run with no nonce error correction (hashcat's
``--nonce-error-corrections=0``), which a later change might be tempted
to ship since it cuts K3's work twenty-fold.  The faults are planted in
the program underneath the client: a crack step whose found matrix never
changes (a step that returns its state unchanged), PMKs for only the
first half of each batch (half of the batch left out), and a PSK altered
where the engine decodes it (an answer altered where it is produced).
One chip, so no exchange between chips can be left out."""

import dataclasses

import pytest
import torch

from port_bench import run
from port_bench.run import HERE, load_json

from cpu import run_tiny

CONFIG = load_json(HERE / "configs" / "unit5.json")
TRAFFIC = load_json(HERE / "traffic" / "cache_warm.json")


def test_sound_run_is_correct(monkeypatch, tmp_path):
    w, checks, setup_s, _ = run_tiny(monkeypatch, tmp_path, CONFIG, TRAFFIC)
    assert run.is_correct(checks, w), checks
    assert w.pmks == len(w.units) * 2 * 384   # the tiny dicts, one ESSID a unit
    assert checks["builds"] == 0
    assert run.end_to_end(w, setup_s)["pmk_per_s"] > 0


def test_cold_feed_is_correct(monkeypatch, tmp_path):
    traffic = load_json(HERE / "traffic" / "cache_off.json")
    w, checks, _, _ = run_tiny(monkeypatch, tmp_path, CONFIG, traffic, seed=11)
    assert run.is_correct(checks, w), checks


def test_control_without_nonce_correction_fails(monkeypatch, tmp_path):
    w, checks, _, _ = run_tiny(monkeypatch, tmp_path, CONFIG, TRAFFIC, seed=8, nc=0)
    assert checks["missed"] > 0 and not run.is_correct(checks, w)


def _state_unchanged(monkeypatch):
    from dwpa_tpu_torch.parallel import step

    real = step.CrackStep.verify

    def unchanged_found(self, pmk):
        hits, found, pmk = real(self, pmk)
        return torch.zeros_like(hits), torch.zeros_like(found), pmk

    monkeypatch.setattr(step.CrackStep, "verify", unchanged_found)


def _half_batch(monkeypatch):
    from dwpa_tpu_torch.parallel import step

    real = step.CrackStep.compute_pmk

    def first_half_pmks(self, pw_words):
        pmk = real(self, pw_words).clone()
        pmk[:, pmk.shape[1] // 2:] = 0
        return pmk

    monkeypatch.setattr(step.CrackStep, "compute_pmk", first_half_pmks)


def _altered_answer(monkeypatch):
    from dwpa_tpu_torch.models import m22000

    real = m22000.M22000Engine._decode

    def altered_psks(self, *args):
        return [dataclasses.replace(f, psk=f.psk[:-1] + bytes([f.psk[-1] ^ 1]))
                for f in real(self, *args)]

    monkeypatch.setattr(m22000.M22000Engine, "_decode", altered_psks)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_answer],
                         ids=["state_unchanged", "half_batch", "altered_answer"])
def test_a_fault_underneath_fails(monkeypatch, tmp_path, fault):
    w, checks, _, _ = run_tiny(monkeypatch, tmp_path, CONFIG, TRAFFIC, seed=9,
                               at_open=lambda: fault(monkeypatch))
    assert not run.is_correct(checks, w), checks
