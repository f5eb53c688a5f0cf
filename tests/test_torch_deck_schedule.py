"""The deck runner's relayout schedule (io/script.Interpreter: the
neigh_modify keywords) and the binned observables' fixed-order sums
(observe.Bins), on the CPU.

- neigh_modify parses `every`, `delay` and `check` with LAMMPS' defaults
  (every 1, delay 0, check yes) and refuses a bad check word; the other
  keywords pass.
- Under `check yes` a quiet run of a small insertion-heavy in.obmd deck
  (the miniature OBMD_DPD deck with nbuf raised so every stage call
  inserts) advances through the per-step runner, whose half-skin test
  relays out when an atom has moved half the skin (make_run is never
  called), and passes check_invariants at the end (the Interpreter's own
  gate) with no skin trip; under `check no` each chunk runs through
  make_run with a relayout every `every` steps, cut to the auto half-skin
  period when `every` is longer.
- observe.Bins: its sums equal index_add's in float64 within 1e-12 of
  the largest (one bin, empty bins, ranks up to 200); make_profile_fn,
  profile_temperature and molecular_pxx with it equal the same functions
  with index_add's float32 sums (today's code) within 1e-6 of each
  figure's largest magnitude, and two evaluations give the same bytes.
"""
import numpy as np
import pytest
import torch

from obmd_tpu_torch import integrate as pintegrate
from obmd_tpu_torch import observe
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import auto_rebuild_every
from obmd_tpu_torch.io.script import Interpreter, ScriptError

from test_torch_support import CPU, lattice_states
from tests.test_torch_script_decks import OBMD_DECK
from tests.torch_script_support import write_fluid


def test_neigh_modify_parses():
    it = Interpreter(device=CPU)
    assert (it.neigh_every, it.neigh_delay, it.neigh_check) == (1, 0, True)
    it.run_lines(["neigh_modify delay 2 every 20 check no one 2000"])
    assert (it.neigh_every, it.neigh_delay, it.neigh_check) == (20, 2, False)
    it.run_lines(["neigh_modify check yes"])
    assert it.neigh_check
    with pytest.raises(ScriptError, match="check maybe"):
        it.run_lines(["neigh_modify check maybe"])
    with pytest.raises(ScriptError, match="every 0"):
        it.run_lines(["neigh_modify every 0"])


def _quiet_deck(tmp_path, extra=()):
    """The miniature OBMD_DPD deck without thermo, nbuf 400 (every stage
    call inserts), then `extra`."""
    data = write_fluid(tmp_path)
    lines = [ln for ln in OBMD_DECK.format(data=data).splitlines()
             if not ln.startswith(("thermo", "thermo_style"))]
    lines = [ln.replace(" 130 &", " 400 &") for ln in lines]
    return lines + list(extra)


def test_check_yes_steps_with_the_half_skin_test(tmp_path, monkeypatch):
    calls = []

    def no_chunks(*a, **k):
        calls.append(a)
        raise AssertionError("make_run under check yes")
    monkeypatch.setattr(pintegrate, "make_run", no_chunks)
    it = Interpreter(device=CPU, log_fn=lambda *a: None)
    it.run_lines(_quiet_deck(tmp_path, ["run 120"]))
    tel = observe.check_invariants(it.cfg, it.state)
    assert not calls and tel["skin_trips"] == 0
    assert tel["ninserted"] > 0
    # the per-step test relaid out when it tripped: more than one layout,
    # fewer than one a step
    assert 1 < tel["rebuilds"] < 120


@pytest.mark.parametrize("every", [3, 1000])
def test_check_no_runs_chunks_every(tmp_path, monkeypatch, every):
    seen = []
    real = pintegrate.make_run

    def spy(cfg, n, *a, **k):
        seen.append((cfg.rebuild_every, n))
        return real(cfg, n, *a, **k)
    monkeypatch.setattr(pintegrate, "make_run", spy)
    it = Interpreter(device=CPU, log_fn=lambda *a: None)
    it.run_lines(_quiet_deck(tmp_path, [
        f"neigh_modify every {every} check no", "run 8"]))
    want = min(every, auto_rebuild_every(it.cfg))
    assert seen == [(want, 8)]
    assert it.state.step == 8


class _IndexAdd:
    """observe.Bins with index_add's sums (the code it replaced)."""

    def __init__(self, idx, nbins):
        self.idx, self.nbins = idx.long(), nbins

    def sum(self, vals):
        out = torch.zeros((self.nbins,) + vals.shape[1:], dtype=vals.dtype)
        return out.index_add(0, self.idx, vals)


def test_bins_equal_index_add_in_float64():
    r = np.random.default_rng(5)
    for nbins, rows in ((1, 50), (7, 0), (40, 3000), (300, 200)):
        idx = torch.from_numpy(r.integers(0, nbins, rows))
        if nbins == 300:
            idx = torch.full((rows,), 17)          # one bin, ranks 0-199
        vals = torch.from_numpy(r.normal(size=(rows, 4)))
        got = observe.Bins(idx, nbins).sum(vals)
        want = _IndexAdd(idx, nbins).sum(vals)
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-12 * scale


def _figures():
    """make_profile_fn's five profiles, profile_temperature and
    molecular_pxx on an OBMD_DPD lattice state and a water box."""
    cfg, st = lattice_states(scale=0.25)[2:]
    prof = observe.make_profile_fn(cfg, nbins=40)(st)
    out = [*(getattr(prof, k) for k in ("density", "vx", "temp", "pxx",
                                        "count")),
           observe.profile_temperature(cfg, st, 40)]
    sc = pscenes.open_water_scene(planes=12, device=CPU, rigid=True)
    out += [torch.tensor(observe.molecular_pxx(sc.cfg, sc.state))]
    return out


def test_observables_equal_index_add(monkeypatch):
    new = _figures()
    again = _figures()
    for a, b in zip(new, again):
        assert torch.equal(a, b)
    monkeypatch.setattr(observe, "Bins", _IndexAdd)
    old = _figures()
    for a, b in zip(new, old):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale
