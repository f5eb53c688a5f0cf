"""Decks of tests/test_script.py through both Interpreters, part two: the
Langevin deck (test_fix_langevin_deck), the improper deck
(test_improper_deck) and the dpd/tstat ramp deck (test_tstat_ramp_deck).
As in test_torch_script_decks.py: configurations equal (the ramp deck's
engine apart), the state handed to setup the same bytes, `run 0`'s thermo
line within 1e-5 relative, and the port passes each JAX test's checks
after that test's run.

The ramp deck lands on another engine in each package: the JAX package's
cellpad test (obmd_tpu/engine_cellpad.py:27-44) refuses dpd/tstat, so it
runs on its nlist engine, while the port's engine_cellpad.supports admits
dpd/tstat and the port runs it on the cellpad engine (ROADMAP Queue 3).
The port runs the ramp deck's checks after RAMP_STEPS steps, not 2,000."""
import numpy as np
import pytest

from obmd_tpu.io import lammps_data as jio
from obmd_tpu.io.script import Interpreter as JInterpreter
from obmd_tpu.io.script import ScriptError as JScriptError
from obmd_tpu_torch.io.script import Interpreter, ScriptError

from tests.test_torch_support import CPU
from tests.torch_script_support import (Decks, assert_config_equal,
                                        assert_thermo_close, write_fluid)


def test_fix_langevin_deck(tmp_path, monkeypatch):
    r = np.random.RandomState(3)
    n = 120
    x = r.uniform(0.2, 5.8, (n, 3))
    df = jio.DataFile(natoms=n, ntypes=1, box_lo=np.zeros(3),
                      box_hi=np.full(3, 6.0), masses=np.ones(1), x=x,
                      types=np.zeros(n, int), tags=np.arange(1, n + 1))
    p = tmp_path / "s.data"
    jio.write_data(str(p), df)
    deck = f"""
units lj
boundary p p p
atom_style atomic
read_data {p}
pair_style dpd 0.0 1.0 77
pair_coeff 1 1 5.0 0.0
fix 1 all nve
fix 2 all langevin 0.8 0.8 0.5 9871
timestep 0.004
thermo 100
"""
    d = Decks(monkeypatch).run(deck.splitlines() + ["run 0"])
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    d.assert_initial_equal()
    for a, b in zip(d.pout, d.jout):
        assert_thermo_close(a, b, ["step", "temp"])
    d.run(["run 400"], jax=False)
    T = float(d.pout[-1].split()[-1])
    assert 0.5 < T < 1.2, T
    # T ramps refuse loudly in both
    for it, err in ((Interpreter(log_fn=print, device=CPU), ScriptError),
                    (JInterpreter(log_fn=print), JScriptError)):
        with pytest.raises(err, match="ramp"):
            it.run_lines(["units lj", "fix 2 all langevin 0.5 1.0 0.5 1"])


def _stars(tmp_path):
    """tests/test_script.py's improper data file: 12 trivalent stars."""
    r = np.random.default_rng(5)
    xs, bonds, imps, mols, types = [], [], [], [], []
    L = 8.0
    for c in range(12):
        center = r.uniform(1.0, L - 1.0, 3)
        b = 4 * c
        xs.append(center)
        types.append(1)
        mols.append(c + 1)
        for k in range(3):
            dv = r.normal(size=3)
            dv /= np.linalg.norm(dv)
            xs.append(center + 0.8 * dv)
            types.append(0)
            mols.append(c + 1)
            bonds.append((b + 1, b + 2 + k))
        imps.append((1, b + 2, b + 1, b + 3, b + 4))
    n = len(xs)
    df = jio.DataFile(
        natoms=n, ntypes=2, box_lo=np.zeros(3), box_hi=np.full(3, L),
        masses=np.ones(2), x=np.asarray(xs), types=np.asarray(types),
        tags=np.arange(1, n + 1), v=np.zeros((n, 3)), q=np.zeros(n),
        mol=np.asarray(mols, np.int64), bonds=np.asarray(bonds),
        impropers=np.asarray(imps))
    data = str(tmp_path / "stars.data")
    jio.write_data(data, df, atom_style="molecular")
    return data, n


def test_improper_deck(tmp_path, monkeypatch):
    data, n = _stars(tmp_path)
    cols = "step atoms temp eimp emol etotal".split()
    deck = f"""
units           lj
boundary        p p p
atom_style      molecular
pair_style      dpd 1.0 1.0 777
read_data       {data}
pair_coeff      * * 25.0 4.5 1.0
bond_style      harmonic
bond_coeff      1 40.0 0.8
improper_style  harmonic
improper_coeff  1 9.0 25.0
timestep        0.005
fix             1 all nve
thermo          5
thermo_style    custom {" ".join(cols)}
"""
    d = Decks(monkeypatch).run(deck.splitlines() + ["run 0"])
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    d.assert_initial_equal()
    for name in ("bond1", "bond2", "bond3", "bond4", "impr"):
        assert np.array_equal(getattr(d.initial["port"], name).numpy(),
                              np.asarray(getattr(d.initial["jax"], name))), \
            name
    for a, b in zip(d.pout, d.jout):
        assert_thermo_close(a, b, cols)
    d.run(["run 10"], jax=False)
    last = d.pout[-1].split()
    assert "NA" not in last, d.pout[-1]
    step, atoms, temp, eimp, emol, etot = last
    assert step == "10" and atoms == str(n)
    assert float(eimp) != 0.0
    assert float(emol) >= float(eimp)
    st = d.pit.state
    assert st.bond3 is not None and st.impr is not None
    assert np.isfinite(st.x.numpy()).all()


RAMP_STEPS = 400


def test_tstat_ramp_deck(tmp_path, monkeypatch):
    data = write_fluid(tmp_path, n=600, box=(7.0, 7.0, 7.0), seed=3)
    deck = f"""
units           lj
boundary        p p p
atom_style      atomic
pair_style      dpd/tstat 0.4 2.0 1.0 99
read_data       {data}
pair_coeff      * * 4.5
velocity        all create 0.4 12345
timestep        0.02
fix             1 all nve
thermo          500
thermo_style    custom step temp
"""
    d = Decks(monkeypatch).run(deck.splitlines() + ["run 0"])
    # the packages pick different engines for dpd/tstat (module docstring)
    assert d.jit.cfg.force_path == "nlist"
    assert d.pit.cfg.force_path == "cellpad"
    assert_config_equal(d.pit.cfg, d.jit.cfg, skip=("cfg.force_path",))
    d.assert_initial_equal()
    for a, b in zip(d.pout, d.jout):
        assert_thermo_close(a, b, ["step", "temp"])
    # the JAX test's checks after a run of RAMP_STEPS (its run is 2,000
    # steps, ~7 min through the port's plain versions on one CPU thread):
    # the ramp covers the run's window, 0.4 -> 2.0 over RAMP_STEPS
    d.run([f"run {RAMP_STEPS}"], jax=False)
    temps = [float(line.split()[1]) for line in d.pout[2:]]
    assert temps[0] < 0.7
    assert temps[-1] > 1.4, temps
    assert d.pit.cfg.pair.ramp == (0, RAMP_STEPS)
