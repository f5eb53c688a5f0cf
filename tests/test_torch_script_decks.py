"""Decks of tests/test_script.py through both Interpreters: the miniature
OBMD_DPD deck (test_obmd_deck), the closed deck with variables
(test_closed_deck_and_variables) and the thermo keyword deck
(test_thermo_keyword_breadth).  For each: the port's SceneConfig equals
convert.scene_config of the JAX package's, the state handed to setup has
the same x, v, type and tag bytes, the thermo line of `run 0` agrees
within 1e-5 relative (cpu and elapsed left out; the port's insertions at
setup draw the JAX key chain), and the port, run on to the JAX test's
step, passes that test's own checks.  The JAX side runs `run 0` only:
its own tests run the decks."""
import numpy as np

from tests.torch_script_support import (Decks, assert_config_equal,
                                        assert_thermo_close, write_fluid)

OBMD_DECK = """
units           lj
boundary        f p p
atom_style      atomic
comm_modify     vel yes
newton          on

region          leftB block 0.0 1.6 0.0 4.0 0.0 4.0
region          rightB block 6.4 8.0 0.0 4.0 0.0 4.0
region          leftshear block 0.0 0.0 0.0 0.0 0.0 0.0
region          rightshear block 0.0 0.0 0.0 0.0 0.0 0.0
region          leftBin block 0.0 1.6 0.0 4.0 0.0 4.0
region          rightBin block 6.4 8.0 0.0 4.0 0.0 4.0

pair_style      dpd 1.0 1.0 4321
read_data       {data}
pair_coeff      * * 25.0 4.5 1.0

neighbor        0.3 bin
neigh_modify    delay 0 every 1
timestep        0.01

fix             1 all nve
fix             2 all obmd 1 1 987 10.0 0.0 0.0 0.0 0.0 0.7 0.01 130 &
                region1 leftB region2 rightB region3 leftshear &
                region4 rightshear region5 leftBin region6 rightBin &
                buffersize 1.6 gfac 0.25 stepparallel 0 stepperp 1 &
                maxattempt 1 usher 1 10.0 1.0 0.02 10000.0 1.5 1.0 10 charged 0

thermo          10
thermo_style    custom step temp
"""


def test_obmd_deck(tmp_path, monkeypatch):
    data = write_fluid(tmp_path)
    d = Decks(monkeypatch).run(OBMD_DECK.format(data=data).splitlines()
                               + ["run 0"])
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    d.assert_initial_equal()
    assert len(d.pout) == len(d.jout) == 2
    for p, j in zip(d.pout, d.jout):
        assert_thermo_close(p, j, ["step", "temp"])
    assert int(d.pit.state.natoms) == int(d.jit.state.natoms)
    # the JAX test's checks after its `run 30`, on the port
    d.run(["run 30"], jax=False)
    it = d.pit
    assert it.cfg.obmd is not None
    assert it.cfg.obmd.usher.etarget == 10.0
    assert it.cfg.obmd.nbuf == 130.0
    assert int(it.state.step) == 30
    assert 300 < int(it.state.natoms) < 520
    assert len(d.pout) >= 3


CLOSED_DECK = """
units lj
boundary p p p
atom_style atomic
variable T equal 1.0
variable rc equal 1.0
pair_style dpd ${{T}} ${{rc}} 99
read_data {data}
pair_coeff * * 25.0 4.5
timestep 0.02
fix 1 all nve
thermo 5
thermo_style custom step temp pe ke etotal
"""


def test_closed_deck_and_variables(tmp_path, monkeypatch):
    data = write_fluid(tmp_path, box=(5.0, 5.0, 5.0), n=300)
    d = Decks(monkeypatch).run(CLOSED_DECK.format(data=data).splitlines()
                               + ["run 0"])
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    d.assert_initial_equal()
    assert d.pit.variables["T"]() == d.jit.variables["T"]() == 1.0
    for p, j in zip(d.pout, d.jout):
        assert_thermo_close(p, j, "step temp pe ke etotal".split())
    d.run(["run 10"], jax=False)
    assert int(d.pit.state.step) == 10
    assert d.pit.cfg.obmd is None


THERMO_COLS = ("step time dt atoms temp press pxx pyy pzz pxy vol density "
               "lx ly lz xlo xhi etotal epair emol enthalpy fmax fnorm "
               "cpu elapsed").split()
THERMO_DECK = """
units           lj
boundary        p p p
atom_style      atomic
pair_style      dpd 1.0 1.0 4321
read_data       {data}
pair_coeff      * * 25.0 4.5 1.0
timestep        0.01
fix             1 all nve
thermo          10
thermo_style    custom {cols}
"""


def test_thermo_keyword_breadth(tmp_path, monkeypatch):
    """Every keyword of tests/test_script.py's deck, and cpu and elapsed,
    on the state after setup; then the JAX test's checks at step 10."""
    data = write_fluid(tmp_path, n=200, box=(6.0, 6.0, 6.0))
    deck = THERMO_DECK.format(data=data, cols=" ".join(THERMO_COLS))
    d = Decks(monkeypatch).run(deck.splitlines() + ["run 0"])
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    d.assert_initial_equal()
    for p, j in zip(d.pout, d.jout):
        assert_thermo_close(p, j, THERMO_COLS)
    d.run(["run 10"], jax=False)
    last = d.pout[-1].split()[:-2]
    assert len(last) == 23, d.pout[-1]
    cols = dict(zip(THERMO_COLS, last))
    assert "NA" not in last, d.pout[-1]
    assert cols["step"] == "10" and cols["atoms"] == "200"
    assert float(cols["vol"]) == 216.0 and float(cols["lx"]) == 6.0
    assert abs(float(cols["density"]) - 200.0 / 216.0) < 1e-6
    assert float(cols["time"]) == 0.1 and float(cols["dt"]) == 0.01
    tr3 = (float(cols["pxx"]) + float(cols["pyy"]) + float(cols["pzz"])) / 3
    assert abs(tr3 - float(cols["press"])) < 1e-3 * max(1, abs(tr3))
    assert float(cols["emol"]) == 0.0
    assert float(cols["fnorm"]) > 0.0 and float(cols["fmax"]) > 0.0
    assert np.isfinite(d.pit.state.x.numpy()).all()
