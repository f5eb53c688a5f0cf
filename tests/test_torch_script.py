"""The port's deck front end (obmd_tpu_torch/io/script.py) against the JAX
package's (obmd_tpu/io/script.py): the control-flow and variable decks of
tests/test_script.py:306-427 (no run) give the same log lines and
variables; the refusals (an untraceable time-dependent variable, an
unknown command, `rigid` / `shake` on an atom-mode deck, a Langevin ramp)
raise the same error types; the reference's bench/in.lj at x = y = z =
0.25 (500 atoms) builds the same lattice and step-0 velocities, and the
port's melt reaches T in 0.55-0.95 at step 100; examples/OBMD_DPD/
in.simulation, its run cut to 0 and its data file written from the
port's scene, builds a configuration that differs from
scenes.obmd_dpd_config(scale=1) only where the deck's own settings do;
the default device raises on a machine without a GPU."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from obmd_tpu.io.script import Interpreter as JInterpreter
from obmd_tpu.io.script import ScriptError as JScriptError
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.io import lammps_data as pio
from obmd_tpu_torch.io.script import Interpreter, ScriptError, run_script

from tests.test_torch_support import CPU
from tests.torch_script_support import Decks, write_fluid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLOW_DECKS = {
    "loop_next_jump": """
variable i loop 4
label LOOP
print "iter ${i}"
next i
jump SELF LOOP
print "done"
""",
    "index_multi_values": """
variable rho index 0.7 0.8 0.9
label LOOP
print "rho=${rho}"
next rho
jump SELF LOOP
""",
    "loop_pad_and_range": """
variable i loop 8 12 pad
label L
print "${i}"
next i
jump SELF L
""",
    "if_then_else": """
variable x equal 3
if "${x} > 2" then "print big" else "print small"
if "${x} > 5" then "print big2" else "print small2"
if "${x} == 3 && ${x} < 10" then "print both"
variable s string hello
if "${s} == hello" then "print strmatch"
if "${s} != hello" then "print nope" else "print strelse"
""",
    "if_multiple_then_commands": '''
if "1 == 1" then "print a" "print b" "print c"
''',
    "next_exhaustion_skips_jump_only_once": """
variable a loop 2
label A
variable b loop 2
label B
print "${a}-${b}"
next b
jump SELF B
next a
jump SELF A
""",
    "equal_variables_and_elif": """
variable n equal 2^3^2
variable m equal -2^2+v_n%5
variable t equal step*dt+PI
variable w string ${m}
if "${m} > 100" then "print hi" elif "${m} > 3" "print mid" else "print lo"
print "n=${n} m=${m} t=${t} w=${w}"
variable m delete
variable k index a b
print "k=${k}"
clear
print "after clear ${n} ${k}"
""",
}


def _variables(it):
    return {k: (v() if callable(v) else v) for k, v in it.variables.items()}


@pytest.mark.parametrize("name", sorted(FLOW_DECKS))
def test_control_flow_decks(name):
    lines = FLOW_DECKS[name].splitlines()
    jout, pout = [], []
    JInterpreter(log_fn=jout.append).run_lines(lines)
    pit = Interpreter(log_fn=pout.append, device=CPU)
    jit = JInterpreter(log_fn=lambda *a: None)
    pit.run_lines(lines)
    jit.run_lines(lines)
    assert pout == jout and pout
    assert _variables(pit) == _variables(jit)
    assert pit._iter_vars == jit._iter_vars


def _obmd_lines(data, extra_fix="", variables=""):
    return f"""
units           lj
boundary        f p p
atom_style      atomic
region          leftB block 0.0 1.6 0.0 4.0 0.0 4.0
region          rightB block 6.4 8.0 0.0 4.0 0.0 4.0
region          zs block 0.0 0.0 0.0 0.0 0.0 0.0
pair_style      dpd 1.0 1.0 4321
read_data       {data}
pair_coeff      * * 25.0 4.5 1.0
{variables}
timestep        0.01
fix             1 all nve
fix             2 all obmd 1 1 987 v_p 0.0 0.0 0.0 0.0 0.7 0.01 130 &
                region1 leftB region2 rightB region3 zs region4 zs &
                region5 leftB region6 rightB buffersize 1.6 near 1 0.5 {extra_fix}
run             0
""".splitlines()


def test_refusals_raise_alike(tmp_path):
    """An untraceable time-dependent variable, an unknown command in
    strict mode (a warning in lenient mode), `rigid` / `shake` without a
    molecule template and a Langevin ramp: the same error types from
    both Interpreters, before either builds an engine."""
    data = write_fluid(tmp_path)
    bad = _obmd_lines(data, variables="variable p equal time+v_missing")

    def both(fn, jerr, perr, match=None):
        with pytest.raises(jerr, match=match):
            fn(JInterpreter(log_fn=lambda *a: None))
        with pytest.raises(perr, match=match):
            fn(Interpreter(log_fn=lambda *a: None, device=CPU))

    both(lambda it: it.run_lines(bad), JScriptError, ScriptError)
    both(lambda it: it.one("kspace_style pppm 1e-4"), JScriptError,
         ScriptError, "unsupported command")
    warned = []
    Interpreter(strict=False, log_fn=warned.append,
                device=CPU).one("kspace_style pppm 1e-4")
    assert warned and "kspace_style" in warned[0]
    for kw in ("rigid fixid", "shake fixid"):
        lines = _obmd_lines(data, extra_fix=kw,
                            variables="variable p equal 188.0")
        both(lambda it: it.run_lines(lines), ValueError, ValueError,
             "MOLECULE-mode")
    both(lambda it: it.run_lines(["units lj",
                                  "fix 2 all langevin 0.5 1.0 0.5 1"]),
         JScriptError, ScriptError, "ramp")
    both(lambda it: it.one("units real"), JScriptError, ScriptError)
    both(lambda it: it.run_lines(["units lj", "run 0"]), JScriptError,
         ScriptError, "read_data")


def test_time_dependent_parameter(tmp_path, monkeypatch):
    """tests/test_script.py:104-142: `v_p` with p = 188+v_amp*sin(2*PI*2*
    time) builds a function of time in both (compared at four times on
    0-dim tensors), constant v_ parameters plain floats, and a restart of
    such a deck refuses in both (the parameter is a closure)."""
    data = write_fluid(tmp_path)
    lines = _obmd_lines(data, variables="variable amp equal 60\n"
                        "variable p equal 188+v_amp*sin(2*PI*2*time)\n"
                        "variable a equal 0.7")
    lines = [ln.replace("0.0 0.7 0.01", "0.0 v_a 0.01") for ln in lines]
    d = Decks(monkeypatch, setup=False).run(lines[:-1])
    d.jit._build()
    d.pit._build()
    from tests.torch_script_support import assert_config_equal
    assert_config_equal(d.pit.cfg, d.jit.cfg)
    for t in (0.0, 0.125, 0.37, 3.1):
        want = 188.0 + 60.0 * np.sin(4.0 * np.pi * t)
        got = d.pit.cfg.obmd.pxx(torch.tensor(t, dtype=torch.float32))
        assert abs(float(got) - want) < 1e-3 * max(1.0, abs(want))
    assert isinstance(d.pit.cfg.obmd.alpha, float)
    with pytest.raises(ValueError, match="unpicklable"):
        d.pit.cmd_write_restart([str(tmp_path / "r.npz")])
    with pytest.raises(ValueError, match="unpicklable"):
        d.jit.cmd_write_restart([str(tmp_path / "j.npz")])


def test_in_lj_quarter(monkeypatch):
    """The reference's bench/in.lj with x = y = z = 0.25 (500 atoms), as
    tests/test_script.py seeds it: the same fcc lattice and step-0
    velocities (bytes) in both, on the nlist engine in both (3 cells an
    axis); the port's melt at step 100 within 0.55-0.95."""
    from chip_smoke import LJ_DECK
    d = Decks(monkeypatch, setup=False)
    for it in (d.jit, d.pit):
        it.variables["x"] = it.variables["y"] = it.variables["z"] = "0.25"
    lines = LJ_DECK.splitlines()
    i_run = max(i for i, ln in enumerate(lines) if ln.startswith("run"))
    d.run(lines[:i_run])
    d.jit._build()
    d.pit._build()
    d.assert_initial_equal()
    assert d.jit.cfg.force_path == d.pit.cfg.force_path == "nlist"
    monkeypatch.undo()
    pit = Interpreter(log_fn=lambda *a: None, device=CPU)
    pit.variables["x"] = pit.variables["y"] = pit.variables["z"] = "0.25"
    pit.run_lines(lines)
    st = pit.state
    n = int(st.natoms)
    v = st.v[st.alive].numpy().astype(np.float64)
    T = (v ** 2).sum() / (3 * n - 3)
    assert n == 500 and st.step == 100
    assert 0.55 < T < 0.95, T


def test_in_simulation_against_scene(tmp_path):
    """examples/OBMD_DPD/in.simulation with its data file written from
    obmd_dpd_scene(scale=1) and its run cut to 0: the configuration equals
    scenes.obmd_dpd_config(scale=1) but for the deck's own pair and fix
    seeds, its neighbor skin (0.4 against the scene's 0.39) and the fix's
    default K (8 against the scene's 16), and the capacities the
    Interpreter sizes itself."""
    sc = pscenes.obmd_dpd_scene(scale=1, seed=7, device=CPU)
    alive = sc.state.alive.numpy()
    data = str(tmp_path / "dpd_8map_obmd.data")
    pio.write_data(data, pio.DataFile(
        natoms=int(alive.sum()), ntypes=1, box_lo=np.asarray(sc.cfg.box.lo),
        box_hi=np.asarray(sc.cfg.box.hi), masses=np.asarray(sc.cfg.masses),
        x=sc.state.x.numpy()[alive], types=sc.state.type.numpy()[alive],
        tags=sc.state.tag.numpy()[alive], v=sc.state.v.numpy()[alive]))
    text = open(os.path.join(ROOT, "examples", "OBMD_DPD",
                             "in.simulation")).read()
    text = text.replace("read_data       dpd_8map_obmd.data",
                        f"read_data       {data}").replace(
        "run             2000000", "run             0")
    deck = tmp_path / "in.simulation"
    deck.write_text(text)
    out = []
    it = run_script(str(deck), device=CPU, log_fn=out.append)
    want = pscenes.obmd_dpd_config(scale=1)
    got = it.cfg
    assert it.cfg.force_path == "cellpad" and len(out) == 2
    diff = {f.name for f in dataclasses.fields(got.obmd)
            if getattr(got.obmd, f.name) != getattr(want.obmd, f.name)}
    assert diff == {"seed", "insert_kmax"}
    assert (got.obmd.seed, want.obmd.seed) == (7566, 872634)
    assert dataclasses.replace(got.pair, seed=want.pair.seed) == want.pair
    assert got.box == want.box and got.dt == want.dt and got.masses == \
        want.masses
    assert (got.skin, want.skin) == (0.4, 0.39)
    for k in range(1, 7):
        r = f"region{k}"
        assert getattr(got.obmd, r) == getattr(want.obmd, r), r


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        Interpreter()
    with pytest.raises(RuntimeError, match="cuda"):
        run_script(os.path.join(ROOT, "examples", "OBMD_DPD",
                                "in.simulation"))
