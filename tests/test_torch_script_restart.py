"""`write_restart; read_restart; run 5` on a small OBMD deck.

The JAX package's Interpreter cannot run after `read_restart`: it loads a
state without a layout (obmd_tpu/io/script.py:786-788), `run` finds its
configuration built (:1337-1338) and calls the cached runner, which reads
the missing layout and raises AttributeError (ROADMAP Queue 3; pinned
here).  The port rebuilds the layout after loading, so its deck runs on:
the restart file holds the state it was written from to the byte, the
step count carries on, the thermo line at the restart point is the same
state's (within 1e-5 relative: the rebuilt layout sums in another order),
and the run ends at step 10 with the simulation time of an uninterrupted
run."""
import numpy as np
import pytest
import torch

from obmd_tpu.io.script import Interpreter as JInterpreter
from obmd_tpu_torch.io.checkpoint import _tensor_fields, load_checkpoint
from obmd_tpu_torch.io.script import Interpreter

from tests.test_torch_support import CPU
from tests.torch_script_support import assert_thermo_close, write_fluid

DECK = """
units lj
boundary f p p
atom_style atomic
region leftB block 0.0 1.6 0.0 4.0 0.0 4.0
region rightB block 6.4 8.0 0.0 4.0 0.0 4.0
region z block 0.0 0.0 0.0 0.0 0.0 0.0
pair_style dpd 1.0 1.0 4321
read_data {data}
pair_coeff * * 25.0 4.5 1.0
timestep 0.01
fix 1 all nve
fix 2 all obmd 1 1 987 10.0 0.0 0.0 0.0 0.0 0.7 0.01 130 region1 leftB region2 rightB region3 z region4 z region5 leftB region6 rightB buffersize 1.6 usher 1 10.0 1.0 0.02 10000.0 1.5 1.0 10
thermo 5
thermo_style custom step temp atoms press
"""


def test_jax_read_restart_then_run_raises(tmp_path):
    """The reference behaviour this port departs from (ROADMAP Queue 3)."""
    data = write_fluid(tmp_path)
    r = str(tmp_path / "j.restart")
    it = JInterpreter(log_fn=lambda *a: None)
    it.run_lines(DECK.format(data=data).splitlines()
                 + ["run 0", f"write_restart {r}", f"read_restart {r}"])
    assert it.state.nbrs is None
    with pytest.raises(AttributeError, match="xref"):
        it.run_lines(["run 5"])


def test_port_restart_runs_on(tmp_path):
    data = write_fluid(tmp_path)
    r = str(tmp_path / "p.restart")
    lines = DECK.format(data=data).splitlines() + ["run 5"]
    out = []
    it = Interpreter(log_fn=out.append, device=CPU)
    it.run_lines(lines + [f"write_restart {r}"])
    saved = it.state
    cfg, ld = load_checkpoint(r, device=CPU)
    assert cfg == it.cfg and ld.step == saved.step == 5
    for name in _tensor_fields(saved):
        a, b = getattr(saved, name), getattr(ld, name)
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    for name in _tensor_fields(saved.obmd):
        assert torch.equal(getattr(saved.obmd, name),
                           getattr(ld.obmd, name)), name
    assert torch.equal(saved.gen.get_state(), ld.gen.get_state())
    n_before = len(out)
    it.run_lines([f"read_restart {r}", "run 5"])
    assert it.state.nbrs is not None and it.total_steps == 10
    assert it.state.step == 10
    cols = "step temp atoms press".split()
    assert_thermo_close(out[n_before], out[n_before - 1], cols)
    assert [ln.split()[0] for ln in out] == ["0", "5", "5", "10"]
    x = it.state.x[it.state.alive].numpy()
    assert np.isfinite(x).all()
    # an uninterrupted run reaches the same simulation time
    ref = Interpreter(log_fn=lambda *a: None, device=CPU)
    ref.run_lines(lines + ["run 5"])
    assert float(ref.state.sim_time) == float(it.state.sim_time)
    assert ref.state.step == it.state.step
