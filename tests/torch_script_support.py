"""Shared helpers of the deck parity tests (tests/test_torch_script*.py):
the same deck through the JAX package's Interpreter and the port's (on the
CPU), the state each hands to `setup` captured, the port's candidate draws
replayed from the JAX key chain, and the comparisons of configurations and
thermo lines."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import obmd_tpu.integrate as jintegrate
import obmd_tpu_torch.engine_cellpad as pengine
import obmd_tpu_torch.integrate as pintegrate
from obmd_tpu.io import lammps_data as jio
from obmd_tpu.io import script as jscript
from obmd_tpu_torch import convert
from obmd_tpu_torch.io import script as pscript

from tests.test_torch_support import CPU, JaxDraws

# sample times of time-dependent parameters
TIMES = (0.0, 0.125, 0.37, 3.1)
# thermo columns that are not a function of the state
NOT_STATE = ("cpu", "elapsed")
# thermo columns compared exactly
EXACT_COLS = ("step", "atoms")


def write_fluid(tmp_path, n=400, box=(8.0, 4.0, 4.0), seed=0):
    """tests/test_script.py's `_write_data`: n uniform atoms of one type,
    written by the JAX package's write_data."""
    r = np.random.default_rng(seed)
    x = r.uniform([0, 0, 0], list(box), (n, 3))
    df = jio.DataFile(
        natoms=n, ntypes=1, box_lo=np.zeros(3), box_hi=np.asarray(box),
        masses=np.asarray([1.0]), x=x, types=np.zeros(n, np.int32),
        tags=np.arange(1, n + 1, dtype=np.int32))
    p = str(tmp_path / "fluid.data")
    jio.write_data(p, df)
    return p


class Decks:
    """Runs deck lines through both Interpreters.  The state each passes
    to `setup` is kept (`initial`: {"jax": ..., "port": ...}); with
    `replay` the port's stage draws the JAX key chain of the JAX
    Interpreter's state (init_state's seed 0), so insertions at setup
    try the same candidates."""

    def __init__(self, monkeypatch, replay=True, setup=True):
        self.initial = {}
        self.jout, self.pout = [], []
        j_setup, p_setup = jintegrate.setup, pintegrate.setup

        def keep(name, fn):
            def wrapped(cfg, state, *a, **k):
                self.initial[name] = state
                return fn(cfg, state, *a, **k) if setup else state
            return wrapped
        monkeypatch.setattr(jintegrate, "setup", keep("jax", j_setup))
        monkeypatch.setattr(pintegrate, "setup", keep("port", p_setup))
        if replay:
            draws, plain = {}, pengine.own_draws

            def own(cfg):
                if cfg.obmd is None:
                    return plain(cfg)
                return draws.setdefault(id(cfg), JaxDraws(cfg, 0))
            monkeypatch.setattr(pengine, "own_draws", own)
            monkeypatch.setattr(pintegrate, "own_draws", own)
        self.jit = jscript.Interpreter(log_fn=self.jout.append)
        self.pit = pscript.Interpreter(log_fn=self.pout.append, device=CPU)

    def run(self, lines, jax=True, port=True):
        if jax:
            self.jit.run_lines(lines)
        if port:
            self.pit.run_lines(lines)
        return self

    def assert_initial_equal(self):
        """x, v, type and tag of the state handed to setup: the same
        bytes in both packages."""
        j, p = self.initial["jax"], self.initial["port"]
        for name in ("x", "v", "type", "tag", "alive", "q", "mol"):
            a = np.asarray(getattr(j, name))
            b = getattr(p, name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def _param_close(a, b, path):
    for t in TIMES:
        got = a(torch.tensor(t, dtype=torch.float32))
        want = b(jnp.asarray(t, jnp.float32))
        assert isinstance(got, torch.Tensor) and got.dim() == 0, path
        assert abs(float(got) - float(want)) <= 1e-6 * max(
            abs(float(want)), 1.0), (path, t, float(got), float(want))


def _walk(a, b, path, skip):
    if path in skip:
        return
    if callable(a) or callable(b):
        assert callable(a) and callable(b), path
        _param_close(a, b, path)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _walk(getattr(a, f.name), getattr(b, f.name),
                  f"{path}.{f.name}", skip)
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]", skip)
    else:
        assert a == b, (path, a, b)


def assert_config_equal(pcfg, jcfg, skip=()):
    """The port's SceneConfig equals convert.scene_config of the JAX
    package's, field by field; time-dependent parameters are compared at
    TIMES (the port's on 0-dim torch tensors, the JAX package's on jnp
    scalars).  `skip`: dotted paths left out, e.g. "cfg.force_path" where
    the packages pick different engines."""
    _walk(pcfg, convert.scene_config(jcfg), "cfg", set(skip))


def assert_thermo_close(pline, jline, cols, rtol=1e-5):
    """One thermo line of each package: step and atoms equal, every state
    column within rtol relative (a floor of 1 under the magnitude, for
    columns near zero such as the off-diagonal pressures), cpu and elapsed
    left out."""
    pv, jv = pline.split(), jline.split()
    assert len(pv) == len(jv) == len(cols), (pline, jline)
    for c, a, b in zip(cols, pv, jv):
        if c in NOT_STATE:
            continue
        if c in EXACT_COLS:
            assert a == b, (c, a, b)
            continue
        fa, fb = float(a), float(b)
        assert abs(fa - fb) <= rtol * max(abs(fb), 1.0), (c, fa, fb)
