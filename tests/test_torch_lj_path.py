"""The LJ melt path — lj_melt_scene, setup, two 5-step runners (two
relayout epochs at R = 5), check_invariants — against the JAX cellpad
engine at nx = 11 (5,324 atoms, a 6^3 cell grid, p == 1 in 128 lanes of
which 36 are cells, cap 36).

Slots, tags, alive, the kernel caches and every counter are held exactly;
forces within 2e-4 * max|f| (float32 summation order: the port sums each
slot's 27 cells, the TPU kernel a Newton half stencil); positions by tag
within 1e-3.  Exact slot parity needs every atom to sit further than
float32 rounding from a cell face at a relayout step (the fcc lattice puts
atoms exactly on the x, y, z = 0 planes at setup, which both packages file
alike); each state's closest approach to a face is reported with any slot
mismatch.  The port's own run conserves E/N within 1e-3 (thermo through
the port's pair sweep)."""
import jax
import numpy as np
import pytest

from obmd_tpu import scenes as jscenes
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup
from obmd_tpu_torch.observe import check_invariants, make_thermo_fn

from test_torch_support import CPU, jax_arrays

NX = 11
EXACT = ("type", "tag", "alive", "step", "maxtag", "cell_overflow",
         "rebuilds", "overflow", "skin_trips", "tag3d", "occ")


def face_margin(geom, x, alive) -> float:
    """Closest distance of a live atom to a cell face, over all axes."""
    cs = np.asarray(geom.cell_size)
    u = (x[alive] - np.asarray(geom.lo)) / cs
    return float((np.abs(u - np.round(u)) * cs).min())


@pytest.fixture(scope="module")
def runs():
    js = jscenes.lj_melt_scene(nx=NX)
    ps = pscenes.lj_melt_scene(nx=NX, device=CPU)
    jst, pst = jsetup(js.cfg, js.state), psetup(ps.cfg, ps.state)
    out = [(jax_arrays(jst), convert.to_arrays(pst), pst)]
    jrun = jax.jit(jmake_run(js.cfg, 5))
    prun = pmake_run(ps.cfg, 5)
    for _ in range(2):
        jst, pst = jrun(jst), prun(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst), pst))
    return ps.cfg, out


def test_geometry_is_the_p1_layout(runs):
    cfg, _ = runs
    geom = make_geometry(cfg)
    assert (geom.dims, geom.s, geom.p, geom.lanes, geom.cap) == \
        ((6, 6, 6), 36, 1, 128, 36)
    assert geom.periodic_x and auto_rebuild_every(cfg) == 5


@pytest.mark.parametrize("i", [0, 1, 2])
def test_states_match_jax(runs, i):
    """After setup and after 5 and 10 steps: exact slots and counters,
    forces at 2e-4 * max|f|, positions by tag within 1e-3."""
    cfg, out = runs
    jd, pd, _ = out[i]
    margin = face_margin(make_geometry(cfg), jd["x"], jd["alive"])
    for k in EXACT:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), \
            f"{k} differs (closest approach to a cell face {margin:.3e})"
    fmax = np.abs(jd["f"]).max()
    assert fmax > 1.0 or i == 0
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * max(fmax, 1.0)

    def by_tag(d):
        keep = d["alive"]
        return dict(zip(d["tag"][keep].tolist(), d["x"][keep]))
    mj, mp = by_tag(jd), by_tag(pd)
    assert set(mj) == set(mp) and len(mj) == 4 * NX ** 3
    assert max(np.abs(mj[t] - mp[t]).max() for t in mj) < 1e-3


def test_port_run_conserves_energy_and_invariants(runs):
    cfg, out = runs
    thermo = make_thermo_fn(cfg)
    e = []
    for _, _, st in out:
        t = thermo(st)
        e.append((float(t.pe) + float(t.ke)) / int(t.natoms))
    assert max(abs(v - e[0]) for v in e) < 1e-3, e
    tel = check_invariants(cfg, out[-1][2])
    assert tel["rebuilds"] == 3 and tel["layout_overflow"] == 0


def test_full_stencil_kernel_path_matches(runs):
    """The same path through make_dpd_kernel's counterpart
    (kernel="full"): the same slots and counters, positions within 1e-5
    of the default kernel's run after 10 steps (the two kernels' LJ
    arithmetic differs only in the r ~ 0 test)."""
    cfg, out = runs
    ps = pscenes.lj_melt_scene(nx=NX, device=CPU)
    st = psetup(ps.cfg, ps.state, kernel="full")
    run = pmake_run(ps.cfg, 5, kernel="full")
    got, want = convert.to_arrays(run(run(st))), out[-1][1]
    for k in EXACT:
        assert np.array_equal(got[k], want[k]), k
    assert np.abs(got["x"] - want["x"]).max() < 1e-5
