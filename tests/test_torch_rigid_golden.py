"""validation/rigid_golden on the port: 8 free bent trimers in a periodic
12^3 box (trimers.data through the port's read_data), each a rigid body,
40 steps at dt 0.004 on the nlist and cellpad engines, against the
reference binary's `fix rigid/small molecule`:

- under `pair_style dpd 0.0 1.0 12345` with `pair_coeff 1 1 8.0 2.0`
  (in.rigid): every atom within 5e-3 of dump.ref and every arm within
  1e-4 of the template's, validation/run_rigid_golden.py's gates (the two
  integrators, quaternions against recompute-and-rotate, agree to their
  truncation), and within 1e-4 (the parity tests' bar for x over
  several steps, test_torch_support.assert_states_match) of the JAX
  package's run of the same scene (run_rigid_golden.py's run_ours) with
  the port's turn (test_torch_rigid.jax_midpoint);
- under `pair_style zero` (in.r2, dump.rv): the same position and arm
  gates, and every velocity within 5e-3 (LJ units) of the reference's,
  the position gate's figure (the port reads 6.6e-4 at |v| up to 1.64,
  its positions 5.2e-5 from dump.ref; under JAX's turn 1.45e-3 and 3.9e-4).
"""
import jax
import numpy as np
import pytest

from obmd_tpu import rigid as jrigid
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run, setup

from test_torch_obmd_lj import to_jax
from test_torch_rigid import jax_midpoint

L = 12.0
ARM = float(np.hypot(0.5, 0.4))        # the trimer's arm (run_rigid_golden)
POS_GATE, ARM_GATE, VEL_GATE = 5e-3, 1e-4, 5e-3


def _unwrap(d):
    return d - L * np.round(d / L)


def _by_tag(st):
    """{tag: (x, v)} of the live atoms (numpy)."""
    x, v = np.asarray(st.x), np.asarray(st.v)
    tag, alive = np.asarray(st.tag), np.asarray(st.alive)
    return {int(t): (x[i], v[i]) for i, t in enumerate(tag) if alive[i]}


def _arms(ours):
    return [abs(np.linalg.norm(_unwrap(ours[3 * m + a][0]
                                       - ours[3 * m + 2][0])) - ARM)
            for m in range(len(ours) // 3) for a in (1, 3)]


@pytest.fixture(scope="module")
def runs():
    """The port's 40 steps on both engines, with and without the law, and
    the JAX package's with it."""
    out = {}
    for free in (False, True):
        for path in ("nlist", "cellpad"):
            sc = pscenes.rigid_golden_scene(device="cpu", force_path=path,
                                            free=free)
            st = make_run(sc.cfg, pscenes.RIGID_GOLDEN_STEPS)(
                setup(sc.cfg, sc.state))
            out[free, path] = _by_tag(st)
    sc = pscenes.rigid_golden_scene(device="cpu")
    jcfg = to_jax(sc.cfg)
    n = int(sc.state.natoms)
    x, v = sc.state.x.numpy()[:n], sc.state.v.numpy()[:n]
    bonds = []
    for m in range(n // 3):
        bonds += [(3 * m + 1, 3 * m + 2), (3 * m + 2, 3 * m + 3)]
    jst = jsetup(jcfg, jinit_state(jcfg, x, v=v,
                                   tags=sc.state.tag.numpy()[:n],
                                   mol=sc.state.mol.numpy()[:n],
                                   bonds=np.asarray(bonds)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrigid, "rigid_kinematics", jax_midpoint)
        out["jax"] = _by_tag(jax.jit(jmake_run(
            jcfg, pscenes.RIGID_GOLDEN_STEPS))(jst))
    return out


@pytest.mark.parametrize("path", ["nlist", "cellpad"])
def test_dump_ref(runs, path):
    ours = runs[False, path]
    ref = pscenes.golden_dump("rigid_golden", "dump.ref")
    assert set(ref) == set(ours) and len(ref) == 24
    pos = max(np.abs(_unwrap(ref[t] - ours[t][0])).max() for t in ref)
    assert pos < POS_GATE, pos
    assert max(_arms(ours)) < ARM_GATE
    jx = max(np.abs(_unwrap(runs["jax"][t][0] - ours[t][0])).max()
             for t in ref)
    assert jx < 1e-4, jx


@pytest.mark.parametrize("path", ["nlist", "cellpad"])
def test_dump_rv(runs, path):
    ours = runs[True, path]
    ref = pscenes.golden_dump("rigid_golden", "dump.rv")
    assert set(ref) == set(ours)
    pos = max(np.abs(_unwrap(ref[t][:3] - ours[t][0])).max() for t in ref)
    vel = max(np.abs(ref[t][3:] - ours[t][1]).max() for t in ref)
    assert pos < POS_GATE and vel < VEL_GATE, (pos, vel)
    assert max(_arms(ours)) < ARM_GATE
