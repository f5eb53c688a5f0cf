"""Float64 scenes on the port's single-device engines against the JAX
package's under jax_enable_x64, on the CPU.

- The closed DPD box (scenes.closed_dpd_scene, 300 atoms at rho 3) on the
  nlist engine: ten make_step steps of each package from one start, x and
  v within 1e-9 of the box length, f within 1e-9 of max|f|, every float
  leaf float64 on both sides, and forces that are not float32 values (the
  force was computed in float64, not cast up).
- The same box on the sweep engine: three make_step steps to the same
  bar.  (JAX's make_run fails on this engine under x64, its scan carry
  cell_overflow turning int64; the port's make_run is a loop over
  make_step and runs, its cell_overflow int32.)
- The same box on the cellpad engine, JAX's Pallas kernel in interpret
  mode: a float64 state over float32 kernel fields, as the JAX engine
  packs them.  tags, alive, tag3d and occ exact, f within 2e-4 x max|f|
  (the kernels' float32 bar), every force a float32 value on both sides,
  x and v float64.
- OBMD_DPD at scale 0.25 on the nlist engine with nbuf raised so that
  both buffers ask for atoms on every step, under the deck's own USHER
  search (nattempt 40), the JAX engine's float64 draws injected: over ten
  steps tags, alive and the deleted, inserted, failed and usher_iters
  counts exact, x within 1e-9 of the box's x length, the ObmdScalars
  float64.

Each test first asserts that the JAX leaves it compares are float64: a
JAX run with x64 off would quietly be float32."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from obmd_tpu import integrate as jint
from obmd_tpu import scenes as jscenes
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import make_run, make_step, setup

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, JaxDraws, jax_arrays

N, SEED = 300, 5
BOX_L = (N / 3.0) ** (1.0 / 3.0)
FLOATS = ("x", "v", "f", "q", "lambdaF", "cms_mol", "vcms_mol", "sim_time",
          "momentum_force_left", "momentum_force_right", "shear_force_left",
          "shear_force_right")
OBMD_SCALE, OBMD_SEED, OBMD_NBUF, OBMD_STEPS = 0.25, 3, 850.0, 10
OBMD_EXACT = ("tag", "alive", "ndeleted", "ninserted", "insert_fail",
              "usher_iters")


@pytest.fixture(scope="module", autouse=True)
def x64():
    """jax_enable_x64 on for this module's tests, restored after them."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def port_float_leaves(state) -> dict:
    """Every floating tensor of a port State, its ObmdScalars and its
    layout, by name."""
    out = {}
    for obj, pre in ((state, ""), (state.obmd, "obmd."),
                     (state.nbrs, "nbrs.")):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                out[pre + f.name] = t
    return out


def assert_float64(jd: dict, pst) -> None:
    for k in FLOATS:
        assert jd[k].dtype == np.float64, (k, jd[k].dtype)
    leaves = port_float_leaves(pst)
    assert {k: t.dtype for k, t in leaves.items()
            if t.dtype != torch.float64} == {}
    assert "x" in leaves and "nbrs.xref" in leaves


def closed(path: str):
    """(JAX cfg, JAX state, port cfg, port state) of the closed box at
    float64 on `path`, both set up."""
    kw = dict(n=N, box_l=BOX_L, seed=SEED, dtype="float64")
    js = jscenes.closed_dpd_scene(**kw)
    ps = pscenes.closed_dpd_scene(**kw, device=CPU)
    jcfg = dataclasses.replace(js.cfg, force_path=path).finalize()
    pcfg = dataclasses.replace(ps.cfg, force_path=path).finalize()
    return (jcfg, jint.setup(jcfg, js.state), pcfg, setup(pcfg, ps.state))


@pytest.fixture(scope="module")
def nlist_run():
    """[(JAX arrays, port arrays)] after setup and each of ten steps of
    the closed box on the nlist engine, and the port's last state."""
    jcfg, jst, pcfg, pst = closed("nlist")
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(pcfg)
    for _ in range(10):
        jst, pst = jstep(jst), pstep(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return out, pst


def assert_true_float64(jd, pd):
    """x and v within 1e-9 x the box length, f within 1e-9 x max|f|."""
    for k in ("x", "v"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-9 * BOX_L,
                                   err_msg=k)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 1e-9 * fmax


@pytest.mark.parametrize("i", [0, 5, 10])
def test_nlist_closed_box_matches_jax(nlist_run, i):
    out, pst = nlist_run
    jd, pd = out[i]
    assert_float64(jd, pst)
    for k in ("tag", "alive", "type", "nlist", "ncount"):
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    assert_true_float64(jd, pd)


def test_nlist_forces_are_float64_values(nlist_run):
    """Most forces differ from their float32 rounding, on both sides: the
    list force ran in float64 and was not cast up from float32."""
    out, _ = nlist_run
    jd, pd = out[-1]
    for f in (jd["f"], np.asarray(pd["f"])):
        assert (f != f.astype(np.float32)).mean() > 0.9


def test_sweep_closed_box_matches_jax():
    """Three make_step steps of the sweep engines from one start; the
    port's make_run of the same steps lands on the same state (JAX's
    make_run fails here under x64), its cell_overflow int32."""
    jcfg, jst, pcfg, pst0 = closed("sweep")
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(pcfg)
    pst = pst0
    for _ in range(3):
        jst, pst = jstep(jst), pstep(pst)
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    assert_float64(jd, pst)
    assert np.array_equal(np.asarray(pd["tag"]), jd["tag"])
    assert_true_float64(jd, pd)
    ran = make_run(pcfg, 3)(pst0)
    assert ran.cell_overflow.dtype == torch.int32
    for k in ("x", "v", "f"):
        assert torch.equal(getattr(ran, k), getattr(pst, k)), k


def test_cellpad_closed_box_matches_jax():
    """Two make_step steps of the cellpad engines (the JAX Pallas kernel
    in interpret mode): slots exact, the float32 kernel's forces within
    its bar and float32-valued on both sides, x and v float64."""
    jcfg, jst, pcfg, pst = closed("cellpad")
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(pcfg)
    for _ in range(2):
        jst, pst = jstep(jst), pstep(pst)
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    for k in ("x", "v", "f"):
        assert jd[k].dtype == np.float64 and pd[k].dtype == np.float64, k
    for k in ("tag", "alive", "tag3d", "occ"):
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax
    for f in (jd["f"], pd["f"]):
        assert np.array_equal(f, f.astype(np.float32).astype(np.float64))
    for k in ("x", "v"):
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-4 * BOX_L,
                                   err_msg=k)


@pytest.fixture(scope="module")
def obmd_run():
    """[(JAX arrays, port arrays)] after setup and each of OBMD_STEPS
    steps of OBMD_DPD at float64 on both nlist engines, and the port's
    configuration and last state."""
    pcfg = pscenes.obmd_dpd_config(scale=OBMD_SCALE, nbuf=OBMD_NBUF,
                                   force_path="nlist", dtype="float64")
    jcfg = to_jax(pcfg)
    st = pscenes.obmd_dpd_scene(scale=OBMD_SCALE, seed=OBMD_SEED, device=CPU,
                                dtype="float64").state
    n = int(st.natoms)
    jst = jinit_state(jcfg, st.x[:n].numpy(), v=st.v[:n].numpy(),
                      seed=OBMD_SEED)
    draws = JaxDraws(pcfg, OBMD_SEED)
    pst = setup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU),
                draw=draws)
    jst = jint.setup(jcfg, jst)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jstep, pstep = jax.jit(jint.make_step(jcfg)), make_step(pcfg, draw=draws)
    for _ in range(OBMD_STEPS):
        jst, pst = jstep(jst), pstep(pst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return pcfg, out, pst


def test_obmd_nlist_matches_jax_with_insertions(obmd_run):
    """Every step: the integer state and counters exact, x within 1e-9 of
    the box's x length; both buffers inserted on the deck's own search."""
    pcfg, out, pst = obmd_run
    lx = pcfg.box.lengths[0]
    assert_float64(out[-1][0], pst)
    for jd, pd in out:
        for k in OBMD_EXACT:
            assert np.array_equal(np.asarray(pd[k]), jd[k]), k
        np.testing.assert_allclose(pd["x"], jd["x"], rtol=0, atol=1e-9 * lx)
    first, last = out[0][1], out[-1][1]
    assert pcfg.obmd.usher.nattempt == 40
    assert int(last["ninserted"]) - int(first["ninserted"]) >= OBMD_STEPS
    assert int(last["usher_iters"]) > int(first["usher_iters"])
    assert all(t.dtype == torch.float64
               for t in port_float_leaves(pst).values())
