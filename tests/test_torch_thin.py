"""Single-cell periodic and open y/z axes in the pair kernels' plain
versions, and the JAX package's momentum-conservation box
(tests/test_conservation.py:34-55: `near` insertion on a 7 x 1 x 1 grid)
on the port's cellpad engine.

Each layout's set-up state comes from the JAX engine.  The plain versions
are held to JAX's make_pair_kernel and make_dpd_kernel in interpret mode
and to JAX's pair_sweep, each within 2e-4 * max|f| over alive slots
(tests/test_bigtile.py's bar: float32 summation order), with |sum f| <=
1e-3 * max|f| and no force on a dead slot.  The conservation box runs in
both engines slot for slot (the JAX engine's draws injected through the
port's draw seam), and in the port for 40 steps of its own generator with
sum(f) equal to the boundary setpoints at test_conservation.py's bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu.cells import build_cells as jbuild_cells
from obmd_tpu.config import Capacity as JCapacity
from obmd_tpu.config import DPDParams as JDPDParams
from obmd_tpu.config import SceneConfig as JSceneConfig
from obmd_tpu.engine_cellpad import make_geometry as j_make_geometry
from obmd_tpu.forces.pairs import pair_sweep as jpair_sweep
from obmd_tpu.forces.pallas_dpd import make_dpd_kernel as j_make_dpd_kernel
from obmd_tpu.forces.pallas_dpd import make_pair_kernel as j_make_pair_kernel
from obmd_tpu.geometry import Box as JBox
from obmd_tpu.integrate import _salt as j_salt
from obmd_tpu.integrate import make_grid_spec as j_make_grid_spec
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.engine_cellpad import make_geometry as p_make_geometry
from obmd_tpu_torch.forces.pair_kernel import (NF, PadGeometry,
                                               make_dpd_kernel,
                                               make_pair_kernel,
                                               neighbor_offsets)
from obmd_tpu_torch.integrate import make_run as pmake_run
from obmd_tpu_torch.integrate import setup as psetup

from test_conservation import _obmd_cfg
from test_torch_support import CLOSE, CPU, EXACT, JaxDraws, jax_arrays

# (name, box hi, periodic, filing cap, dims, (s, p, lanes, n_blocks)): the
# conservation box (one cell in y and z, ~70 atoms a cell), a film with one
# cell in z, the film with y open too, and a box with both y and z open
LAYOUTS = [
    ("one-cell-yz", (10.0, 4.0, 4.0), (False, True, True), 112, (7, 1, 1),
     (1, 128, 128, 1)),
    ("one-cell-z", (10.0, 5.6, 2.0), (False, True, True), 32, (7, 4, 1),
     (4, 32, 128, 1)),
    ("open-y-one-cell-z", (10.0, 5.6, 2.0), (False, False, True), 32,
     (7, 4, 1), (4, 32, 128, 1)),
    ("open-yz", (10.0, 5.6, 5.6), (False, False, False), 32, (7, 4, 4),
     (16, 8, 128, 1)),
]


def _layout_state(hi, periodic, cap, seed=5):
    """The JAX engine's set-up state of a DPD gas at rho 3 (a0 25, rc 1,
    skin 0.4) in a box [0, hi), as numpy arrays, the kernels' inputs, the
    JAX config and the port's config of the same scene."""
    box = JBox((0.0, 0.0, 0.0), hi, periodic)
    pair = JDPDParams.create(temp=1.0, cutoff=1.0, seed=9, a0=25.0,
                             gamma=4.5)
    r = np.random.default_rng(seed)
    n = int(3.0 * box.volume)
    x = r.uniform(0.0, hi, (n, 3)).astype(np.float32)
    v = r.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    jcfg = JSceneConfig(box=box, masses=(1.0,), pair=pair, dt=0.005,
                        capacity=JCapacity(n_max=n, cell_capacity=cap),
                        skin=0.4, force_path="cellpad").finalize()
    from obmd_tpu_torch import config as pconfig
    from obmd_tpu_torch.geometry import Box as PBox
    pcfg = pconfig.SceneConfig(
        box=PBox(box.lo, box.hi, box.periodic), masses=(1.0,),
        pair=pconfig.DPDParams.create(temp=1.0, cutoff=1.0, seed=9,
                                      a0=25.0, gamma=4.5),
        dt=0.005, capacity=pconfig.Capacity(n_max=n, cell_capacity=cap),
        skin=0.4).finalize()
    d = jax_arrays(jsetup(jcfg, jinit_state(jcfg, x, v=v)))
    geom = j_make_geometry(jcfg)
    nb, c, lanes = geom.n_blocks, geom.cap, geom.lanes
    xm = np.where(d["alive"][:, None], d["x"], np.float32(1e8))
    fld = np.ascontiguousarray(np.concatenate([xm, d["v"]], axis=1)
                               .astype(np.float32)
                               .reshape(nb, c, lanes, NF)
                               .transpose(0, 3, 1, 2))
    return jcfg, pcfg, d, geom, fld


def _slot(f):
    return f.transpose(0, 2, 3, 1).reshape(-1, 3)


def _assert_close(got, want, d, label):
    """got/want: kernel outputs [nb, 3, cap, lanes] or slot-order [N, 3]."""
    g = (_slot(got) if got.ndim == 4 else got)[d["alive"]]
    w = (_slot(want) if want.ndim == 4 else want)[d["alive"]]
    scale = np.abs(w).max()
    assert scale > 10.0, label
    err = np.abs(g - w).max()
    assert err <= 2e-4 * scale, (label, err, scale)
    assert np.abs(g.sum(axis=0)).max() <= 1e-3 * scale, label
    if got.ndim == 4:
        assert np.all(_slot(got)[~d["alive"]] == 0.0), label


@pytest.fixture(scope="module", params=LAYOUTS, ids=[l[0] for l in LAYOUTS])
def layout(request):
    name, hi, periodic, cap, dims, shape = request.param
    jcfg, pcfg, d, geom, fld = _layout_state(hi, periodic, cap)
    assert geom.dims == dims
    assert (geom.s, geom.p, geom.lanes, geom.n_blocks) == shape
    assert tuple(p_make_geometry(pcfg)) == tuple(geom)
    salt = j_salt(jcfg, 0)
    args = (jnp.asarray(fld), jnp.asarray(d["tag3d"]), jnp.uint32(salt),
            jnp.asarray(d["occ"]), None)
    pargs = (torch.from_numpy(fld), torch.from_numpy(d["tag3d"].copy()),
             salt, torch.from_numpy(d["occ"].copy()))
    spec = j_make_grid_spec(jcfg)
    x, alive = jnp.asarray(d["x"]), jnp.asarray(d["alive"])
    tab = jbuild_cells(spec, x, alive)
    assert int(tab.overflow) == 0
    sweep = np.asarray(jpair_sweep(
        jcfg.pair, jcfg.box, spec, tab, x, jnp.asarray(d["v"]),
        jnp.asarray(d["type"]), jnp.asarray(d["tag"]), jnp.zeros(x.shape[0]),
        salt, dt=jcfg.dt).f)
    return name, jcfg, pcfg, d, PadGeometry(*geom), args, pargs, sweep


def test_offsets_of_the_layouts(layout):
    """A single-cell axis takes the offset 0 only; the open axes keep all
    three (neighbours outside the grid drop out per cell)."""
    _, _, _, _, geom, _, _, _ = layout
    n_y = 1 if geom.dims[1] == 1 else 3
    n_z = 1 if geom.dims[2] == 1 else 3
    offs = neighbor_offsets(geom)
    assert len(offs) == 3 * n_y * n_z and (0, 0, 0) in offs


def test_pair_plain_matches_make_pair_kernel_and_sweep(layout):
    name, jcfg, pcfg, d, geom, args, pargs, sweep = layout
    f_port = make_pair_kernel(geom, pcfg.pair, pcfg.dt)(*pargs).numpy()
    f_tpu = np.asarray(j_make_pair_kernel(geom, params=jcfg.pair,
                                          dt=jcfg.dt)(*args))
    _assert_close(f_port, f_tpu, d, f"{name}: pair vs make_pair_kernel")
    _assert_close(f_port, sweep, d, f"{name}: pair vs pair_sweep")


def test_full_plain_matches_make_dpd_kernel(layout):
    """make_dpd_kernel's counterpart on the periodic layouts; on an open y
    or z axis both packages' full-stencil kernels have none (the port
    refuses it)."""
    name, jcfg, pcfg, d, geom, args, pargs, sweep = layout
    p = pcfg.pair
    kw = dict(a0=p.a0[0][0], gamma=p.gamma[0][0], sigma=p.sigma[0][0],
              cut=p.cut[0][0], dt=pcfg.dt)
    if geom.periodic_yz != (True, True):
        with pytest.raises(NotImplementedError):
            make_dpd_kernel(geom, **kw)
        return
    f_port = make_dpd_kernel(geom, **kw)(*pargs).numpy()
    f_tpu = np.asarray(j_make_dpd_kernel(geom, **kw)(*args))
    _assert_close(f_port, f_tpu, d, f"{name}: full vs make_dpd_kernel")
    _assert_close(f_port, sweep, d, f"{name}: full vs pair_sweep")


def test_single_cell_axis_shorter_than_two_cutoffs_raises():
    """The minimum image on a single cell is right only while the axis is
    at least twice the cutoff long: below that the kernels refuse."""
    pcfg = pscenes.near_box_config()
    geom = p_make_geometry(pcfg)
    short = geom._replace(cell_size=(geom.cell_size[0], 1.9, 4.0))
    with pytest.raises(ValueError):
        make_pair_kernel(short, pcfg.pair, pcfg.dt)
    with pytest.raises(ValueError):
        make_dpd_kernel(short, cut=1.0)
    make_pair_kernel(geom._replace(cell_size=(geom.cell_size[0], 2.0, 4.0)),
                     pcfg.pair, pcfg.dt)


def _near_box_states():
    js_cfg = _obmd_cfg("cellpad")
    ps = pscenes.near_box_scene(device=CPU)
    r = np.random.default_rng(2)
    g = np.stack(np.meshgrid(np.linspace(0.4, 9.6, 20),
                             np.linspace(0.3, 3.7, 5),
                             np.linspace(0.3, 3.7, 5),
                             indexing="ij"), axis=-1).reshape(-1, 3)
    g = g + r.uniform(-0.12, 0.12, g.shape)
    jst = jinit_state(js_cfg, g, v=r.normal(0.0, 1.0, (g.shape[0], 3)))
    return js_cfg.finalize(), jst, ps


def test_near_box_config_is_the_jax_tests():
    """scenes.near_box_config and near_box_scene are test_conservation's
    configuration and start (7 x 1 x 1 cells at cap 112)."""
    jcfg, jst, ps = _near_box_states()
    from test_torch_support import _mirror
    _mirror(ps.cfg, jcfg)
    jd, pd = jax_arrays(jst), convert.to_arrays(ps.state)
    for k in convert.STATE_FIELDS:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    assert p_make_geometry(ps.cfg).dims == (7, 1, 1)


SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")


def _force_gap(state_arrays):
    """test_conservation.py's invariant: |sum f - (mfl + mfr + sfl + sfr)|
    and its bound 2e-6 * max(2 |pxx| A, 2 max|setpoints|)."""
    f = np.asarray(state_arrays["f"], np.float64)
    alive = np.asarray(state_arrays["alive"])
    mf = sum(np.asarray(state_arrays[k], np.float64) for k in SETPOINTS)
    gap = np.abs(f[alive].sum(axis=0) - mf).max()
    return gap, 2e-6 * max(30.0 * 16.0 * 2, np.abs(mf).max() * 2)


@pytest.mark.parametrize("nbuf", [72.0 / 0.9, 100.0])
def test_near_box_steps_match_jax_cellpad(nbuf):
    """Setup and six steps of the conservation box in both engines, slot
    for slot (integer and bool fields exact, x and v within 1e-4, setpoints
    within 1e-6 of their largest component, forces within 2e-4 *
    max|f|), the port's sum(f) on the boundary setpoints at every step: at
    the JAX test's nbuf (no atom asked for yet) and with nbuf raised to
    100, where both buffers ask for atoms from the first step."""
    import dataclasses
    jcfg, jst, ps = _near_box_states()
    jcfg = dataclasses.replace(jcfg, obmd=dataclasses.replace(
        jcfg.obmd, nbuf=nbuf)).finalize()
    pcfg = dataclasses.replace(ps.cfg, obmd=dataclasses.replace(
        ps.cfg.obmd, nbuf=nbuf)).finalize()
    draws = JaxDraws(jcfg, 0)           # init_state's default key seed
    jst = jsetup(jcfg, jst)
    pst = psetup(pcfg, ps.state, draw=draws)
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = pmake_run(pcfg, 1, draw=draws)
    for step in range(7):
        if step:
            jst, pst = jrun(jst), prun(pst)
        jd, pd = jax_arrays(jst), convert.to_arrays(pst)
        for k in EXACT:
            assert np.array_equal(np.asarray(pd[k]), jd[k]), (step, k)
        for k in CLOSE:
            atol = 1e-6 * np.abs(jd[k]).max() if k in SETPOINTS else 1e-4
            np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=atol,
                                       err_msg=f"step {step} {k}")
        fmax = np.abs(jd["f"]).max()
        assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax, step
        gap, bound = _force_gap(pd)
        assert gap < bound, (step, gap, bound)
    assert (int(pd["ninserted"]) > 0) == (nbuf == 100.0)


def test_near_box_force_sum_own_generator():
    """Sixty steps of the conservation box on the port's own generator
    (test_conservation.py's run, long enough for the first insertions):
    sum(f) equals the boundary setpoints on every step whose buffers both
    hold atoms, and the stage inserts and deletes."""
    from obmd_tpu_torch.observe import check_invariants
    ps = pscenes.near_box_scene(device=CPU)
    cfg = ps.cfg
    st = psetup(cfg, ps.state)
    run = pmake_run(cfg, 1)
    checked = 0
    for _ in range(60):
        st = run(st)
        d = convert.to_arrays(st)
        x, alive = d["x"], d["alive"]
        if not ((alive & (x[:, 0] < 1.5)).any()
                and (alive & (x[:, 0] > 8.5)).any()):
            continue
        gap, bound = _force_gap(d)
        assert gap < bound, (st.step, gap, bound)
        checked += 1
    assert checked > 50
    tel = check_invariants(cfg, st)
    assert tel["ninserted"] > 0 and tel["ndeleted"] > 0
