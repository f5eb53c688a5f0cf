"""The fix's candidate, velocity and census keywords in the port against
obmd_tpu's, piece by piece, on the OBMD_DPD deck at scale 0.25 (8.4 x
11.198 x 11.198, a jittered rho = 3 lattice of 3,160 atoms):

- the configuration: `gaussian`, `global`, `local`, `rate`, the velocity
  keywords and `id` cross from a JAX ObmdParams through
  convert.obmd_params field for field, and `global` with `local` raises in
  both packages;
- `draw_candidates` for each candidate keyword (and two together) on both
  insertion regions, the JAX draws injected: validity exact, positions
  within 2e-6 x max(|x|, 1) (the same float32 operations; XLA may
  contract a multiply and an add);
- `draw_inserted_velocities` for `vx`, `vx`/`vy`/`vz` and with `target`:
  within 2e-6 x max(|v|, 1);
- `_append_subset` exactly;
- the cellpad census of a group of types (`_region_count_sliced` under
  `group_types`) on a two-type lattice, exactly;
- MOLECULE mode refuses each keyword it does not run yet, with a
  message.

Every input comes from a numpy seed or a fixed JAX key."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu import config as jconfig
from obmd_tpu import engine_cellpad as jec
from obmd_tpu.cellpad import layout_build as j_layout_build
from obmd_tpu.obmd import stage as jstage
from obmd_tpu.obmd.subset import Subset as JSubset
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import engine_cellpad as pec
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.obmd import stage as pstage
from obmd_tpu_torch.obmd.subset import Subset as PSubset

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, _mirror, jax_arrays, lattice_states

K = 16
BUF = 0.15 * 33.594 * 0.25          # the buffers' width at scale 0.25
# keyword sets of the candidate draws (region5 is x in [0, BUF])
CANDIDATES = {
    "uniform": {},
    "gaussian": dict(gaussian=(0.6, 5.0, 6.0, 1.1)),
    "rate": dict(rate=2.5),
    "global": dict(deposit_global=(0.1, 0.9)),
    "local": dict(deposit_local=(0.0, 0.6, 0.8)),
    "gaussian-rate-local": dict(gaussian=(7.5, 3.0, 10.9, 0.9), rate=-4.0,
                                deposit_local=(0.2, 0.5, 1.1)),
}
VELOCITIES = {
    "vx": dict(vx=(-1.0, 2.0)),
    "vxyz": dict(vx=(-1.732, 1.732), vy=(-1.732, 1.732),
                 vz=(-1.732, 1.732)),
    "target": dict(vx=(0.5, 1.5), vz=(-0.2, 0.3), target=(4.0, 5.6, 5.6)),
}


def configs(**kw):
    """(JAX cfg, port cfg) of the deck at scale 0.25 with fix keywords."""
    pcfg = pscenes.obmd_dpd_config(scale=0.25)
    pcfg = dataclasses.replace(pcfg, obmd=dataclasses.replace(
        pcfg.obmd, **kw)).finalize()
    return to_jax(pcfg).finalize(), pcfg


@pytest.fixture(scope="module")
def states():
    """(JAX state, port state) of the jittered lattice, sim_time 0.37, a
    tenth of the atoms dead."""
    _, jst, _, _ = lattice_states(scale=0.25, cap=24, seed=5)
    alive = np.asarray(jst.alive).copy()
    r = np.random.default_rng(2)
    alive[r.choice(np.flatnonzero(alive), alive.sum() // 10,
                   replace=False)] = False
    jst = jst.replace(alive=jnp.asarray(alive),
                      sim_time=jnp.float32(0.37))
    return jst, convert.from_arrays(jax_arrays(jst), device=CPU)


def test_keywords_cross_from_a_jax_config():
    """Every keyword of a JAX ObmdParams reaches the port's through
    convert.obmd_params, field for field; `global` with `local` raises in
    both packages."""
    jcfg, _ = configs()
    kw = dict(gaussian=(0.6, 5.0, 6.0, 1.1), rate=0.5,
              deposit_local=(0.0, 0.6, 0.8), vx=(-1.0, 1.0), vy=(0.0, 2.0),
              vz=(-3.0, -1.0), target=(1.0, 2.0, 3.0), id_policy="max",
              maxattempt=4, nfreq=3, group_types=(0,))
    jo = dataclasses.replace(jcfg.obmd, **kw)
    po = convert.obmd_params(jo)
    assert isinstance(po, pconfig.ObmdParams)
    _mirror(po, jo, "obmd")
    for cm, o in ((jconfig, jo), (pconfig, po)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            dataclasses.replace(o, deposit_global=(0.0, 1.0))
        assert isinstance(o, cm.ObmdParams)


def _side_key(side):
    return jax.random.fold_in(jax.random.PRNGKey(17), side)


@pytest.mark.parametrize("name", sorted(CANDIDATES))
def test_draw_candidates(name, states):
    jst, pst = states
    jcfg, pcfg = configs(**CANDIDATES[name])
    o = pcfg.obmd
    for side, (jr, pr) in enumerate(((jcfg.obmd.region5, o.region5),
                                     (jcfg.obmd.region6, o.region6))):
        key = _side_key(side)
        jc, jok = (np.asarray(t) for t in jstage.draw_candidates(
            jcfg, key, jr, K, jnp.float32, state=jst))
        draw = jax.random.normal if o.gaussian else jax.random.uniform
        u = torch.from_numpy(np.array(draw(key, (K, 3),
                                           dtype=jnp.float32)))
        uz = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, 0x5a), (K,), dtype=jnp.float32)))
        pc, pok = pstage.draw_candidates(pcfg, u, uz, pr, pst)
        assert np.array_equal(pok.numpy(), jok), (side, name)
        scale = max(float(np.abs(jc).max()), 1.0)
        np.testing.assert_allclose(pc.numpy(), jc, rtol=0,
                                   atol=2e-6 * scale)
        if o.deposit_global is not None:
            # above the highest atom: some beyond the periodic z face
            assert (jc[:, 2] > pcfg.box.hi[2]).any()
        if o.gaussian is not None:
            # one midpoint for both regions: the far side's draws are
            # invalid
            assert not jok.all()


@pytest.mark.parametrize("name", sorted(VELOCITIES))
def test_draw_inserted_velocities(name):
    jcfg, pcfg = configs(**VELOCITIES[name])
    r = np.random.default_rng(4)
    pos = r.uniform([0.0, 0.0, 0.0], [8.4, 11.198, 11.198],
                    (2 * K, 3)).astype(np.float32)
    pos[3] = pcfg.obmd.target or pos[3]       # a candidate on the target
    key = jax.random.PRNGKey(9)
    jv = np.asarray(jstage.draw_inserted_velocities(jcfg, key,
                                                    jnp.asarray(pos),
                                                    jnp.float32))
    uv = torch.from_numpy(np.stack([np.array(jax.random.uniform(
        kc, (2 * K,), dtype=jnp.float32))
        for kc in jax.random.split(key, 3)]))
    pv = pstage.draw_inserted_velocities(pcfg, uv, torch.from_numpy(pos))
    scale = max(float(np.abs(jv).max()), 1.0)
    np.testing.assert_allclose(pv.numpy(), jv, rtol=0, atol=2e-6 * scale)
    assert pstage.draw_inserted_velocities(configs()[1], uv,
                                           torch.from_numpy(pos)) is None


def test_append_subset_exact():
    r = np.random.default_rng(6)
    b = 40
    x = r.uniform(0, 10, (b, 3)).astype(np.float32)
    ty = r.integers(0, 2, b).astype(np.int32)
    valid = r.random(b) < 0.7
    q = r.normal(size=b).astype(np.float32)
    pos = r.uniform(0, 10, (K, 3)).astype(np.float32)
    acc = r.random(K) < 0.5
    ctype = np.full(K, 1, np.int32)
    idx = np.arange(b, dtype=np.int32)
    jsub = JSubset(idx=jnp.asarray(idx), x=jnp.asarray(x),
                   type=jnp.asarray(ty), q=jnp.asarray(q),
                   valid=jnp.asarray(valid), overflow=jnp.asarray(True))
    psub = PSubset(x=torch.from_numpy(x), type=torch.from_numpy(ty),
                   valid=torch.from_numpy(valid),
                   overflow=torch.tensor(True), q=torch.from_numpy(q),
                   idx=torch.from_numpy(idx.astype(np.int64)))
    j2 = jstage._append_subset(jsub, jnp.asarray(pos), jnp.asarray(acc),
                               jnp.asarray(ctype),
                               jnp.zeros((K,), jnp.float32), 999)
    p2 = pstage._append_subset(psub, torch.from_numpy(pos),
                               torch.from_numpy(acc),
                               torch.from_numpy(ctype), 999)
    for f in ("x", "type", "valid", "q", "idx", "overflow"):
        assert np.array_equal(getattr(p2, f).numpy(),
                              np.asarray(getattr(j2, f))), f
    # a neutral subset stays neutral, one without slots stays without
    p3 = pstage._append_subset(psub._replace(q=None, idx=None),
                               torch.from_numpy(pos), torch.from_numpy(acc),
                               torch.from_numpy(ctype), 999)
    assert p3.q is None and p3.idx is None


@pytest.mark.parametrize("group", [(0,), (1,), (0, 1)])
def test_group_census_sliced_exact(group):
    """The census of region1 and region2 counts the group's types only,
    over the slot slices, as the JAX cellpad engine counts them."""
    pair = dict(temp=1.0, cutoff=1.0, seed=3, a0=25.0, gamma=4.5,
                ntypes=2)
    pcfg = pscenes.obmd_dpd_config(scale=0.25)
    pcfg = dataclasses.replace(
        pcfg, masses=(1.0, 1.0), pair=pconfig.DPDParams.create(**pair),
        obmd=dataclasses.replace(pcfg.obmd, group_types=group)).finalize()
    jcfg = to_jax(pcfg).finalize()
    from obmd_tpu.state import init_state as jinit
    from test_torch_support import lattice
    x, v = lattice(jcfg, seed=8)
    types = np.random.default_rng(3).integers(0, 2, len(x))
    jst = jinit(jcfg, x, v=v, types=types)
    jg = jec.make_geometry(jcfg)
    jst = j_layout_build(jg, jcfg.box, jst.replace(x=jcfg.box.wrap(jst.x)))
    pst = convert.from_arrays(jax_arrays(jst), device=CPU)
    pg = pec.make_geometry(pcfg)
    counts = []
    for jr, pr in ((jcfg.obmd.region1, pcfg.obmd.region1),
                   (jcfg.obmd.region2, pcfg.obmd.region2)):
        want = int(jec._region_count_sliced(jcfg, jg, jst, jr))
        got = int(pec._region_count_sliced(pcfg, pg, pst, pr))
        assert got == want
        assert got == int(pstage.region_count(pst, pr, group))
        counts.append(got)
    everyone = sum(int(pstage.region_count(pst, r))
                   for r in (pcfg.obmd.region1, pcfg.obmd.region2))
    assert (sum(counts) == everyone) == (len(group) == 2)


MOL_REFUSED = {
    "gaussian": (dict(gaussian=(5.0, 4.0, 4.0, 1.0)), "gaussian"),
    "global": (dict(deposit_global=(0.0, 1.0)), "global"),
    "local": (dict(deposit_local=(0.0, 1.0, 1.0)), "local"),
    "rate": (dict(rate=1.0), "rate"),
    "vz": (dict(vz=(0.0, 1.0)), "inserted-velocity"),
}


@pytest.mark.parametrize("name", sorted(MOL_REFUSED))
def test_molecule_mode_refuses_the_new_keywords(name):
    """MOLECULE mode now takes the candidate and velocity keywords (its
    rounds and centre-of-mass velocities are ported; only `rigid` is
    refused, tests/test_torch_support.py), as ATOM mode does; each is held
    to the JAX engine in tests/test_torch_mol_keywords.py."""
    from obmd_tpu_torch.engine_cellpad import check_supported, supports
    kw, _words = MOL_REFUSED[name]
    small = pscenes.mol_box_config("dpd")
    cfg = dataclasses.replace(small, obmd=dataclasses.replace(
        small.obmd, **kw))
    assert supports(cfg)
    check_supported(cfg.finalize())
    assert supports(configs(**kw)[1])
