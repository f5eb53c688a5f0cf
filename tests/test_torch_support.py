"""Shared fixtures of the obmd_tpu_torch parity tests, and the tests of the
converter and the configuration mirror.

Both packages run on the CPU: the JAX package as its own tests run it
(Pallas kernels in interpret mode), the port through its plain PyTorch
versions.  Inputs come from numpy seeds; states cross between the two as
numpy arrays (obmd_tpu_torch.convert)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from obmd_tpu import scenes as jscenes
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.state import init_state as pinit_state

# The test run puts several worker processes on one machine.  torch's default
# of one OpenMP thread per core in each of them oversubscribes the cores, and
# the spinning threads slow every worker, the JAX tests' too, several-fold.
torch.set_num_threads(1)

CPU = "cpu"
# state fields held exactly and at float tolerance in whole-slice parity
EXACT = ("type", "tag", "alive", "mol", "bond1", "bond2", "step", "maxtag",
         "cell_overflow", "ndeleted", "ninserted", "insert_fail",
         "usher_iters", "rebuilds", "overflow", "skin_trips", "tag3d", "occ")
CLOSE = ("x", "v", "xref", "sim_time", "momentum_force_left",
         "momentum_force_right", "shear_force_left", "shear_force_right")


def jax_arrays(state) -> dict:
    """The converter's dict of numpy arrays from a JAX State (+ PadAux or
    NeighborState)."""
    d = {k: np.asarray(getattr(state, k)) for k in convert.STATE_FIELDS}
    d.update({k: np.asarray(getattr(state.obmd, k))
              for k in convert.OBMD_FIELDS})
    d.update({k: np.asarray(getattr(state, k))
              for k in convert.BRANCHED_FIELDS
              if getattr(state, k) is not None})
    if state.nbrs is not None:
        fields = (convert.NBR_FIELDS if hasattr(state.nbrs, "nlist")
                  else convert.AUX_FIELDS)
        d.update({k: np.asarray(getattr(state.nbrs, k)) for k in fields})
    return d


def assert_states_match(jd, pd):
    """EXACT fields equal; CLOSE fields within 1e-4; f within 2e-4 *
    max|f| (float32 summation order only)."""
    for k in EXACT:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k
    for k in CLOSE:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax


class JaxDraws:
    """The port's draw seam fed with the JAX engine's own draws: each stage
    call advances the key chain exactly as obmd_tpu/engine_cellpad.py
    _insert does (keys = split(fold_in(key, step), 2R + 1), the last key
    carried), and returns, when asked, the positions' draws of sides x
    rounds (jax.random.uniform(keys[i], (K, 3)), or under `gaussian`
    jax.random.normal), and where their keywords are set the deposit z's
    uniform(fold_in(keys[i], 0x5a), (K,)) and the velocities'
    uniform(split(fold_in(fold_in(key, step), 7), 3)[c], (2RK,))
    (obmd_tpu/obmd/stage.py:263-347), as a Draws.  The draws take the
    scene's dtype, as the JAX stage draws in the state's (a float64 scene
    needs jax_enable_x64 on)."""

    def __init__(self, cfg, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.rounds = max(1, int(cfg.obmd.maxattempt))
        self.k = cfg.obmd.insert_kmax
        self.obmd = cfg.obmd
        self.dtype = jnp.dtype(cfg.dtype)

    def __call__(self, state, need):
        from obmd_tpu_torch.obmd.stage import Draws, deposit_z, has_velocity
        step_key = jax.random.fold_in(self.key, jnp.uint32(state.step))
        keys = jax.random.split(step_key, 2 * self.rounds + 1)
        self.key = keys[-1]
        if not need:
            return None
        o = self.obmd
        draw = jax.random.normal if o.gaussian is not None \
            else jax.random.uniform
        shape = (2, self.rounds, self.k)
        u = np.stack([np.asarray(draw(keys[i], (self.k, 3),
                                      dtype=self.dtype))
                      for i in range(2 * self.rounds)])
        pos = torch.from_numpy(u.reshape(shape + (3,)))
        z = vel = None
        if deposit_z(o):
            z = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[i], 0x5a), (self.k,),
                dtype=self.dtype)) for i in range(2 * self.rounds)])
                .reshape(shape))
        if has_velocity(o):
            kv = jax.random.split(jax.random.fold_in(step_key, 7), 3)
            m2 = 2 * self.rounds * self.k
            vel = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                kc, (m2,), dtype=self.dtype)) for kc in kv]))
        return Draws(pos, z, vel)


class JaxMolDraws:
    """The draw seam of MOLECULE mode fed with the JAX engine's own draws:
    each stage call advances the key chain as obmd_tpu/engine_cellpad.py
    _insert_mol does (kl, kr, next = split(fold_in(key, step), 3)), and
    returns, per side and round r, from kc, krot[, kt] = split(fold_in(side
    key, r)) (three ways with several templates) the centers' uniform(kc,
    (K, 3)) (normal under `gaussian`), then from ka, ka2 = split(krot) the
    rotation axis's uniform(ka, (K, 3)) and angle's uniform(ka2, (K,)):
    positions' draws [2, rounds, K, 7]; with several templates the
    templates choice(kt, T, (K,), p=frac); under `global` / `local` the
    deposit z's uniform(fold_in(kc, 0x5a), (K,)); under a velocity keyword
    the velocities' uniform(split(fold_in(next, 7), 3)[c], (2 rounds K,))
    (obmd_tpu/obmd/stage.py:263-347).  The draws take the scene's dtype,
    as the JAX engines draw in the state's (subset.py:196-212; a float64
    scene needs jax_enable_x64 on)."""

    def __init__(self, cfg, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.obmd = cfg.obmd
        self.k = cfg.obmd.insert_kmax
        self.rounds = max(1, int(cfg.obmd.maxattempt))
        self.dtype = jnp.dtype(cfg.dtype)
        self.frac = (np.asarray(cfg.obmd.molfrac, np.float32)
                     if cfg.obmd.molfrac is not None else None)

    def __call__(self, state, need):
        from obmd_tpu_torch.obmd.stage import Draws, deposit_z, has_velocity
        o, k, real = self.obmd, self.k, self.dtype
        key = jax.random.fold_in(self.key, jnp.uint32(state.step))
        kl, kr, self.key = jax.random.split(key, 3)
        if not need:
            return None
        n_t = len(o.templates)
        centre = jax.random.normal if o.gaussian is not None \
            else jax.random.uniform
        pos, tpl, z = [], [], []
        for side_key in (kl, kr):
            for r in range(self.rounds):
                ks = jax.random.split(jax.random.fold_in(side_key, r),
                                      3 if n_t > 1 else 2)
                kc, krot = ks[0], ks[1]
                ka, ka2 = jax.random.split(krot)
                pos.append(np.concatenate([
                    np.asarray(centre(kc, (k, 3), dtype=real)),
                    np.asarray(jax.random.uniform(ka, (k, 3), dtype=real)),
                    np.asarray(jax.random.uniform(ka2, (k,),
                                                  dtype=real))[:, None]],
                    1))
                frac = (self.frac if self.frac is not None
                        else np.full((n_t,), 1.0 / n_t, np.float32))
                tpl.append(np.asarray(jax.random.choice(
                    ks[2], n_t, (k,), p=jnp.asarray(frac))) if n_t > 1
                    else np.zeros((k,), np.int32))
                z.append(np.asarray(jax.random.uniform(
                    jax.random.fold_in(kc, 0x5a), (k,), dtype=real)))
        shape = (2, self.rounds, k)
        vel = None
        if has_velocity(o):
            kv = jax.random.split(jax.random.fold_in(self.key, 7), 3)
            vel = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                kc, (2 * self.rounds * k,), dtype=real))
                for kc in kv]))
        return Draws(
            torch.from_numpy(np.stack(pos).reshape(shape + (7,))),
            torch.from_numpy(np.stack(z).reshape(shape))
            if deposit_z(o) else None, vel,
            torch.from_numpy(np.stack(tpl).astype(np.int32).reshape(shape))
            if n_t > 1 else None)


def lattice(cfg, seed=13, jitter=0.18):
    """A jittered rho = 3 simple-cubic lattice filling the box (the
    equilibrated liquid's occupancy fits filing capacity 15) with unit
    normal velocities."""
    lo = np.asarray(cfg.box.lo)
    hi = np.asarray(cfg.box.hi)
    a = (1.0 / 3.0) ** (1.0 / 3.0)
    axes = [np.arange(l + a / 2, h - 1e-9, a) for l, h in zip(lo, hi)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    r = np.random.default_rng(seed)
    x = g + r.uniform(-jitter, jitter, g.shape) * a
    v = r.normal(0, 1, g.shape)
    return x, v


def jittered(cfg, x, seed=1, sigma=0.05):
    """Positions x moved by a numpy normal jitter of `sigma` and wrapped
    into the (fully periodic) box, as float32."""
    r = np.random.default_rng(seed)
    x = np.asarray(x) + sigma * r.normal(size=np.shape(x))
    lo, L = np.asarray(cfg.box.lo), np.asarray(cfg.box.lengths)
    return (lo + np.mod(x - lo, L)).astype(np.float32)


def lattice_states(scale=0.25, cap=15, seed=13, **cfg_kw):
    """(jax cfg, jax state, port cfg, port state) on one jittered lattice."""
    jcfg = jscenes.obmd_dpd_config(scale=scale, cell_capacity=cap, **cfg_kw)
    pcfg = pscenes.obmd_dpd_config(scale=scale, cell_capacity=cap, **cfg_kw)
    x, v = lattice(jcfg, seed)
    n_max = len(x) + 512
    jcfg = dataclasses.replace(jcfg, capacity=dataclasses.replace(
        jcfg.capacity, n_max=n_max)).finalize()
    pcfg = dataclasses.replace(pcfg, capacity=dataclasses.replace(
        pcfg.capacity, n_max=n_max)).finalize()
    return (jcfg, jinit_state(jcfg, x, v=v), pcfg,
            pinit_state(pcfg, x, v=v, device=CPU))


def jax_chain_config(pcfg):
    """The JAX package's configuration of a port chain_config, built as
    obmd_tpu.scenes.chain_scene builds it (in.chain's physics)."""
    from obmd_tpu.config import (BondFENEParams, Capacity, LangevinParams,
                                 LJCutParams, SceneConfig)
    from obmd_tpu.geometry import Box
    return SceneConfig(
        box=Box(pcfg.box.lo, pcfg.box.hi, pcfg.box.periodic), masses=(1.0,),
        pair=LJCutParams.create(cutoff=1.12, epsilon=1.0, sigma=1.0,
                                shift=True),
        dt=0.012, capacity=Capacity(n_max=pcfg.capacity.n_max,
                                    cell_capacity=pcfg.capacity.cell_capacity),
        bond=BondFENEParams(k=30.0, r0=1.5, epsilon=1.0, sigma=1.0),
        langevin=LangevinParams(temp=1.0, damp=10.0, seed=904297),
        skin=pcfg.skin, force_path=pcfg.force_path)


def chain_states(nx=7, chain_len=49, jitter=0.06, seed=3, cap=18, warm=0):
    """(jax cfg, jax state, port cfg, port state) of one small chain melt:
    chain_scene's generated start (nx = 7: 1,372 beads in 28 chains, 5
    cells per axis at skin 0.98, p == 1 in 5 blocks) moved by a numpy
    normal jitter of `jitter`, so that some 1-2 pairs and some non-bonded
    pairs lie inside the WCA cut.  Not nx = 6: its 4 cells per axis lay
    out p = 4 in one block, where JAX's make_pair_kernel puts ~4e9 on a
    live slot (ROADMAP Queue 3).  With
    `warm` > 0 both start instead from the port's chain_warm_up of that
    many steps (on the CPU), the start the main path steps from."""
    ps = pscenes.chain_scene(nx=nx, chain_len=chain_len, device=CPU)
    pcfg = dataclasses.replace(ps.cfg, capacity=dataclasses.replace(
        ps.cfg.capacity, cell_capacity=cap))
    x, mol, bonds = pscenes.chain_lattice(nx, chain_len)
    x = jittered(pcfg, x, seed, jitter)
    v = ps.state.v.numpy()
    if warm:
        st = pscenes.chain_warm_up(pcfg, pinit_state(
            pcfg, x, v=v, mol=mol, bonds=bonds, device=CPU), steps=warm)
        order = torch.argsort(st.tag[st.alive])
        x = st.x[st.alive][order].numpy()
        v = st.v[st.alive][order].numpy()
    jcfg = jax_chain_config(pcfg)
    return (jcfg, jinit_state(jcfg, x, v=v, mol=mol, bonds=bonds), pcfg,
            pinit_state(pcfg, x, v=v, mol=mol, bonds=bonds, device=CPU))


def _mirror(port_obj, jax_obj, path="cfg"):
    """Every field of the port's config object equals the JAX one."""
    if dataclasses.is_dataclass(port_obj):
        for f in dataclasses.fields(port_obj):
            _mirror(getattr(port_obj, f.name), getattr(jax_obj, f.name),
                    f"{path}.{f.name}")
    else:
        assert port_obj == jax_obj, (path, port_obj, jax_obj)


def test_config_fields_agree():
    """Both packages' scenes.obmd_dpd_config build the same configuration
    from the same scene arguments (exact, field by field)."""
    for kw in (dict(scale=0.25), dict(scale=9.0),
               dict(scale=0.5, cell_capacity=15, nbuf=700.0)):
        _mirror(pscenes.obmd_dpd_config(**kw), jscenes.obmd_dpd_config(**kw))


def test_convert_roundtrip_exact():
    """JAX State + PadAux -> port State -> arrays reproduces every field
    bit for bit."""
    from obmd_tpu.integrate import setup as jsetup
    jcfg, jst, _, _ = lattice_states(scale=0.25, cap=15)
    jst = jsetup(jcfg, jst)
    d = jax_arrays(jst)
    back = convert.to_arrays(convert.from_arrays(d, device=CPU))
    assert set(back) == set(d)
    for k in d:
        assert np.array_equal(np.asarray(back[k]), d[k]), k


def test_initial_states_agree():
    """obmd_dpd_scene draws the same gas in both packages."""
    js = jscenes.obmd_dpd_scene(scale=0.25, seed=3)
    ps = pscenes.obmd_dpd_scene(scale=0.25, seed=3, device=CPU)
    jd = jax_arrays(js.state)
    pd = convert.to_arrays(ps.state)
    for k in convert.STATE_FIELDS + convert.OBMD_FIELDS:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), k


def test_state_observables_agree():
    """temperature, kinetic_energy and momentum of one gas agree to float32
    summation order (rtol 1e-5; momentum, a sum near zero, within 1e-5 of
    sum |m v|)."""
    from obmd_tpu import state as jstate
    from obmd_tpu_torch import state as pstate
    js = jscenes.obmd_dpd_scene(scale=0.25, seed=3)
    ps = pscenes.obmd_dpd_scene(scale=0.25, seed=3, device=CPU)
    for name in ("temperature", "kinetic_energy"):
        want = float(getattr(jstate, name)(js.cfg, js.state))
        got = float(getattr(pstate, name)(ps.cfg, ps.state))
        assert want > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    want = np.asarray(jstate.momentum(js.cfg, js.state))
    got = pstate.momentum(ps.cfg, ps.state).numpy()
    scale = float(np.abs(np.asarray(js.state.v)).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_molecule_mode_support_and_refusals():
    """The engine takes MOLECULE mode with bonded terms (path F, the small
    star and LJ boxes) and every keyword of the fix: several templates
    (`mols`/`molfrac`), `charged 1`, `orient`, `shake`, `rigid`, the
    inserted-velocity keywords, maxattempt > 1, nfreq > 1 and the
    candidate keywords; it refuses, each with a message, `rigid` on a
    template whose bonds close a cycle, dihedrals on the branched template and a
    template type beyond the scene's; bonded terms with ATOM-mode
    insertion stay refused."""
    import pytest
    from obmd_tpu_torch.config import DihedralHarmonicParams, MolTemplate
    from obmd_tpu_torch.engine_cellpad import check_supported, supports
    path_f = pscenes.open_star_config(pscenes.open_star_box(20_000), 100_000)
    small = pscenes.mol_box_config("dpd")
    for cfg in (path_f, small, pscenes.mol_box_config("lj"),
                pscenes.open_water_config()):
        assert supports(cfg)
    tpl = small.obmd.mol
    two = dataclasses.replace(tpl, types=(1, 0, 0, 0, 1))
    dimer = MolTemplate(dx=((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0)),
                        types=(0, 0), bonds=((0, 1),))

    def obmd(**kw):
        return dataclasses.replace(small, obmd=dataclasses.replace(
            small.obmd, **kw))
    good = {
        "mols": obmd(mols=(tpl, two)),
        "molfrac": obmd(mols=(tpl, two), molfrac=(0.5, 0.5)),
        "charged": obmd(charged=True),
        "orient": obmd(orient=(0.0, 0.0, 1.0)),
        "shake": obmd(mol=dimer, shake=True),
        "inserted-velocity": obmd(vx=(-1.0, 1.0)),
        "target": obmd(target=(0.0, 0.0, 0.0), vy=(0.0, 1.0)),
        "maxattempt": obmd(maxattempt=2),
        "nfreq": obmd(nfreq=2),
        "gaussian": obmd(gaussian=(1.0, 4.0, 4.0, 0.5)),
        "global": obmd(deposit_global=(-1.0, -0.2)),
        "local": obmd(deposit_local=(-1.0, -0.2, 1.0)),
        "rate": obmd(rate=0.5),
        "rigid": obmd(rigid=True),
    }
    for name, cfg in good.items():
        assert supports(cfg), name
        check_supported(cfg.finalize())
    assert good["shake"].finalize().shake is not None
    bad = {
        "rigid": obmd(rigid=True, mol=dataclasses.replace(
            dimer, dx=dimer.dx + ((0.0, 0.5, 0.0),), types=(0, 0, 0),
            bonds=((0, 1), (1, 2), (0, 2)))),
        "dihedrals": dataclasses.replace(
            small, dihedral=DihedralHarmonicParams(k=1.0)),
        "type": obmd(mol=dataclasses.replace(tpl, types=(2, 0, 0, 0, 0))),
        "ATOM-mode": dataclasses.replace(small, obmd=dataclasses.replace(
            small.obmd, mol=None, mol_len=1)),
    }
    words = {"rigid": "template 0's bond graph has a cycle",
             "dihedrals": "dihedrals", "type": "type 3",
             "ATOM-mode": "ATOM-mode"}
    for name, cfg in bad.items():
        assert not supports(cfg), name
        with pytest.raises((NotImplementedError, ValueError),
                           match=words[name]):
            check_supported(cfg.finalize())
