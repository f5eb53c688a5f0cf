"""The nlist and sweep engines against the JAX package's on the OBMD_DPD
deck at scale 0.5 (16.8 x 11.2 x 11.2, 6,319 atoms of
scenes.obmd_dpd_scene's gas, nbuf raised to NBUF so that both buffers ask
for atoms), under the deck's DPD law and under path G's dpd/ext law: setup
and STEPS steps, each from the JAX engine's state before it (handed over
through convert.from_arrays, the Verlet list included), the JAX engine's
own candidate draws injected (test_torch_support.JaxDraws), nattempt = 0
(each candidate's verdict its initial energy against the gate).

Held after setup and every step: slots, tags, alive, every counter, the
cell table, the Verlet rows (entry for entry), their counts, the
tombstones and the rebuild flag exactly; x, xref and v within 2e-4 of
their largest magnitude and f within 2e-4 * max|f| (float32 summation
order); the boundary setpoints within 1e-4 plus 1e-6 of their magnitude.
Then check_invariants on both engines' ended states.

The demand gate: at the deck's own nbuf no buffer needs atoms, the port
skips the search and the insertion on the host, and the state, the
inserted, deleted and failed counts equal the JAX engine's, which searches
with a budget of zero; its usher_iters counts that search's iterations,
the port's only those of calls that need atoms.

The deck's own search (nattempt = 40) inside the engine's setup: both
engines search the same subsets and candidates, each engine's usher_iters
advances by the iterations its search reports, and the search is held one
step at a time on the step-robust candidates (float32 summation order
parts whole 40-step searches in a gas this dense, so whole searches are
not compared)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import obmd_tpu.obmd.subset as jsubset
import obmd_tpu_torch.forces.usher_kernel as pusher
from obmd_tpu.integrate import make_run as jmake_run
from obmd_tpu.integrate import setup as jsetup
from obmd_tpu.observe import check_invariants as jcheck
from obmd_tpu.state import init_state as jinit_state
from obmd_tpu_torch import config as pconfig
from obmd_tpu_torch import convert
from obmd_tpu_torch import scenes as pscenes
from obmd_tpu_torch.integrate import equilibrate, make_run, run_loop, setup
from obmd_tpu_torch.neighbors import NeighborState
from obmd_tpu_torch.obmd.subset import (EPSILON, _batched_energy_force,
                                        pad_subset)
from obmd_tpu_torch.observe import check_invariants

from test_torch_obmd_lj import to_jax
from test_torch_support import CPU, JaxDraws, jax_arrays

SCALE, SEED, NBUF, STEPS = 0.5, 3, 1400.0, 4
# the margins of a step-robust USHER step (chip_smoke.py's)
ROBUST_E, ROBUST_F, ROBUST_X = 1e-4, 0.1, 1e-4
CASES = [("dpd", "nlist"), ("dpdext", "nlist"), ("dpd", "sweep"),
         ("dpdext", "sweep")]
EXACT = ("type", "tag", "alive", "mol", "bond1", "bond2", "step", "maxtag",
         "cell_overflow", "ndeleted", "ninserted", "insert_fail",
         "usher_iters", "table", "cell_id", "nlist", "ncount", "tombstone",
         "force_rebuild", "rebuilds", "overflow")
CLOSE = ("x", "xref", "v", "sim_time")
SETPOINTS = ("momentum_force_left", "momentum_force_right",
             "shear_force_left", "shear_force_right")


def config(law, path, nattempt=0, nbuf=NBUF):
    make = pscenes.obmd_dpdext_config if law == "dpdext" \
        else pscenes.obmd_dpd_config
    cfg = make(scale=SCALE, nbuf=nbuf, force_path=path)
    o = cfg.obmd
    return dataclasses.replace(cfg, obmd=dataclasses.replace(
        o, usher=dataclasses.replace(o.usher, nattempt=nattempt))).finalize()


def start(pcfg):
    """(JAX cfg, JAX state) of obmd_dpd_scene's gas at SCALE."""
    jcfg = to_jax(pcfg)
    st = pscenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=CPU).state
    n = int(st.natoms)
    return jcfg, jinit_state(jcfg, st.x[:n].numpy(), v=st.v[:n].numpy(),
                             seed=SEED)


@functools.lru_cache(maxsize=None)
def runs(law, path):
    """[(JAX arrays, port arrays)] after setup and each of STEPS steps, and
    both engines' ended states."""
    pcfg = config(law, path)
    jcfg, jst = start(pcfg)
    draws = JaxDraws(pcfg, SEED)
    pst = setup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU),
                draw=draws)
    jst = jsetup(jcfg, jst)
    out = [(jax_arrays(jst), convert.to_arrays(pst))]
    jrun = jax.jit(jmake_run(jcfg, 1))
    prun = make_run(pcfg, 1, draw=draws)
    for _ in range(STEPS):
        pst = prun(convert.from_arrays(out[-1][0], device=CPU))
        jst = jrun(jst)
        out.append((jax_arrays(jst), convert.to_arrays(pst)))
    return pcfg, jcfg, out, jst, pst


def assert_match(jd, pd):
    for k in EXACT:
        assert np.array_equal(np.asarray(pd[k]), jd[k]), \
            (k, np.argwhere(np.asarray(pd[k]) != jd[k])[:4])
    for k in CLOSE:
        scale = max(float(np.abs(jd[k]).max()), 1.0)
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=2e-4 * scale,
                                   err_msg=k)
    for k in SETPOINTS:
        np.testing.assert_allclose(pd[k], jd[k], rtol=1e-6, atol=1e-4,
                                   err_msg=k)
    fmax = np.abs(jd["f"]).max()
    assert np.abs(pd["f"] - jd["f"]).max() <= 2e-4 * fmax


@pytest.mark.parametrize("i", range(STEPS + 1))
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_path_matches_jax(case, i):
    """State i (0: after setup) of the port against the JAX engine's."""
    _, _, out, _, _ = runs(*case)
    assert_match(*out[i])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_path_inserts_and_audits(case):
    """Over setup and the steps both buffers took atoms and some failed;
    the atom count balances; check_invariants passes on both engines'
    ended states with the same counters (no cell or list overflow)."""
    pcfg, jcfg, out, jst, _ = runs(*case)
    first, last = out[0][1], out[-1][1]
    assert int(last["ninserted"]) > 0 and int(last["insert_fail"]) > 0
    assert int(last["alive"].sum()) == int(first["alive"].sum()) \
        + int(last["ninserted"]) - int(first["ninserted"]) \
        - int(last["ndeleted"]) + int(first["ndeleted"])
    port = check_invariants(pcfg, convert.from_arrays(last, device=CPU))
    want = jcheck(jcfg, jst)
    assert {k: port[k] for k in want} == want
    assert port["layout_overflow"] == 0 and "skin_trips" not in port


def test_gate_skips_search_with_equal_counters():
    """At the deck's nbuf no buffer needs atoms: setup and one step under
    the deck's own search (nattempt 40) equal the JAX engine's exactly but
    for usher_iters, which the JAX engine advances by its budget-0
    search's iterations and the port leaves at 0."""
    pcfg = config("dpdext", "nlist", nattempt=40, nbuf=None)
    jcfg, jst = start(pcfg)
    draws = JaxDraws(pcfg, SEED)
    pst = setup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU),
                draw=draws)
    pst = make_run(pcfg, 1, draw=draws)(pst)
    jst = jax.jit(jmake_run(jcfg, 1))(jsetup(jcfg, jst))
    jd, pd = jax_arrays(jst), convert.to_arrays(pst)
    assert int(jd["usher_iters"]) > 0 and int(pd["usher_iters"]) == 0
    assert int(pd["ninserted"]) == int(pd["insert_fail"]) == 0
    pd["usher_iters"] = jd["usher_iters"]
    assert_match(jd, pd)


def test_steered_search_tracks_jax():
    """Setup with the deck's 40-iteration search, both engines from one gas
    and one stream of draws, every search recorded: both engines search
    the same subsets and candidates (within 1e-5), and each one's
    usher_iters counter
    advances by the iterations its search reports.  The search is then
    held one step at a time (as chip_smoke.usher_compare holds the kernel):
    the port's search stopped after n and after n + 1 steps against one
    step of the JAX package's search (obmd_tpu.obmd.subset
    usher_search_subset, jitted once) from the port's position after n;
    on every step-robust candidate (energy at least ROBUST_E x max(1, |E|)
    from the gate etarget + eps before and after the step and from uovlp
    before it, |F| >= ROBUST_F, the stepped position at least ROBUST_X
    inside the region) the verdicts and whether it searches on are equal
    and the positions within 1e-4; at least 6 such steps."""
    pcfg = config("dpdext", "nlist", nattempt=40)
    jcfg, jst = start(pcfg)
    jrec, prec = [], []
    jsearch, psearch = jsubset.usher_search_subset, pusher.usher_search

    def jax_recorded(cfg, sub, cand, *a, **k):
        out = jsearch(cfg, sub, cand, *a, **k)
        jax.debug.callback(
            lambda *r: jrec.append(tuple(np.asarray(t) for t in r)),
            sub.x, sub.valid, cand, *out)
        return out

    def port_recorded(cfg, sub_l, sub_r, cand_l, cand_r, *a):
        out = psearch(cfg, sub_l, sub_r, cand_l, cand_r, *a)
        prec.append(((sub_l, sub_r), (cand_l, cand_r), out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsubset, "usher_search_subset", jax_recorded)
        mp.setattr(pusher, "usher_search", port_recorded)
        pst = setup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU),
                    draw=JaxDraws(pcfg, SEED))
        jst = jsetup(jcfg, jst)
        jax.effects_barrier()
    assert len(jrec) == 2 and len(prec) == 1
    (sub_l, sub_r), (cl, cr), (_, _, pit) = prec[0]
    for side, sub, cand in ((0, sub_l, cl), (1, sub_r, cr)):
        jx, jvalid, jcand = jrec[side][:3]
        assert np.array_equal(sub.x.numpy(), jx)
        assert np.array_equal(sub.valid.numpy(), jvalid)
        # the uniform draws' affine map, fused in XLA's compiled code
        np.testing.assert_allclose(cand.numpy(), jcand, rtol=0, atol=1e-5)
    jit_sum = sum(int(r[5].sum()) for r in jrec)
    assert int(np.asarray(jst.obmd.usher_iters)) == jit_sum > 0
    assert int(pst.obmd.usher_iters) == int(pit.sum()) > 0

    o, u = pcfg.obmd, pcfg.obmd.usher
    jo = jcfg.obmd
    jcfg1 = dataclasses.replace(jcfg, obmd=dataclasses.replace(
        jo, usher=dataclasses.replace(jo.usher, nattempt=1)))
    ct = jax.numpy.zeros((cl.shape[0],), jax.numpy.int32)
    jstep = [jax.jit(functools.partial(
        jsearch, jcfg1, jsubset.Subset(
            idx=jax.numpy.zeros(sub.x.shape[0], jax.numpy.int32),
            x=jax.numpy.asarray(sub.x.numpy()),
            type=jax.numpy.asarray(sub.type.numpy()),
            q=jax.numpy.zeros(sub.x.shape[0], jax.numpy.float32),
            valid=jax.numpy.asarray(sub.valid.numpy()),
            overflow=jax.numpy.asarray(False)),
        cand_type=ct, region=region))
        for sub, region in ((sub_l, jo.region5), (sub_r, jo.region6))]
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    sl, sr = pad_subset(sub_l, b), pad_subset(sub_r, b)
    sx, st = torch.stack([sl.x, sr.x]), torch.stack([sl.type, sr.type])
    sv = torch.stack([sl.valid, sr.valid])
    ct2 = torch.zeros((2, cl.shape[0]), dtype=torch.int32)
    lo = torch.tensor([o.region5.lo, o.region6.lo])[:, None]
    hi = torch.tensor([o.region5.hi, o.region6.hi])[:, None]

    def energy(pos):
        return _batched_energy_force(pcfg.pair, sx, st, sv, pos, ct2,
                                     box=pcfg.box)

    def clear(e, v):
        return (e - v).abs() >= ROBUST_E * e.abs().clamp(min=1.0)

    def port(n):
        cfg_n = dataclasses.replace(pcfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(u, nattempt=n)))
        return psearch(cfg_n, sub_l, sub_r, cl, cr, o.region5, o.region6)

    gate = u.etarget + EPSILON
    checked = 0
    prev = port(0)
    for n in range(u.nattempt):
        nxt = port(n + 1)
        pk, ak, ik = prev
        searching = ik == n
        jp, ja, ji = (torch.from_numpy(np.stack([np.asarray(t) for t in z]))
                      for z in zip(*(jstep[s](jax.numpy.asarray(
                          pk[s].numpy())) for s in range(2))))
        e0, f0 = energy(pk)
        e1 = energy(jp)[0]
        face = torch.minimum((jp - lo).abs(), (jp - hi).abs()).amin(-1)
        robust = (searching & clear(e0, gate) & clear(e0, u.uovlp)
                  & clear(e1, gate) & (f0.norm(dim=-1) >= ROBUST_F)
                  & (face >= ROBUST_X))
        checked += int(robust.sum())
        assert torch.equal(nxt[1][robust], ja[robust]), n
        assert torch.equal((nxt[2] == n + 1)[robust], (ji == 1)[robust]), n
        if bool(robust.any()):
            assert float((nxt[0] - jp).abs().amax(-1)[robust].max()) < 1e-4
        prev = nxt
    assert checked >= 6


def test_entry_points_run_the_nlist_engine():
    """equilibrate and run_loop drive the nlist engine (on the port's own
    draws): the state keeps a NeighborState, the callback sees every
    callback_every steps, and the run's invariants hold."""
    pcfg = config("dpdext", "nlist", nattempt=40)
    _, jst = start(pcfg)
    st = setup(pcfg, convert.from_arrays(jax_arrays(jst), device=CPU))
    st = equilibrate(pcfg, st, 4, rescale_every=2)
    assert isinstance(st.nbrs, NeighborState) and st.step == 4
    seen = []
    st = run_loop(pcfg, st, 5, callback=lambda s: seen.append(s.step),
                  callback_every=2)
    assert seen == [6, 8] and st.step == 9
    tel = check_invariants(pcfg, st)
    assert tel["layout_overflow"] == 0 and tel["ninserted"] > 0


SHARED_FAULTS = {
    # a float64 deck runs on the nlist and sweep engines; the cellpad engine
    # refuses its OBMD stage at float64 (words by engine)
    "float64": (lambda c: dataclasses.replace(c, dtype="float64"),
                {"cellpad": "nlist engine", "nlist": None, "sweep": None}),
    "float16": (lambda c: dataclasses.replace(c, dtype="float16"),
                "float16"),
    "masses": (lambda c: dataclasses.replace(c, masses=(1.0, 1.0)),
               "masses"),
    "periodic-x": (lambda c: dataclasses.replace(c, box=dataclasses.replace(
        c.box, periodic=(True, True, True))), "open x axis"),
    "atom-mode-bonds": (lambda c: dataclasses.replace(
        c, bond=pconfig.BondHarmonicParams()), "ATOM-mode"),
    # refused until the rest of the ATOM-mode stage was ported: now every
    # engine takes them (words None)
    "maxattempt": (lambda c: dataclasses.replace(c, obmd=dataclasses.replace(
        c.obmd, maxattempt=2, nfreq=2)), None),
    "inserted-velocity": (lambda c: dataclasses.replace(
        c, obmd=dataclasses.replace(c.obmd, vx=(-1.0, 1.0))), None),
    "dpd-tstat": (lambda c: dataclasses.replace(
        c, pair=pconfig.DPDTstatParams.create(
            t_start=1.0, cutoff=1.0, seed=1, gamma=4.5)), None),
}


@pytest.mark.parametrize("fault", sorted(SHARED_FAULTS))
def test_engines_share_their_refusals(fault):
    """engine_cellpad.check_scene's refusals hold on every engine, with
    one message: the cellpad engine's check_supported and the nlist and
    sweep engines' both raise it for the same faulty OBMD_DPD deck.  The
    deck with maxattempt 2 and nfreq 2, with `vx`, or under dpd/tstat, once
    refused, every engine now takes alike; at float64 the nlist and sweep
    engines take it and the cellpad engine refuses it, naming the nlist
    engine."""
    from obmd_tpu_torch.engine_cellpad import \
        check_supported as cellpad_supported
    from obmd_tpu_torch.integrate import check_supported
    make, by_path = SHARED_FAULTS[fault]
    for path in ("cellpad", "nlist", "sweep"):
        good = pscenes.obmd_dpd_config(scale=0.5, force_path=path)
        check = cellpad_supported if path == "cellpad" else check_supported
        check(good)
        words = by_path[path] if isinstance(by_path, dict) else by_path
        if words is None:
            check(make(good).finalize())
            continue
        with pytest.raises((NotImplementedError, ValueError), match=words):
            check(make(good))
