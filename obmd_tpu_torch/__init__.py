"""obmd_tpu_torch — the OBMD engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of `obmd_tpu` (JAX + Pallas for the TPU), which stays the reference.
This package imports torch and numpy only — never JAX, never `obmd_tpu`.
Module names mirror the reference's, so each counterpart is easy to find;
the TPU kernels of the ported paths live in `forces/pair_kernel.py` and
`forces/usher_kernel.py`, each beside its plain PyTorch version.  These
paths run: the OBMD_DPD open-boundary run (uniform or, with
`gaussian_noise`, LAMMPS' gaussian pair noise), the LJ melt (with thermo
through the pair sweep of `forces/pairs.py`), the open-boundary LJ fluid
(USHER with the lj/cut law under a Langevin thermostat), the FENE chain
melt (1-2 pairs excluded in the pair kernels, FENE bonds), the
open-boundary charged two-type LJ fluid (lj/cut/rf with 1-4 types in the
pair kernel, per-atom charges and types), a dpd/tstat heating ramp (the
noise scaled per step by sqrt(T(step)/t_start)), and the OBMD_DPD deck
under dpd/ext on the neighbor-list engine (`neighbors.py`,
`forces/nlist.py`; `force_path="nlist"` or `"sweep"`).

A LAMMPS input deck runs through `io/script.py` (`run_script(path)`,
`Interpreter`), with its leaves `io/expr.py`, `io/dump.py`,
`io/dump_dcd.py`, `io/checkpoint.py`, `io/lammps_data.py` and
`minimize.py` (FIRE); data files and the xyz and 11-column custom frames
go through the C++ reader and writers of `io/native.py` where they load.
A C or Fortran program drives decks through the C library API
(`csrc/obmdc_torch.cpp` over `capi.py`; `_build.capi_library()` builds it).

Entry points take `device=` ("cuda" by default; asking for the card on a
machine without one raises).  Quick start:

    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import setup, equilibrate, make_run
    from obmd_tpu_torch.observe import make_thermo_fn
    sc = scenes.obmd_dpd_scene(scale=1.0)
    state = setup(sc.cfg, sc.state)
    state = make_run(sc.cfg, 100)(state)
    sc = scenes.lj_melt_scene(nx=20)
    state = make_run(sc.cfg, 400)(setup(sc.cfg, sc.state))
    print(make_thermo_fn(sc.cfg)(state))
    sc = scenes.obmd_lj_scene()
    state = equilibrate(sc.cfg, setup(sc.cfg, sc.state), 400, temp=1.44)
    state = make_run(sc.cfg, 400)(state)
    sc = scenes.chain_scene()
    state = setup(sc.cfg, scenes.chain_warm_up(sc.cfg, sc.state))
    state = make_run(sc.cfg, 400)(state)
    sc = scenes.obmd_ljrf_scene()
    state = equilibrate(sc.cfg, setup(sc.cfg, sc.state), 400, temp=1.44)
    state = make_run(sc.cfg, 400)(state)
    sc = scenes.dpd_tstat_scene()          # T 0.4 -> 2.0 over 1,000 steps
    state = make_run(sc.cfg, 1000)(setup(sc.cfg, sc.state))
    sc = scenes.obmd_dpdext_scene()        # dpd/ext on the nlist engine
    state = make_run(sc.cfg, 400)(setup(sc.cfg, sc.state))
    from obmd_tpu_torch.io.script import run_script
    it = run_script("in.deck")             # a LAMMPS input deck
"""

__version__ = "0.1.0"
