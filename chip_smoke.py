#!/usr/bin/env python3
"""Smoke run of obmd_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, is right and runs its main path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from obmd_tpu_torch/csrc (one nvcc per source,
     all started together) and, beside them, the host libraries
     (csrc/obmdio.cpp, csrc/obmdc_torch.cpp; one g++ each);
  3. the OBMD_DPD path at a small size (scale 0.25) on the card against the
     same path on the CPU through the plain versions (check_small_path);
     then each kernel against its plain PyTorch version at bench shapes:
     the pair kernel at filing cap 24 on the set-up scale-9 state, the
     USHER kernel on that state's buffer subsets (K = 16 candidates);
  4. the main path as bench.py drives it, through bench_torch.py's own
     functions: obmd_dpd_scene(scale=9, seed=7), setup, equilibrate(1500),
     repack to cap 15, make_run(400) to settle, two timed make_run(400)
     windows, check_invariants; at the repack and after each run the
     kinetic T and the thermal T (observe.profile_temperature over x bins
     as wide as the reference deck's chunks: the mean flow of each taken
     out), the thermal T relaxing to within 5% of the thermostat's 1.0
     (check_thermal);
     then an insertion phase on the same scene with nbuf raised to 1.05 x
     census / alpha (at steady state the feedback budget is zero on almost
     every step), 25 steps at the setup cap, ninserted > 0,
     check_invariants.  Launch counts are zeroed before setup and read
     after the insertion phase;
  5. the pair kernel and the legacy full-stencil kernel (make_dpd_kernel's
     counterpart, DPD law) against their plain versions and each other at
     cap 15 on the repacked state of phase 4, and a torch.profiler trace of
     two relayout epochs of the main path's runner there (device busy time,
     idle share, the operations that take the most device time);
  6. the main path through the full-stencil kernel: FULL_STEPS steps of
     phase 4's production from the same state, make_run(kernel="full"),
     launch counts zeroed before and read after, check_invariants;
  7. the LJ melt path as bench_lj.py drives it, through bench_lj_torch.py's
     own functions (scene, production): lj_melt_scene(nx=20)
     (32,000 atoms, fully periodic, cap 36, a p == 1 layout), setup,
     make_run(400) warm, two timed make_run(400) windows, check_invariants;
     thermo (through the pair sweep) at the start and end of the timed
     windows, |dE_tot|/N <= 1e-2 over the 800 steps; launch counts zeroed
     before setup and read after the last window; then a profile of two
     relayout epochs;
  8. the LJ path through the full-stencil kernel: FULL_STEPS steps from the
     ended state of phase 7, counts zeroed before and read after, the same
     energy bar over those steps, check_invariants;
  9. on the ended state of phase 7: forces against the port's pair sweep
     (zero sweep overflow), both kernels against their plain versions and
     each other; then the pair kernel alone at nx = 40 (256,000 atoms, 512
     lanes) on a jittered lattice against its plain version;
 10. the open LJ fluid at a small size (obmd_lj_scene at 16 x 9 x 9 fcc
     cells, 5,184 atoms, nbuf raised, nattempt = 0) on the card against the
     same path on the CPU (check_small_path);
 11. the open LJ fluid's main path: obmd_lj_scene() (BASELINE.json config
     2 at full width: 128 x 14 x 14 fcc cells, 100,352 atoms, x open, cap
     44), setup, equilibrate(OLJ_EQUIL, temp=1.44) to melt the lattice,
     make_run(400) under the Langevin thermostat to settle, two timed
     make_run(400) windows, check_invariants, T within 5% of 0.722 at both
     window ends (thermo through the pair sweep); the buffer censuses and
     the deleted count; then an insertion phase with nbuf raised to 1.05 x
     census / alpha, INS_STEPS steps, ninserted > 0, check_invariants.
     Launch counts are zeroed before setup and read after the insertion
     phase: the pair kernel once per step and at setup, the LJ USHER kernel
     once per step that needs atoms (every insertion step);
 12. on the ended production state of phase 11: the LJ USHER kernel
     against its plain version on the buffer subsets (K = 16; at least one
     candidate starting above uovlp, so that the overlap step runs; the
     shifted law's rows on the same input too), both pair kernels against
     their plain versions and each other, the pair kernel against the
     port's pair sweep; a profile of two relayout epochs; FULL_STEPS steps
     through the full-stencil kernel, check_invariants; the float64 lj
     rows (usher_search_lj_f64) on the same subsets widened to float64,
     kernel-only (check_usher_f64);
 13. the FENE chain melt at a small size (chain_scene(nx=7): 28 chains of
     49 beads, warmed up on the card, then copied to the CPU) on the card
     against the same path on the CPU (check_small_path: slots, tags and
     partner columns exact);
 14. the chain melt's main path (bench/in.chain at full width), through
     bench_chain_torch.py's own functions (start, production):
     chain_scene() (32,000 beads, 320 chains of 100, 31,680 bonds, the
     generated lattice start), chain_warm_up (WARM_STEPS at dt 0.003 and
     filing cap 24, velocity rescale to T = 1; launch counts zeroed before
     and read after; then the warm-up's pair kernel on the warmed state
     against its plain version, and without pbond differing on exactly the
     slots with a 1-2 pair inside the cut), then setup at in.chain's
     settings (dt 0.012, cap 18), make_run(400) to settle, two timed
     make_run(400) windows, check_invariants; T within 5% of 1.0 at both
     window ends (thermo through the pair sweep) and no bond at or beyond
     r0 at any window end.  Launch counts are zeroed before setup and read
     after the last window: the pair kernel, with 2-channel exclusion, once
     per step and at setup;
 15. on the ended state of phase 14: both pair kernels with exclusion
     against their plain versions and each other, the 1-2 pairs inside the
     cut counted (more than zero), and each kernel without pbond differing
     from it on exactly the slots that have such a pair; a profile of two
     relayout epochs; FULL_STEPS steps through the full-stencil kernel,
     check_invariants;
 16. the open charged two-type LJ fluid at a small size
     (obmd_ljrf_scene(nx=16, ny=9), its lattice thinned to 70% of the
     sites so that some uniform candidates lie below etarget, nbuf raised,
     nattempt = 0) on the card against the same path on the CPU
     (check_small_path, charges and types exact); the first step inserts;
 17. its main path: obmd_ljrf_scene() (100,352 atoms, 10,036 ions at
     +-0.5, net charge 0, two-type lj/cut/rf, x open, cap 44), setup,
     equilibrate(OLJ_EQUIL, temp=1.44), make_run(400) to settle, two timed
     make_run(400) windows, check_invariants, T within 5% of 0.722 at both
     window ends; thermo (E_pair/N with the reaction field, pressure), the
     net charge and the ion count at each mark; then the insertion phase
     with nbuf raised to 1.05 x census / alpha, INS_STEPS steps, ninserted
     > 0 (neutral type-0 solvent), check_invariants.  Launch counts are
     zeroed before setup and read after the insertion phase: the pair
     kernel (key ljrf-t2-cap44) once per step and at setup, the USHER
     kernel's lj/cut/rf rows (usher_search_ljrf) once per step that needs
     atoms; make_run(kernel="full") refuses the scene;
 18. on the ended production state of phase 17: the lj/cut/rf USHER launch
     against its plain version on the charged two-type subsets, the pair
     kernel at cap 44 against its plain version and against the port's
     pair sweep, a profile of two relayout epochs; kernel-only checks
     against the plain versions: ljrf at fill cap 20 (that state thinned
     to 40%, relaid out: the big-tile body's configuration), two-type DPD
     on the OBMD_DPD box at scale 1 (a uniform gas, the noise the same
     hash of the same tags and salt), four-type lj with per-pair cutoffs
     on the nx = 20 LJ melt lattice; the fork's LAMMPS golden
     (validation/ljrf_golden/charged.data, 220 charged atoms) through
     setup on the card, every force within 5e-5 * max|f| of dump.ref;
     the float64 lj/cut/rf rows (usher_search_ljrf_f64) on the charged
     subsets widened to float64, kernel-only (check_usher_f64);
 19. path A, OBMD_DPD with LAMMPS' gaussian pair noise (the scene with
     pair.gaussian_noise = True, dataclasses.replace) from phase 4's
     equilibrated state: repacked at cap 15, the gaussian kernel against
     its plain version and one launch of the uniform kernel with the same
     salt, which must differ from it by more than 2e-4 * max|f|; then
     repacked at filing cap 16 (the same 16-rank store: at cap 15 the
     gaussian production overflowed a cell in both trial runs, the uniform
     one never), make_run(400) to settle, two timed make_run(400)
     windows; the thermal T checked as in phase 4, and the kinetic T at
     both window ends within 5% of phase 4's at the same steps;
     check_invariants; then the insertion phase at the setup cap (24) with
     nbuf raised to 1.05 x census / alpha, ninserted > 0,
     check_invariants.  Launch counts are zeroed before the production and
     read after the insertion phase: the gaussian pair kernel (keys
     dpd-gauss-cap16 and dpd-gauss-cap24) once per step, USHER once per
     step that needs atoms.
     Then a profile of two relayout epochs and the gaussian kernel at cap
     16 (the ended production state) and cap 24 (the ended insertion
     state) against its plain version;
 20. path B, a dpd/tstat heating ramp: dpd_tstat_scene() (100,488 atoms,
     T 0.4 -> 2.0 over steps 0-1000, cap 28), setup, make_run(100) ten
     times, T and the ramp's T(step) at each mark; T rises from the first
     mark to the last, the last within 15% of t_stop, check_invariants
     (the relayout period printed); the last 400 steps timed.  Launch
     counts zeroed before setup and read after: the ramp kernel (key
     dpd-ramp-cap28) once per step and at setup.  Then the ramp kernel
     against its plain version at sig_scale 1 and at the window's
     midpoint value, and a profile of two relayout epochs;
 21. the reference binary's dpd/tstat golden
     (validation/dpdtstat_golden/fluid.data, 300 atoms, `pair_style
     dpd/tstat 0.0 0.0 1.2 999`, `pair_coeff 1 1 3.5`) through setup on
     the card: every force within 5e-5 * max|f| of dump.ref;
 22. path C, OBMD_DPD with `near 0.35` insertion (the reference's
     in.obmd_near; the scene's usher=False configuration through
     dataclasses.replace of obmd) from phase 4's equilibrated state:
     repacked at cap 15, make_run(400) to settle, two timed make_run(400)
     windows, check_invariants, then the insertion phase at the setup cap
     (24) with nbuf raised to 1.05 x census / alpha, ninserted > 0, the
     USHER iteration count unmoved, check_invariants.  Launch counts are
     zeroed before the production and read after the insertion phase: the
     pair kernel (dpd-cap15, dpd-cap24) once per step, USHER never.  Then a
     profile of two relayout epochs and the kernel at both caps against
     its plain version;
 23. path D, the JAX package's momentum-conservation box
     (tests/test_conservation.py:34-55, scenes.near_box_scene: 10 x 4 x 4,
     a 7 x 1 x 1 grid with single-cell periodic y and z, cap 112, `near`
     insertion): setup and NEAR_BOX_STEPS steps one at a time, sum(f)
     within test_conservation's bar of the boundary setpoints at every step
     whose buffers both hold atoms, insertions, check_invariants; launch
     counts zeroed before setup and read after (key dpd-1cell-cap112); a
     timed window of NEAR_BOX_STEPS steps and a profile; then both pair
     kernels against their plain versions, each other and the pair sweep,
     and FULL_STEPS steps through the full-stencil kernel;
 23b. path N, the closed periodic DPD box of Milestone A
     (scenes.closed_dpd_scene(n=2000, box_l=8.736, seed=1)): per engine,
     the nlist engine as the scene sets it and the cellpad engine at skin
     0.7 and filing cap 32 (the pair kernel on a fully periodic DPD box of
     5 cells a side; the skin keeps the half-skin budget at dt 0.04),
     launch counts zeroed before setup and read after, 300 steps to
     settle, then the mean kinetic T over 300 more within (0.95, 1.08)
     (the JAX package's tests/test_integrate.py:45-60), check_invariants;
     the nlist engine launches no kernel, the cellpad engine the pair
     kernel once per step and at setup, that launch then held to its
     plain version;
 23c. path N64, path N at float64 (closed_dpd_scene(dtype="float64"), the
     same settings and checks): on the nlist engine every float tensor of
     the ended state float64 and most forces not float32 values; on the
     cellpad engine the state float64 over the dpd-cap32 row's float32
     fields, every force a float32 value (the kernel's, cast up, as the
     JAX engine runs it), the row held to its plain version;
 24. a thin DPD film of ~100k atoms (scenes.dpd_film_scene: the OBMD_DPD
     fluid in 302.3 x 56.0 x 2.0, z one cell), then the same with y open:
     setup and FILM_STEPS steps (keys dpd-1cell-cap32,
     dpd-1cell-openyz-cap32), check_invariants, each kernel against its
     plain version and the pair sweep; the full-stencil kernel on the
     periodic film (FILM_STEPS steps through it), refused on the open one;
 25. path E, the closed star-polymer melt, at a small size
     (star_melt_scene(n_stars=307): 1,535 beads, the L = 8 box, warmed up
     on the card, then copied to the CPU) on the card against the same
     path on the CPU at the production filing cap (check_small_path: slots,
     tags, bond1-bond4 and impr exact; x, v and f not held on the slots of
     ill-conditioned impropers, observe.ill_conditioned_impropers);
 26. its main path: star_melt_scene() (20,000 4-arm stars, 100,000 beads,
     80,000 harmonic bonds, 120,000 angles and 20,000 impropers through an
     atom_style molecular data file, DPD rho 3, dt 0.0025, a relayout
     every step), the 4-channel kernel at the random start's cap 40
     against its plain version, star_warm_up (200 steps at cap 40, 400 at
     cap 24, velocity rescale to T = 1; launch counts zeroed before and
     read after: keys dpd-t2-excl4-cap40 and -cap24), the cap-24 kernel
     (make_pair_kernel's rank-looped body) on the warmed state against its
     plain version and against itself without pbond (they differ on
     exactly the slots with a 1-2 pair inside the cut); then setup at
     production cap 15 (the big-tile body), make_run(STAR_STEPS) to
     settle, two timed make_run(STAR_STEPS) windows, check_invariants, T
     within 5% of 1.0 and no bond reaching 2.0 at every window end
     (thermo with E_bond, E_angle, E_imp through the pair sweep); launch
     counts zeroed before setup and read after: key dpd-t2-excl4-cap15
     once per step and at setup; the cap-15 kernel on the ended state against its plain
     version and without pbond; a profile of two relayout epochs;
 27. the reference binary's bonded goldens through the port's reader and
     setup on the card (DPD a0 = 0, T = 0 for `pair zero`):
     validation/bonded_golden (harmonic bonds, angles, dihedrals) within
     5e-5 * max|f| and validation/improper_golden (impropers on three-arm
     stars, 4-channel exclusion) within 2e-4 * max|f| of dump.ref;
 28. the small molecule-mode paths, one per law of the pair kernel's
     4-channel rows (scenes.mol_box_scene: "dpd" and "dpd1", the star box
     with y and z of 6 cells, 1,200 atoms, two types or one; "lj", "lj1"
     and "ljrf", stars inserted into a stretched LJ lattice of 1,440
     monomers), each on the card against the same path on the CPU
     (check_small_path, nattempt = 0, MOL_SMALL_ETARGET: slots, tags,
     mol, bond1-bond4, impr and rep_atom exact, the first step inserts);
     the launches on the card of each are its row's path launches;
 29. path F, the open star-polymer melt under shear (BASELINE.json config
     4): scenes.open_star_scene() (20,000 stars, 100,000 beads in 99.535 x
     18.3 x 18.3, x open, molecule-mode USHER insertion of the star
     template read from a molecule file, pxy 2.0 on the buffers), the
     warm-up under the stage (star_warm_up: caps 40 and 24; launch counts
     zeroed before and read after; keys dpd-t2-excl4-cap40 and -cap24),
     every molecule whole, the cap-24 kernel against its plain version;
     setup at cap 15 and two timed windows of OPEN_STEPS (launch counts
     zeroed before setup and read after: dpd-t2-excl4-cap15 once per step
     and at setup), check_invariants, T within 5% of 1.0, every molecule
     whole, the bead count at the start and end; the cap-15 kernel on the
     ended state against its plain version and without pbond, a profile
     of two relayout epochs; from that ended state GAUSS_F_STEPS steps
     under gaussian pair noise at cap 15 (launch key
     dpd-t2-gauss-excl4-cap15 the only one, T within 5% of 1.0, every
     molecule whole, the row against its plain version); then the
     insertion phase at cap 24 with nbuf
     raised to 1.05 x census / alpha (in molecules), OPEN_INS_STEPS steps:
     stars inserted in fives, USHER iterations counted, every molecule
     whole, check_invariants, a profile of two insertion steps;
 30. the pair kernel's 4-channel rows a-c on real states whose live atoms
     are grouped into 5-atom stars (star_groups): dpd with one type on
     OBMD_DPD's equilibrated state, lj with one type on the open LJ
     fluid's ended state, lj with two types and lj/cut/rf on the charged
     fluid's, each against its plain version with holes and same bytes
     and against itself without pbond;
 31. path G's checks: phase 4's equilibrated OBMD_DPD state repacked at
     cap 15 and its Verlet list built on the nlist engine
     (rebuild_neighbors), nlist_sweep's forces against the dpd-cap15 pair
     kernel's on one salt within 2e-4 * max|f|, the list's pure pair forces
     summing to within 1e-3 * max|f| of zero; the reference binary's
     dpd/ext golden (validation/dpdext_golden, 300 atoms, T = 0) through
     the nlist engine's setup on the card, every force within 5e-5 *
     max|f| of dump.ref;
 32. path G, the OBMD_DPD deck under `pair_style dpd/ext` (gammaT 2.5, ws
     0.8, wsT 1.3; the deck's a0, gamma, cut, T and seed) on
     force_path="nlist" (scenes.obmd_dpdext_config: 302.346 x 11.198 x
     11.198, K = 72, skin 0.39), from phase 4's equilibrated state (n_max
     1.25 x the ~113,700 atoms of the start): setup, DPDEXT_RELAX steps,
     two timed windows of DPDEXT_STEPS (host clock, synchronized),
     check_invariants (no list or cell overflow), the thermal T relaxing
     to within 5% of 1.0 over the three marks (check_thermal), the net pair
     force within 1e-3 * max|f| of zero, a profile of two steps; then the
     insertion phase with nbuf raised to 1.05 x census / alpha, INS_STEPS
     steps, ninserted > 0, check_invariants.  Launch counts are zeroed
     before setup and read after the insertion phase: the USHER kernel's
     dpd/ext rows (usher_search_dpdext) on every step that needs atoms, no
     other kernel;
 33. the dpd/ext rows on the insertion state's buffer subsets (the nlist
     stage's region_subset rows, n_max // 2 a side) against their plain
     version (check_usher), with the kernel's scratch at that size; the
     float64 dpd/ext rows (usher_search_dpdext_f64) on the same subsets
     widened to float64, kernel-only (check_usher_f64);
 34. the fix's other keywords on the card against the CPU at a small size
     (check_small_path, nattempt 0, SMALL_STEPS steps): the OBMD_DPD small
     deck on the cellpad engine with maxattempt 3, `local`, `vx`/`vy`/`vz`,
     `target` and `id max`; on the nlist engine under dpd/tstat (a
     thermostat-only law) with maxattempt 2, nfreq 2, `gaussian` and
     `rate`, stepped through make_step; the open charged two-type fluid's
     small deck with a census of type 0 (`group_types`), maxattempt 2 and
     `global`;
 35. path H, the OBMD_DPD deck with `maxattempt 4`, `nfreq 2`, `vx`, `vy`
     and `vz -1.732 1.732` and `id max` (scenes.obmd_dpd_keywords_config,
     scale 9) from phase 4's equilibrated state: repack to cap 15,
     make_run(400) to settle, two timed make_run(400) windows,
     check_invariants, the thermal T relaxing to within 5% of 1.0, a
     profile of two relayout epochs.  Launch counts are zeroed before the
     repack and read after phase 36's run;
 36. path H's insertion phase: H_DRAIN of each buffer's atoms taken out
     and nbuf set to the census before it over alpha, so that the feedback
     law asks for more than 3 K atoms a side, at the setup cap.  One stage
     call on the card against the same call on the CPU (nattempt 0, seeded
     draws): slots, tags and counters equal, the setpoints within 1e-5
     relative plus 1e-3, and the setpoints less those of the call without
     the velocity keywords equal to -mass x v / dt of the atoms each side
     inserted; the USHER kernel on that call's four rounds, each round's
     subsets with the earlier rounds' accepted candidates appended, against
     its plain version one step at a time (usher_compare), then on the
     last round's subsets with the edge inputs (check_usher); then
     H_INS_STEPS steps (H_INS_STEPS / 2 stage calls): a stage call that
     inserted more than 2 K atoms (one round inserts at most K a side),
     the USHER kernel launched 4 times on every stage call that needed
     atoms and on no other, check_invariants;
 37. the pair kernel's 4-channel rows under the dpd/tstat ramp and on thin
     axes (run_excl4_small): the small star melt of phase 25 under a
     dpd/tstat ramp, a film of it whose z axis is one cell, then that
     film with y open, EXCL4_SMALL_STEPS steps each on the card (its own
     launch key), each row held to its plain version;
 38. path I, BASELINE config 5's open SPC/E water (open_water_scene:
     99,636 atoms, lj/cut/rf, `charged 1`, `shake`, MOLECULE-mode USHER
     insertion, vx/vy/vz): the lattice melted by water_warm_up under the
     stage, setup, equilibrate(WATER_EQUIL) at 2/3 kT; an insertion phase
     on a copy with WATER_DRAIN of the buffers' waters taken out (nbuf at
     census / alpha, every stage call asking): waters inserted, the share
     of trials that inserted; WATER_PROD production steps from the warmed
     state; after each phase every molecule id 3 atoms or none, the
     constraint error within WATER_CONSTRAINT nm, the net charge within
     WATER_CHARGE e, finite x, v and f, check_invariants, and in
     production thermo's T within WATER_T_WINDOW of 2/3 kT; profiles of a
     production and an insertion step; the row ljrf-t2-excl2-cap150
     against its plain version;
 39. the molecule keywords at a small size on the card against the CPU
     (small_mol_keywords: path I's stage on a dilute water box; the dimer
     and trimer at molfrac with rounds, `orient`, velocities and
     `target`; `gaussian`, `rate` and nfreq 2; `local` with rounds);
 40. path J, the LAMMPS input-deck front end (run_decks, through
     obmd_tpu_torch.io.script.Interpreter on the card, each deck a file in
     a temporary directory): the reference's bench/in.lj verbatim
     (LJ_DECK, 32,000 atoms; T 1.44 at step 0 to 1e-4, T in LJ_DECK_T100
     at step 100, the lj row at the Interpreter's cap against its plain
     version, then FIRE appended: energy falls, fmax falls at least 10x,
     positions finite); examples/OBMD_DPD/in.simulation reading a data
     file written from obmd_dpd_scene(scale=1, seed=7) after equilibrate,
     its run cut to DECK_SMALL_STEPS (thermo lines, check_invariants, its
     configuration against obmd_dpd_config(scale=1), differences logged);
     a deck whose fix obmd takes `v_p` (p = 188+60*sin(2*PI*2*time)),
     pxx evaluated on the card at TPARAM_TIMES against host math; and
     validation/run_ref/in.obmd 9x longer in x (regions, buffersize from
     obmd_dpd_config(scale=9), nbuf 1.05 x census / alpha, read_data of
     phase 4's equilibrated state written by write_data, ave/chunk
     DECK_CHUNK, thermo DECK_THERMO) with dumps, run, write_restart,
     read_restart, run and write_data appended: both kernels launched at
     the deck's cap, atoms inserted, thermo finite with atoms equal to
     the state's, the custom and DCD frames equal to the state at their
     step, the restart equal to the saved state to the byte and the step
     count carried on, write_data reading back to the alive atoms, the
     profile's DECK_BINS bins a block with the bulk's density within
     DECK_RHO_TOL of DECK_RHO, the pair row and USHER against their plain
     versions; ms/step of each run and of the same first run without
     outputs, at the deck's own schedule (neigh_modify check yes: the
     half-skin test every step) and at a static relayout every 10 steps,
     each passing check_invariants; write_data / read_data and one host
     copy of each output timed;
 40b. the port's native I/O and C library API (run_native, after path J,
     on its final state and deck.final.data, ~109k atoms): the data file
     read by the native reader (io/native.py over csrc/obmdio.cpp) and by
     the Python parser, every DataFile field equal, arrays and dtypes,
     native having run, each timed best of NATIVE_REPEATS; the final state
     as an 11-column custom frame natively and in Python, ids and types
     equal and every float within NATIVE_FRAME_TOL (%.6f rounding), and as
     an xyz frame both ways, the same bytes, each timed; the C API on the
     card: tests/test_c_api.py's C client (tests/torch_capi_support.py)
     built with gcc against obmdc_torch and run in a subprocess with
     OBMD_PLATFORM unset on examples/OBMD_DPD/in.simulation (the data
     file of path J's in.simulation deck, 11,214 atoms) cut to CAPI_STEPS
     steps, its checks (ids, the velocity scatter, run 5 after the
     position scatter) required, its tag-ordered positions against two
     in-process capi.Session("cuda") runs of the same calls: equal to the
     byte where the two are, else within their difference (printed);
 41. path K, phase 38's water as rigid bodies (run_rigid:
     open_water_config(rigid=True), the tree template, from phase 38's
     warmed state by tag): setup, equilibrate(WATER_EQUIL), an insertion
     phase as phase 38's, WATER_PROD production steps in two windows; the
     bodies within RIGID_GEOMETRY nm of the template after each phase and
     window, whole waters, the net charge, check_invariants, thermo's T
     within WATER_T_WINDOW of 2/3 kT; profiles of a production and an
     insertion step; the row ljrf-t2-excl2-cap150 on its state against
     its plain version; the binned observables evaluated twice to the
     same bytes; validation/rigid_golden on the card against dump.ref,
     dump.rv and the CPU; the small rigid-water box against the CPU;
 42. path L, the multi-device steps (run_slab: obmd_tpu_torch/parallel,
     each rank a process started by parallel.comm.Launch after the build),
     from phase 4's equilibrated state at scale 9 (~107k atoms): (a) four
     gloo ranks sharing the card, the gathered slab step against the sweep
     engine, SLAB_CHECK_STEPS steps at the insertion phase's nbuf on the
     same replayed draws (nattempt 0 at SLAB_ETARGET): natoms, ndeleted,
     ninserted, the tags equal, positions by tag within 1e-4; (b) at T 0
     the kernel slab step against the gathered one, SLAB_KERNEL_STEPS
     steps, within 1e-5; (c) production through the kernel at the deck's
     nbuf and T, SLAB_WARM + SLAB_PROD steps, ms/step and Mparticle-
     steps/s: no overflow, every atom inside its rank's slab, tags unique,
     the same draws on every rank, the pair kernel once a step on each
     rank with the 4-rank slab's key (launch counts zeroed on each rank
     before and read after), that launch on rank 0's filed rows against
     its plain version; (d) one NCCL rank, SLAB_NCCL_STEPS steps of the
     same production (the 1-rank slab's key held the same way) beside the
     cellpad engine's ms/step from the same start; (e) the same four ranks
     after (a)-(c) running the atom decomposition on OBMD_DPD at scale 1
     against the nlist engine, ATOM_STEPS steps on replayed draws,
     counters equal and positions by tag within 2e-3;
 43. path M, the slab decomposition's MOLECULE mode (run_slab_mol), from
     path F's ended production state (the open star melt under shear,
     ~97k beads, harmonic bonds, angles and impropers, MOL-mode USHER) on
     slabs of 1.3 x the atoms / world slots: (a) four gloo ranks, the
     gathered slab step against the cellpad engine, M_CHECK_STEPS steps
     at an insertion phase's nbuf on the same replayed draws (nattempt 0
     at M_ETARGET): natoms, ndeleted and ninserted (multiples of 5), the
     tags equal, positions by tag within 1e-4, molecules whole; (b) at T
     0 the kernel slab step against the gathered one, M_KERNEL_STEPS
     steps, within 1e-5; (c) production through the kernel at the deck's
     nbuf and T, M_WARM + M_PROD steps, ms/step and Mparticle-steps/s: no
     overflow, every atom inside its rank's slab, tags unique, molecules
     whole, the same draws on every rank, the pair kernel once a step on
     each rank under the slab's 4-channel key, that launch on rank 0's
     filed rows (with their partner-tag channels) against its plain
     version; (d) one NCCL rank, M_NCCL_STEPS steps of the same production
     beside the cellpad engine's ms/step from the same start; (e) the
     dry run's SHAKE water (its cuts rebalanced every step) and the same
     waters as rigid bodies of the tree template under insertion, on the
     card's four slabs against the port's single-device step on the CPU,
     M_SMALL_STEPS steps: SHAKE x within 1e-4, v within 1e-3, constraint
     error <= 1e-5, rigid positions and bodies within RIGID_GEOMETRY; then
     the port's dry run (parallel/dryrun.py, all four paths) on the same
     ranks;
 43b. path O, OBMD_DPD at float64 on the nlist engine (run_float64:
     obmd_dpd_config(scale=9, dtype="float64", force_path="nlist"), from
     phase 4's equilibrated state widened to float64): setup; every float
     tensor float64 at the start and the end; the list's pure pair forces
     against the plain pair_sweep at float64 within 1e-10 * max|f| and
     summing to within 1e-10 * max|f| of zero; O_RELAX steps, two timed
     windows of O_STEPS, check_invariants, the thermal T relaxing to
     within 5% of 1.0 (check_thermal), a profile of two steps beside
     path G's; the insertion phase with nbuf raised to 1.05 x census /
     alpha (INS_STEPS steps, insertions > 0).  Launch counts are zeroed
     before setup and read after the insertion phase: the float64 USHER
     kernel (usher_search_f64) on every step that needs atoms, no other
     kernel; then that kernel on the insertion state's subsets against
     its plain version (check_usher_f64);
 44. the figures of the twenty-two paths (with each path's whole wall time,
     its checks included, and the smoke's total), the kernel figures
     ({"kernels": [...]}), the card line, and last {"ok": true, "device":
     {...}}.

Every pair-kernel check (check_pair: each instantiation family the paths
run, dpd at caps 15 and 24, gaussian, the ramp, lj with periodic or open x,
ljrf with two types, 2- and 4-channel exclusion (the 4-channel rows of dpd
with one or two types, lj with one or two and ljrf), single-cell and open
y/z, and the full-stencil kernel) holds the kernel to its plain version on the
path's state, then again on a copy with holes (holed_inputs: a seeded third
of the live slots killed with their tags left stale, occ stale-high, one
cell filled to the fill cap), and checks that two launches on each input
give the same bytes.

Every USHER check (check_usher: dpd, lj with its shifted rows, ljrf,
dpd/ext) holds
the kernel to its plain version on the state's buffer subsets, then again
on four edge inputs (usher_edge_inputs, 4 x K candidates each: a seeded
third of the valid rows made invalid; candidates within 0.05 of the
periodic y and z faces and of the region's x ends; one cell crowded to 4x
the mean atoms per cell; candidates off the grid, the box or their region,
as `gaussian` draws and the deposit keywords place them: up to a cell
beyond either x end of the grid, far outside the box, beyond the periodic
faces and two box lengths up in z, and with an infinite coordinate), and
one launch with a NaN coordinate in every candidate against the plain
search (verdicts and iterations equal, positions NaN alike),
checks that two launches on each input give the same bytes, and logs the
grid's cells per axis, the mean and largest atoms per cell, the distance
tests per evaluation (the kernel's stencil and all-pairs), the longest
candidate's evaluations and the ms per dependent evaluation.  Every
float64 USHER check (check_usher_f64: dpd on path O, dpd/ext, lj and ljrf
kernel-only) holds the float64 row to its plain version at float64 one
step at a time: verdicts and iterations equal, positions within 1e-9 x
Ly, a step apart only within 1e-9 x |etarget| of the gate; its bound
counts 8-byte reals and float64 operations over 34 TFLOP/s.

Tolerances are the CPU tests': pair forces within 2e-4 * max|f| over alive
slots and |sum f| <= 1e-3 * max|f| (kernel against plain, kernel against
kernel, and the LJ kernel's forces against the sweep); USHER verdicts equal
on margin-robust candidates (|E - etarget| >= 0.3 at both final positions),
positions within 2e-3, at least 6 candidates checked.  A kernel's ms is
CUDA events around 20 calls launched back to back behind a sleep kernel
that holds the card while the host enqueues them, over 20, the median of
3 such runs (time_ms); an USHER kernel's ms is its whole C call, binning
and search; bound_ms is the larger of its
bytes (each input read once, each output written once; of a dead slot only
the x that marks it dead) over 3.35 TB/s and its float32 operations over
67 TFLOP/s (H100 SXM data sheet; the work counted from this run's inputs by
pair_work and usher_work: a distance test for every candidate pair, the
law only for the pairs within their own cutoff and not excluded, the
reaction field only for the pairs of two charged atoms within rc_coul;
with exclusion each alive slot also reads its two or four partner tags,
and the LJ law its tag; a charged law reads q and 2-4 types the type of each alive
slot, and every typed launch its tables once; an USHER search tests the
atoms of the 27 cells around each evaluated position, and reads each
subset row's valid flag and the valid rows' x and type once and writes
and reads its sorted rows and cell table once, its all-pairs bound beside
it).
No PyTorch call computes any kernel's function, so library_ms is null;
x_bound is ms / bound_ms.
The OBMD_DPD and open LJ paths record the most atoms in one cell after
their repack or melt and after each
production window: the margin left before a cell overflow, which
check_invariants turns into a failure.
"""
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

# the smoke's clock: every log line starts with the seconds since import
T_START = time.perf_counter()
DEV = "cuda"
# the main path's sizes are bench_torch.py's (bench.py's scene,
# equilibration, production cap and windows); the insertion phase's steps
INS_STEPS = 25
# the width of the x bins whose mean velocity profile_temperature takes
# out: the reference deck's chunks (validation/run_ref/in.obmd, 50 bins)
T_BIN = 33.594 / 50
# path A's production filing cap: the same 16-rank store as cap 15, one
# more atom per cell (gaussian noise's unbounded kicks overflowed cap 15)
GAUSS_CAP = 16
SMALL_SCALE, SMALL_SEED, SMALL_NBUF, SMALL_STEPS = 0.25, 1, 700.0, 4
# the LJ melt path's sizes are bench_lj_torch.py's (bench_lj.py's deck and
# window); the kernel-only check's size, and the steps each path runs
# through the full-stencil kernel
LJ_WIDE_NX, FULL_STEPS = 40, 200
# the open LJ fluid: its lattice (128 x 14 x 14 fcc cells, 100,352 atoms),
# the melt at T0 = 1.44, the production windows, the small path's lattice
OLJ_NX, OLJ_NY, OLJ_EQUIL, OLJ_STEPS = 128, 14, 400, 400
OLJ_SMALL = (16, 9)
# the chain melt's sizes are bench_chain_torch.py's (bench/in.chain's
# 32,000 beads, its window); the small path's 28 chains of 49 beads (nx =
# 7) and their warm-up
CHAIN_SMALL, CHAIN_SMALL_WARM = (7, 49), 300
# the open charged fluid: the small path's share of lattice sites kept, the
# kernel-only check at fill cap 20 and the share of the ended state it keeps
RF_SMALL_KEEP, RF_CAP_SMALL, RF_CAP_SMALL_KEEP = 0.7, 20, 0.4
# the fork's LAMMPS forces on a charged box (validation/run_ljrf_golden.py)
# and the reference binary's dpd/tstat forces
# (validation/run_dpdtstat_golden.py)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "validation", "ljrf_golden")
TSTAT_GOLDEN_DIR = os.path.join(os.path.dirname(GOLDEN_DIR),
                                "dpdtstat_golden")
# path B: the ramp's marks (make_run(TSTAT_MARK) TSTAT_MARKS times) and the
# timed tail of the ramp
TSTAT_MARK, TSTAT_MARKS, TSTAT_TIMED = 100, 10, 400
# path E, the star-polymer melt: its steps per window, the longest bond
# allowed (~13 thermal deviations sqrt(kT / 2K) = 0.11 above r0 = 0.55),
# the small path's 307 stars (the L = 8 box) and its warm-up stages
STAR_STEPS, STAR_BOND_LIMIT = 100, 2.0
STAR_SMALL, STAR_SMALL_WARM = 307, (100, 100)
# path F, the open star melt under shear: its production windows (two of
# OPEN_STEPS at scenes.STAR_PROD_CAP, as star_probe --open read it), the
# insertion phase's steps (at the warm-up's cap), the small molecule-mode
# paths' USHER targets (nattempt 0: about a third of the trials pass, so
# that the first step inserts on every law's box) and the stars' partner
# search in the 4-channel row checks
OPEN_STEPS, OPEN_INS_STEPS = 100, 50
MOL_SMALL_ETARGET = {"dpd": 36.0, "dpd1": 36.0, "lj": 20.0, "lj1": 20.0,
                     "ljrf": 20.0}
STAR_NEIGHBOURS = 16
# path G, the OBMD_DPD deck under dpd/ext on the nlist engine: the steps
# that relax the thermostat after the switch, and the steps of each timed
# window
DPDEXT_RELAX, DPDEXT_STEPS = 200, 200
# path O, the OBMD_DPD deck at float64 on the nlist engine: the steps
# after setup and of each timed window (path G's, so that the thermal T's
# three marks are as far apart)
O_SCALE, O_RELAX, O_STEPS = 9.0, DPDEXT_RELAX, DPDEXT_STEPS
# path C's `near` distance (the reference's in.obmd_near: near 1 0.35),
# path D's steps (the first insertions come near step 45) and the steps the
# DPD film runs before its kernel checks
NEAR, NEAR_BOX_STEPS, FILM_STEPS = 0.35, 200, 10
# path N, the closed DPD box of Milestone A (tests/test_integrate.py:45-60):
# the scene's arguments, the steps that settle it, the steps its mean T is
# taken over and the window that mean must lie in
CLOSED_BOX = dict(n=2000, box_l=8.736, seed=1, temp=1.0)
CLOSED_SETTLE, CLOSED_MEAN, CLOSED_T = 300, 300, (0.95, 1.08)
# the box on the cellpad engine: at dt 0.04 the fastest atom moves up to
# 0.26 in a step (a CPU rehearsal of this phase), more than half the
# scene's skin of 0.3, and the cellpad engine counts a move past half its
# skin between relayouts as a fault; skin 0.7 (5 cells of 1.747 a side,
# ~16 atoms a cell) keeps that budget, and filing cap 32 the random start's
# fullest cell
CLOSED_CELLPAD_SKIN, CLOSED_CELLPAD_CAP = 0.7, 32

# the seed of the holes each pair-kernel check adds (holed_inputs), also
# the USHER edge inputs' (usher_edge_inputs), which try EDGE_K x K
# candidates a side, so that each holds enough margin-robust ones
HOLES_SEED = 9
EDGE_K = 4
# the share of a cell by which stale_inputs moves every live atom down each
# periodic axis
STALE_SHIFT = 0.04
# path H's insertion phase: the share of each buffer's atoms taken out, the
# steps (two per stage call at nfreq 2) and the seed of its one-call checks
H_DRAIN = 0.25
H_INS_STEPS = 50
H_SEED = 13
# the margins of a step-robust USHER step (usher_compare): the two float32
# summation orders give energies ~1e-7 x |E| apart and positions ~1e-6
ROBUST_E = 1e-4
ROBUST_F = 0.1
ROBUST_X = 1e-4
# the float64 USHER rows against their plain version (check_usher_f64):
# whole searches' positions within USHER_F64_POS x Ly, a verdict apart
# only within USHER_F64_GATE x |etarget| of the gate
USHER_F64_POS, USHER_F64_GATE = 1e-9, 1e-9
# path I, BASELINE config 5's open SPC/E water: the steps equilibrate runs
# after setup (thermo's T rescaled to 2/3 kT, scenes.WATER_THERMO_T), the
# insertion phase's share of each buffer's waters taken out, its steps and
# seed, the production's steps (two windows), the window that thermo's T
# keeps about 2/3 kT, and the largest constraint error and net charge
# allowed
WATER_EQUIL, WATER_INS_STEPS, WATER_PROD = 200, 60, 1000
WATER_DRAIN, WATER_SEED = 0.25, 17
WATER_T_WINDOW = 0.05
WATER_CONSTRAINT, WATER_CHARGE = 1e-5, 1e-3
# path K, path I's water as rigid bodies: the largest distance error of a
# body against the template allowed (nm; float32 rounding at |x| ~ 28 nm is
# ~2e-6 a step, a wrong body sum tears a water apart within a few steps);
# the rigid golden's gates (validation/run_rigid_golden.py: positions 5e-3,
# arms 1e-4; velocities against dump.rv 5e-3) and the card's positions
# against the CPU's after its 40 steps
RIGID_GEOMETRY = 5e-4
RIGID_GOLDEN_POS, RIGID_GOLDEN_ARM, RIGID_GOLDEN_VEL = 5e-3, 1e-4, 5e-3
RIGID_GOLDEN_CPU = 1e-4
# path K64, path K's end at float64 without the stage: the waters with an
# atom within K64_MARGIN nm of an open x face are left out (nothing
# holds the faces' fluid in without the stage), so that in K64_STEPS steps
# (0.1 ps) no atom reaches a face, which the phase asserts
K64_MARGIN, K64_STEPS = 0.5, 50
# path J's quiet deck also under a static relayout every 10 steps (the
# outputs' chunk), beside the deck's own schedule (neigh_modify check yes:
# the half-skin test every step)
DECK_STATIC_SCHEDULE = "neigh_modify every 10 check no"
# path F under gaussian noise: its steps; the small 4-channel boxes' steps
# (the ramp box and the films)
GAUSS_F_STEPS, EXCL4_SMALL_STEPS = 100, 20
# cycles of the sleep kernel that holds the card while time_ms enqueues a
# batch (~10 ms at an H100's 1.98 GHz boost clock)
HOLD_CYCLES = 20_000_000
# the side process's torch threads (one core of the card machine's 8:
# with four, the paths it ran beside drove the card 10-50% slower) and how
# long a check waits for its run
SIDE_THREADS = 1
SIDE_TIMEOUT_S = 600.0
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the H100 SXM's float64 rate outside the tensor cores (data sheet): the
# float64 USHER rows' operations are counted against it
F64_OPS_PER_S = 34e12
# float32 operations of one candidate-pair distance test (3 subtractions;
# minimum image on y and z: multiply, round, fused multiply-add each;
# squared norm: 3 multiplies, 2 adds) and of one in-cutoff DPD evaluation
# (rsqrt, r, wd, the relative-velocity dot product, the 32-bit counter
# hash, the uniform noise, the force scalar, the 3-component accumulation
# on both atoms of the pair)
OPS_PAIR_TEST = 14
OPS_PAIR_FORCE = 45
# a periodic x adds its minimum image (3) to the distance test; one
# in-cutoff LJ evaluation: 1/r^2, r^-6 (2 multiplies), the force scalar
# (4), the 3-component accumulation on both atoms of the pair (12)
OPS_MI_X = 3
OPS_LJ_FORCE = 19
# float32 operations of one (candidate, subset atom) USHER distance test,
# which every valid subset atom takes at every energy evaluation: the pair
# kernel's test and the cutoff compare
OPS_USHER_TEST = OPS_PAIR_TEST + 1
# the law's further operations on an atom within the cutoff.  dpd: the
# r ~ 0 test, sqrt, 1/r with its clamp (2), wd (2), the energy term and its
# accumulation (5), the force scalar (2), the 3-component accumulation (6);
# lj/cut: the r ~ 0 test, 1/r^2 with its clamp (2), r^-6 (2), the energy
# term with its shift and accumulation (5), the force scalar (6), the
# 3-component accumulation (6)
OPS_USHER_DPD = 19
OPS_USHER_LJ = 22
# the reaction field on one in-cutoff pair of charged atoms: the cutoff
# compare, rsqrt, r^-2 and r^-3 (2), qq qi qj (2), c_rf / rc^3 and the
# subtraction (2), the product and its add to the force scalar (2); the
# LJ term's own cutoff compare in a typed law
OPS_RF_FORCE = 10
OPS_TYPED_LJ = 1
# gaussian noise on one in-cutoff DPD pair, beyond the uniform noise it
# replaces (whose 3 operations it saves): the second fmix32 with its xor
# (9), u2 (shift, convert, scale: 3), the clamp (1), logf (~20 in CUDA's
# accurate libdevice expansion), -2 x (1), sqrtf (~8: reciprocal square
# root and its correction), 2 pi u2 (1), cosf (~25: range reduction and
# polynomial; its slow path for |x| > 1e5 is never taken), the product (1)
OPS_GAUSS = 9 + 3 + 1 + 20 + 1 + 8 + 1 + 25 + 1 - 3
# a dpd/tstat ramp's sig_scale multiply on one in-cutoff pair
OPS_RAMP = 1


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    side_stop()
    sys.exit(1)


def log(msg: str):
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 20, warmup: int = 3, batches: int = 3) -> float:
    """One call's time on the card: CUDA events around `reps` calls
    launched back to back, over reps; the median of `batches` such runs,
    after `warmup` calls.  A sleep kernel of HOLD_CYCLES holds the card
    while the host enqueues the batch, so a call whose host side takes
    longer than its kernels is still timed on the device."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, ops_per_s: float = None):
    """The least time (ms) of n_bytes moved and n_ops done (float32 at
    F32_OPS_PER_S unless another rate is given) and which bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (ops_per_s or F32_OPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Side:
    """The side process: one worker of a spawn-context pool that computes
    the CPU references needing no card (the small paths' CPU runs, the
    rigid golden's) while the card runs the paths; its jobs by label, each
    with the spec it was queued with."""
    pool = None
    jobs = {}


def _side_init():
    # no CUDA context in the side process, its torch threads on
    # SIDE_THREADS of the cores and below the driving process's priority
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(10)
    import torch
    torch.set_num_threads(SIDE_THREADS)


def _spec(make, unsteady=None, runner="run"):
    """What a small path's CPU run depends on, comparable: make's function
    and its string arguments, unsteady's name, the runner."""
    fn = getattr(make, "func", make)
    return (fn.__name__, tuple(a for a in getattr(make, "args", ())
                               if isinstance(a, str)),
            getattr(unsteady, "__name__", None), runner)


def side_start():
    import multiprocessing as mp
    Side.pool = mp.get_context("spawn").Pool(1, initializer=_side_init)


def side_queue(label, fn, *args):
    """Queue fn(*args) on the side process under `label`."""
    Side.jobs[label] = (Side.pool.apply_async(fn, args), args)


def side_queue_small(label, make, unsteady=None, runner="run"):
    """Queue a small path's CPU run (small_run) under `label`."""
    side_queue(label, small_run, make, "cpu", unsteady, runner)


def side_take(label, small=None):
    """The side process's result under `label` (waiting for it), or None
    when none was queued.  `small`, for a small path's run: the (make,
    unsteady, runner) of the check, which must be the queued run's."""
    if label not in Side.jobs:
        return None
    job, args = Side.jobs.pop(label)
    if small is not None and _spec(*small) != _spec(args[0], *args[2:]):
        fail(f"{label}: the side process ran {_spec(args[0], *args[2:])}, "
             f"the check asks for {_spec(*small)}")
    try:
        return job.get(timeout=SIDE_TIMEOUT_S)
    except Exception as e:  # noqa: BLE001 -- the side's traceback
        fail(f"{label}: the side process's run failed: {e!r}")


def side_stop():
    if Side.pool is not None:
        Side.pool.terminate()
        Side.pool.join()
        Side.pool = None


class KeepCounts:
    """Launches made to compare a kernel with its plain version do not
    count: restore the launch counts on exit."""

    def __enter__(self):
        from obmd_tpu_torch import _build
        self.saved = {k: (v.launches, dict(v.launches_by_shape))
                      for k, v in _build.KERNELS.items()}

    def __exit__(self, *exc):
        from obmd_tpu_torch import _build
        for k, (n, by) in self.saved.items():
            _build.KERNELS[k].launches = n
            _build.KERNELS[k].launches_by_shape = by


def pair_work(geom, fld, coef, tag=None, pbond=None):
    """(alive slots, unordered candidate pairs of alive atoms in the 27-cell
    stencil, unordered pairs within their cutoff and not excluded,
    unordered pairs of two charged atoms within rc_coul) of this input:
    the least work of the function, each pair visited once."""
    import torch
    from obmd_tpu_torch.forces.pair_kernel import (TABLE_ROWS,
                                                   _neighbor_columns,
                                                   _table_tensor,
                                                   neighbor_offsets)
    nb, nf, cap, lanes = fld.shape
    fl = fld.permute(0, 3, 1, 2).reshape(nb * lanes, nf, cap)
    icol, cols, oks = _neighbor_columns(geom, fld.device)
    self_o = neighbor_offsets(geom).index((0, 0, 0))
    if pbond is not None:
        tl = tag.permute(0, 2, 1).reshape(nb * lanes, cap)
        pb = pbond.permute(0, 3, 1, 2).reshape(nb * lanes, pbond.shape[1],
                                               cap)[icol]
    live = fl[:, 0, :] < 0.5e8
    not_self = ~torch.eye(cap, dtype=torch.bool, device=fld.device)
    per_y, per_z = geom.periodic_yz
    lengths = (coef.lx if coef.periodic_x else 0.0,
               coef.ly if per_y else 0.0, coef.lz if per_z else 0.0)
    if coef.typed:
        cut2 = _table_tensor(coef, fld.device)[TABLE_ROWS.index("cut2")]
    cand = inside = coul = 0
    for o in range(cols.shape[0]):
        xj = fl[cols[o]]
        ok = oks[o][:, None, None] & live[icol][:, :, None] \
            & live[cols[o]][:, None, :]
        if o == self_o:
            ok = ok & not_self
        rsq = 0.0
        for c in range(3):
            d = fl[icol, c, :, None] - xj[:, c, None, :]
            if lengths[c]:
                d = d - lengths[c] * torch.round(d / lengths[c])
            rsq = rsq + d * d
        if coef.ntypes > 1:
            t = coef.ntypes
            tp = (fl[icol, nf - 1, :, None].long() * t
                  + xj[:, nf - 1, None, :].long()).clamp(0, t * t - 1)
            law = ok & (rsq < cut2[tp])
        elif coef.typed:
            law = ok & (rsq < cut2[0])
        else:
            law = ok & (rsq < coef.cut * coef.cut)
        if coef.law == "ljrf":
            qq = (fl[icol, 6, :, None] * xj[:, 6, None, :]) != 0.0
            coul += int((ok & qq & (rsq < coef.tables[2])).sum())
        if pbond is not None:
            tj = tl[cols[o]][:, None, :]
            for c in range(pb.shape[1]):
                law = law & (tj != pb[:, c, :, None])
        cand += int(ok.sum())
        inside += int(law.sum())
    return int(live.sum()), cand // 2, inside // 2, coul // 2


def pair_bound(geom, fld, coef, tag=None, pbond=None):
    """(bound_ms, bound_by, candidate pairs, in-cutoff pairs that take the
    law, charged pairs that take the reaction field) of one pair-kernel
    call on this input."""
    n_live, n_cand, n_in, n_coul = pair_work(geom, fld, coef, tag, pbond)
    slots = geom.n_slots
    # x of every slot (it tells dead from alive), the other fields the law
    # reads of the alive slots (dpd: y, z, v and tag; lj: y, z; ljrf: q
    # too; with 2-4 types: the type), occ, and the force of every slot;
    # with exclusion the two partner tags of each alive slot, and its tag
    # for the lj law; a typed launch's tables once
    per_live = (6 if coef.law == "dpd" else 2) + (coef.law == "ljrf") \
        + (coef.ntypes > 1)
    if pbond is not None:
        per_live += pbond.shape[1] + (coef.law != "dpd")
    n_bytes = (slots * 4 + n_live * per_live * 4 + geom.n_blocks * 4
               + slots * 3 * 4 + len(coef.tables) * 4)
    # an open y or z axis takes no minimum image (as many operations as
    # periodic x's)
    test = OPS_PAIR_TEST + (OPS_MI_X if coef.periodic_x else 0) \
        - OPS_MI_X * (2 - sum(geom.periodic_yz))
    force = OPS_PAIR_FORCE + OPS_GAUSS * coef.gaussian \
        + OPS_RAMP * coef.ramp if coef.law == "dpd" else (
            OPS_LJ_FORCE + OPS_TYPED_LJ * coef.typed)
    return bound(n_bytes, n_cand * test + n_in * force
                 + n_coul * OPS_RF_FORCE) + (n_cand, n_in, n_coul)


def compare_forces(geom, alive, got, want, label):
    """Kernel-layout forces against a reference: max error over alive slots
    (alive: bool over the slots) within 2e-4 * max|f|, finite, zero on dead
    slots, |sum f| <= 1e-3 * max|f|.  Returns (max error, max|f|, |sum
    f|)."""
    import torch
    sel = alive.reshape(geom.n_blocks, 1, geom.cap, geom.lanes) \
        .expand_as(want)
    scale = float(want[sel].abs().max())
    err = float((got - want)[sel].abs().max())
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite forces")
    if not err <= 2e-4 * scale:
        fail(f"{label}: max error {err} > 2e-4 * {scale}")
    if bool((got[~sel] != 0.0).any()):
        fail(f"{label}: force on a dead slot")
    fsum = float(got.permute(0, 2, 3, 1).reshape(-1, 3)[
        alive.reshape(-1)].sum(0).abs().max())
    if not fsum <= 1e-3 * scale:
        fail(f"{label}: |sum f| {fsum} > 1e-3 * {scale}")
    return err, scale, fsum


def against_sweep(cfg, geom, state, f_k, label):
    """Kernel-layout forces f_k against the port's pair sweep on the same
    state (the sweep under cfg without its OBMD stage and thermostat;
    zero sweep overflow).  Returns (max error, max|f|)."""
    import torch
    from obmd_tpu_torch.integrate import compute_forces, make_grid_spec
    cfg = dataclasses.replace(cfg, obmd=None, langevin=None)
    pf, ctab = compute_forces(cfg, make_grid_spec(cfg), state)
    if int(ctab.overflow) != 0:
        fail(f"{label} sweep: cell overflow {int(ctab.overflow)}")
    f_sweep = pf.f.reshape(geom.n_blocks, geom.cap, geom.lanes, 3) \
        .permute(0, 3, 1, 2)
    err, scale, _ = compare_forces(
        geom, state.alive, f_k, torch.where(state.alive.reshape(
            geom.n_blocks, 1, geom.cap, geom.lanes), f_sweep, 0.0),
        f"{label} against the pair sweep")
    log(f"{label} against the pair sweep: max_abs_err {err:.3e} (max|f| "
        f"{scale:.1f})")
    return err, scale


def holed_inputs(geom, fld, tag, occ, pbond, seed=HOLES_SEED):
    """A copy of a pair kernel's inputs with the holes a run leaves: a
    seeded third of the live slots killed (x = y = z = BIG, v = 0; their
    tag, q, type and partner tags left stale), occ left as it was (so
    stale-high), then one seeded cell's dead ranks below the fill cap
    filled with killed atoms, nearest to that cell first (their fields,
    tags and partner tags moved there; their old slots stay dead with the
    same stale tag), and occ of its block raised to the fill cap.  Returns
    (fld, tag, occ, pbond, alive over the slots)."""
    import torch
    from obmd_tpu_torch.cells import BIG
    nb, nf, cap, lanes = fld.shape
    g = torch.Generator().manual_seed(seed)
    f = fld.permute(0, 2, 3, 1).reshape(-1, nf).clone()
    t = tag.reshape(-1).clone()
    pb = None if pbond is None else pbond.permute(0, 2, 3, 1).reshape(
        -1, pbond.shape[1]).clone()
    live = (f[:, 0] < 0.5 * BIG).nonzero().squeeze(1)
    kill = live[torch.randperm(len(live), generator=g)[:len(live) // 3]
                .to(live.device)]
    moved = (f[kill].clone(), t[kill].clone(),
             None if pb is None else pb[kill].clone())
    f[kill, 0:3] = BIG
    f[kill, 3:6] = 0.0
    cell = int(torch.randint(geom.n_cells, (1,), generator=g))
    b, lane = geom.slot_of_cell(cell)
    _, ny, nz = geom.dims
    idx = (cell // (ny * nz), cell // nz % ny, cell % nz)
    centre = torch.tensor([geom.lo[a] + (idx[a] + 0.5) * geom.cell_size[a]
                           for a in range(3)], device=f.device)
    order = ((moved[0][:, 0:3] - centre) ** 2).sum(1).argsort()
    slots = b * cap * lanes + torch.arange(geom.fcap, device=f.device) \
        * lanes + lane
    dead = slots[f[slots, 0] >= 0.5 * BIG]
    take = order[:len(dead)]
    f[dead] = moved[0][take]
    t[dead] = moved[1][take]
    if pb is not None:
        pb[dead] = moved[2][take]
    occ = occ.clone()
    occ[b] = max(int(occ[b]), geom.fcap)
    alive = f[:, 0] < 0.5 * BIG
    log(f"holes: {len(kill)} of {len(live)} live slots killed, {len(dead)} "
        f"moved into cell {cell} (block {b}, lane {lane}), filled to "
        f"{int(alive[slots].sum())} of fill cap {geom.fcap}")
    return (f.reshape(nb, cap, lanes, nf).permute(0, 3, 1, 2).contiguous(),
            t.reshape(tag.shape),
            occ, None if pb is None else pb.reshape(
                nb, cap, lanes, -1).permute(0, 3, 1, 2).contiguous(), alive)


def stale_inputs(geom, fld):
    """A copy of a pair kernel's fld with every live atom moved down each
    periodic axis by STALE_SHIFT of a cell and wrapped into the box, as a
    run moves atoms between two relayouts: an atom that crosses a low face
    keeps its filed cell and lies a box length from it.  Returns (fld, the
    atoms that crossed a face)."""
    import torch
    from obmd_tpu_torch.cells import BIG
    f = fld.clone()
    live = f[:, 0] < 0.5 * BIG
    crossed = torch.zeros_like(live)
    per = (geom.periodic_x,) + tuple(geom.periodic_yz)
    for a in range(3):
        if not per[a]:
            continue
        v = f[:, a] - STALE_SHIFT * geom.cell_size[a]
        low = live & (v < geom.lo[a])
        v = torch.where(low, v + geom.dims[a] * geom.cell_size[a], v)
        f[:, a] = torch.where(live, v, f[:, a])
        crossed |= low
    return f, int(crossed.sum())


def same_bytes(kern, args, sig_scale, label):
    """Two launches on one input give the same bytes (no float atomics, a
    fixed summation order); returns the first launch's forces."""
    import torch
    a = kern(*args, sig_scale=sig_scale)
    b = kern(*args, sig_scale=sig_scale)
    sync()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        fail(f"{label}: two launches on one input differ")
    return a


def check_pair(cfg, geom, state, label, kernel="pair", sig_scale=None):
    """A pair kernel ("pair", make_pair_kernel's, or "full",
    make_dpd_kernel's) on one state (a ramp law's at sig_scale) against
    its plain version (check_pair_inputs).  Returns its figures and its
    forces on the state."""
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    from obmd_tpu_torch.forces.pair_kernel import PairCoef
    fld, tag, salt, occ, pbond = pack_fields(cfg, geom, state)
    return check_pair_inputs(
        geom, PairCoef.of(geom, cfg.pair, cfg.dt),
        _make_kernel(cfg, geom, kernel), (fld, tag, salt, occ, pbond),
        state.alive, f"{kernel} kernel {label}", legacy=kernel == "full",
        sig_scale=sig_scale)


def check_pair_inputs(geom, coef, kern, inputs, alive, label, legacy=False,
                      sig_scale=None):
    """A pair kernel on its inputs (fld, tag, salt, occ, pbond; alive over
    the slots) against its plain version, and again on a copy with holes
    (holed_inputs) and on a copy with atoms across a periodic face
    (stale_inputs); two launches on each input give the same bytes; its
    time (time_ms), the plain version's and its bound.  Returns its
    figures and its forces."""
    from obmd_tpu_torch.forces.pair_kernel import (TilePlan, launch_kind,
                                                   pair_forces_plain)
    fld, tag, salt, occ, pbond = inputs
    plan = TilePlan.of(geom, launch_kind(
        coef, 0 if pbond is None else pbond.shape[1], legacy))

    def plain(fld, tag, pbond):
        return pair_forces_plain(geom, coef, fld, tag, salt, legacy=legacy,
                                 pbond=pbond, sig_scale=sig_scale)
    with KeepCounts():
        f_k = same_bytes(kern, (fld, tag, salt, occ, pbond), sig_scale,
                         label)
        f_p = plain(fld, tag, pbond)
        sync()
        err, scale, fsum = compare_forces(geom, alive, f_k, f_p, label)
        h_fld, h_tag, h_occ, h_pbond, h_alive = holed_inputs(
            geom, fld, tag, occ, pbond)
        f_h = same_bytes(kern, (h_fld, h_tag, salt, h_occ, h_pbond),
                         sig_scale, f"{label} with holes")
        h_err, h_scale, _ = compare_forces(
            geom, h_alive, f_h, plain(h_fld, h_tag, h_pbond),
            f"{label} with holes")
        s_fld, crossed = stale_inputs(geom, fld)
        if crossed:
            f_s = same_bytes(kern, (s_fld, tag, salt, occ, pbond), sig_scale,
                             f"{label}, atoms across a face")
            s_err, s_scale, _ = compare_forces(
                geom, alive, f_s, plain(s_fld, tag, pbond),
                f"{label}, {crossed} atoms across a face")
            stale = (f", {crossed} atoms across a face {s_err:.3e} (max|f| "
                     f"{s_scale:.1f})")
        else:
            stale = ""
        ms = time_ms(lambda: kern(fld, tag, salt, occ, pbond,
                                  sig_scale=sig_scale))
        plain_ms = time_ms(lambda: plain(fld, tag, pbond), reps=3, warmup=1,
                           batches=1)
    b_ms, b_by, n_cand, n_in, n_coul = pair_bound(geom, fld, coef, tag,
                                                  pbond)
    coul = f" / {n_coul} charged in rc_coul" if coef.law == "ljrf" else ""
    log(f"{label}: max_abs_err {err:.3e} (max|f| "
        f"{scale:.1f}), |sum f| {fsum:.3e}, with holes {h_err:.3e} (max|f| "
        f"{h_scale:.1f}){stale}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, {n_cand} candidate / {n_in} in-cutoff pairs"
        f"{coul}, bound {b_ms:.5f} ms, {plan_figures(plan)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), f_k


def plan_figures(plan):
    """The plan's body, tiles, blocks and shared memory; where it takes the
    dense body, that body's resident blocks an SM, its records' bytes and
    its two kernels' ptxas figures."""
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.forces.pair_kernel import dense_resident
    body = "dense" if plan.dense else "tiled"
    text = (f"{body} body, tiles of {plan.tile} cells x {plan.split} blocks "
            f"({plan.n_blocks} blocks, {plan.smem_bytes} B of shared "
            f"memory each")
    if plan.dense:
        regs = {k: v for k, v in _build.ptxas_table(
            _build.KERNELS["pair"].ptxas_info).items()
            if "pair_dense" in k or "dense_compact" in k}
        text += (f", {dense_resident(plan)} resident an SM, "
                 f"{plan.scratch_bytes} B of records; ptxas (registers, "
                 f"stack, shared, spill stores) {regs}")
    return text + ")"


def check_both(cfg, geom, state, label):
    """Both pair kernels against their plain versions and each other."""
    pair, f_pair = check_pair(cfg, geom, state, label, "pair")
    full, f_full = check_pair(cfg, geom, state, label, "full")
    err, _, _ = compare_forces(geom, state.alive, f_full, f_pair,
                               f"full against pair kernel {label}")
    log(f"full against pair kernel {label}: max_abs_err {err:.3e}")
    return pair, full


def usher_work(cfg, sub_l, sub_r, cl, cr, iters):
    """The work of one search on this input, as the kernel does it.  A
    candidate evaluates its energy iters + 1 times, at the positions the
    search reaches after 0 .. iters steps (replayed through the plain
    version).  Each evaluation tests the valid atoms of the cells the
    kernel visits (the 27-cell stencil of the position's cell on the
    side's UsherGrid), and all-pairs every valid subset atom; the law runs
    only on the atoms within the cutoff, counted at those positions.
    Bytes: each Subset row's valid flag, the valid rows' x and type (the
    binning reads no other row's) and the candidates read once and the
    outputs written once, in both forms, each real of the candidates'
    dtype (4 bytes, or 8 for the float64 rows); the kernel's own scratch
    (the sorted rows of four reals and the cell starts, written once and
    read once) is returned apart as scratch_bytes.  Returns a dict of the
    counts and both (bytes, operations)."""
    import torch
    from obmd_tpu_torch.config import LJCutParams, LJCutRFParams
    from obmd_tpu_torch.forces.usher_kernel import UsherPlan, bin_rows
    from obmd_tpu_torch.obmd.subset import usher_search_subset_batch
    o = cfg.obmd
    k = cl.shape[0]
    real = cl.element_size()
    subs = (sub_l, sub_r)
    grids = UsherPlan.of(cfg, o.region5, o.region6, cl.dtype).grids
    counts = [torch.diff(bin_rows(g, s)[1]).cpu() for g, s in
              zip(grids, subs)]
    ct = torch.zeros((k,), dtype=torch.int32, device=cl.device)
    cut2 = cfg.pair.max_cut ** 2
    tests = tests_all = inside = 0
    for n in range(int(iters.max()) + 1):
        cfg_n = dataclasses.replace(cfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(o.usher, nattempt=n)))
        pos = usher_search_subset_batch(cfg_n, sub_l, sub_r, cl, cr, ct,
                                        o.region5, o.region6)[0]
        live = (iters >= n).cpu()            # candidates evaluated here
        for side, (g, sub) in enumerate(zip(grids, subs)):
            d = cfg.box.min_image(pos[side][:, None, :] - sub.x[None, :, :])
            near = sub.valid[None, :] & ((d * d).sum(-1) < cut2)
            inside += int(near[live[side].to(near.device)].sum())
            tests_all += int(live[side].sum()) * int(sub.valid.sum())
            for kk, c3 in enumerate(g.cell3(pos[side]).tolist()):
                if live[side, kk]:
                    tests += int(counts[side][g.stencil_cells(c3)].sum())
    law = OPS_USHER_LJ if isinstance(cfg.pair, (LJCutParams, LJCutRFParams)) \
        else OPS_USHER_DPD
    nvalid = sum(int(s.valid.sum()) for s in subs)
    rows_in = sum(s.x.shape[0] for s in subs) + nvalid * (3 * real + 4) \
        + 2 * k * 3 * real
    out = 2 * k * (3 * real + 4 + 4)
    n_cells = sum(g.n_cells + 1 for g in grids)
    evals = int((iters + 1).sum())
    return dict(
        tests=tests, tests_all_pairs=tests_all, inside=inside, evals=evals,
        bytes=rows_in + out, ops=tests * OPS_USHER_TEST + inside * law,
        scratch_bytes=2 * (4 * real * nvalid + 4 * n_cells),
        bytes_all_pairs=rows_in + out,
        ops_all_pairs=tests_all * OPS_USHER_TEST + inside * law)


def usher_compare(cfg, sub_l, sub_r, cl, cr, label):
    """The law's USHER kernel against its plain version on one input, one
    step at a time, so that the float32 summation order's drift does not
    compound over a search.  The kernel runs with nattempt = n for n = 0 ..
    nattempt: run n + 1 retraces run n and takes one step more, so a
    candidate that had stopped keeps its position, verdict and iterations
    to the byte.  Each candidate still searching after n steps takes one
    step of the plain version from the kernel's position.  On the
    step-robust ones (the plain energy at least ROBUST_E x max(1, |E|)
    from the gate etarget + eps at both positions and from uovlp before
    the step, |F| >= ROBUST_F before it, the stepped position at least
    ROBUST_X from every face of the region), the kernel's verdict and
    whether it searches on equal the plain step's, and the positions lie
    within 2e-3; at least 6 steps are checked.  Two launches of the whole
    search give the same bytes.  The whole searches' verdicts on
    candidates with |E - etarget| >= 0.3 at both end positions are logged
    beside, not held: there the drift has had nattempt steps to grow.
    Returns (the kernel's accepted and iterations, max position error,
    steps checked, candidates that started above uovlp, i.e. took the
    overlap step first)."""
    import torch
    from obmd_tpu_torch.forces.usher_kernel import usher_search
    from obmd_tpu_torch.obmd.subset import (EPSILON, _batched_energy_force,
                                            pad_subset,
                                            usher_search_subset_batch)
    o = cfg.obmd
    u = o.usher
    ct = torch.zeros((cl.shape[0],), dtype=torch.int32, device=DEV)
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    sl, sr = pad_subset(sub_l, b), pad_subset(sub_r, b)
    sx = torch.stack([sl.x, sr.x])
    st = torch.stack([sl.type, sr.type])
    sv = torch.stack([sl.valid, sr.valid])
    ct2 = torch.stack([ct, ct])
    lo = torch.tensor([o.region5.lo, o.region6.lo], device=DEV)[:, None]
    hi = torch.tensor([o.region5.hi, o.region6.hi], device=DEV)[:, None]

    def energy(pos):
        return _batched_energy_force(cfg.pair, sx, st, sv, pos, ct2,
                                     box=cfg.box)

    def clear(e, v):
        return (e - v).abs() >= ROBUST_E * e.abs().clamp(min=1.0)

    def steps_cfg(n):
        return dataclasses.replace(cfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(u, nattempt=n)))

    def kernel(n):
        return usher_search(steps_cfg(n), sub_l, sub_r, cl, cr, o.region5,
                            o.region6)

    def plain(n, pos_l, pos_r):
        return usher_search_subset_batch(steps_cfg(n), sub_l, sub_r, pos_l,
                                         pos_r, ct, o.region5, o.region6)
    gate = u.etarget + EPSILON

    def same(a, b):
        """Equal to the byte, a NaN position equal to a NaN (a candidate
        with an infinite coordinate moves to NaN where its force is
        NaN)."""
        return bool(((a == b) | (a.isnan() & b.isnan())).all()) \
            if a.is_floating_point() else torch.equal(a, b)
    kern = kernel(0)
    checked = steps = 0
    err = 0.0
    for n in range(u.nattempt):
        pk, ak, ik = kern
        nxt = kernel(n + 1)
        pk1, ak1, ik1 = nxt
        searching = ik == n
        done = ~searching[..., None]
        if not (same(torch.where(done, pk1, pk), pk)
                and torch.equal(ak1[~searching], ak[~searching])
                and torch.equal(ik1[~searching], ik[~searching])):
            fail(f"USHER {label}: a candidate that stopped within {n} steps "
                 f"changed in the run of {n + 1}")
        pp, ap, ip = plain(1, pk[0].contiguous(), pk[1].contiguous())
        e0, f0 = energy(pk)
        e1 = energy(pp)[0]
        face = torch.minimum((pp - lo).abs(), (pp - hi).abs()).amin(-1)
        robust = (searching & clear(e0, gate) & clear(e0, u.uovlp)
                  & clear(e1, gate) & (f0.norm(dim=-1) >= ROBUST_F)
                  & (face >= ROBUST_X))
        steps += int(searching.sum())
        checked += int(robust.sum())
        if not (torch.equal(ak1[robust], ap[robust])
                and torch.equal((ik1 == n + 1)[robust], (ip == 1)[robust])):
            fail(f"USHER {label}: step {n + 1}'s verdicts differ from the "
                 f"plain step's on step-robust candidates")
        if bool(robust.any()):
            err = max(err, float((pk1 - pp).abs().amax(-1)[robust].max()))
        kern = nxt
    if checked < 6:
        fail(f"USHER {label}: only {checked} step-robust steps")
    if not err < 2e-3:
        fail(f"USHER {label}: position error {err} >= 2e-3")
    pk, ak, ik = kern
    if not all(same(a, b) for a, b in zip(kern, kernel(u.nattempt))):
        fail(f"USHER {label}: two launches on one input differ")
    pp, ap, ip = plain(u.nattempt, cl, cr)
    ek, ep = energy(pk)[0], energy(pp)[0]
    et = u.etarget
    robust = ((ek - et).abs() >= 0.3) & ((ep - et).abs() >= 0.3)
    overlap = int((energy(torch.stack([cl, cr]))[0] > u.uovlp).sum())
    log(f"usher {label}: B={sub_l.x.shape[0]},{sub_r.x.shape[0]}, "
        f"{checked} of {steps} steps step-robust and equal to the plain "
        f"step, max_abs_err {err:.3e}; accepted {int(ak.sum())}/{ak.numel()}"
        f" (plain {int(ap.sum())}), iterations {int(ik.sum())} (plain "
        f"{int(ip.sum())}), whole searches: verdicts differ on "
        f"{int((ak != ap)[robust].sum())} of {int(robust.sum())} candidates "
        f"with |E - etarget| >= 0.3; {overlap} candidates started above "
        f"uovlp (the overlap step); two launches the same bytes")
    return ak, ik, err, checked, overlap


def off_grid(cfg, grid, region, k, g):
    """k seeded candidates off the USHER grid, the box or the region, as
    `gaussian` draws and the deposit keywords place them, in turn: within
    a cell below and above the grid's x ends, far outside the box in x, a
    hair below the periodic y face, two box lengths up in z, 0.3 beyond
    the z face (outside the region), and with an infinite coordinate; y
    and z uniform over the box."""
    import torch
    lx, ly, lz = cfg.box.lengths
    top = grid.lo[0] + grid.cells[0] * grid.side[0]
    xm = 0.5 * (region.lo[0] + region.hi[0])
    u = torch.rand((k, 3), generator=g, device=DEV)
    y, z = u[:, 1] * ly, u[:, 2] * lz
    kinds = [(grid.lo[0] - (0.05 + 0.9 * u[:, 0]) * grid.side[0], y, z),
             (top + (0.05 + 0.9 * u[:, 0]) * grid.side[0], y, z),
             (-30.0 - lx * u[:, 0], y, z),
             (lx + 30.0 + lx * u[:, 0], y, z),
             (xm + 0 * y, -0.03 * u[:, 0], z),
             (xm + 0 * y, y, z + 2 * lz),
             (xm + 0 * y, y, lz + 0.3 + 0 * z),
             (xm + 0 * y, y + torch.inf, z)]
    out = torch.empty((k, 3), device=DEV)
    for i in range(k):
        c = kinds[i % len(kinds)]
        out[i] = torch.stack([t[i] if torch.is_tensor(t) else
                              torch.tensor(t, device=DEV) for t in c])
    return out.contiguous()


def usher_edge_inputs(cfg, sub_l, sub_r, seed=HOLES_SEED):
    """The four edge inputs of the USHER checks, each (label, sub_l,
    sub_r, cl, cr) with EDGE_K x K seeded
    candidates a side: a third of each subset's valid rows made invalid
    (uniform candidates); candidates within 0.05 of the periodic y and z
    faces and of the region's x ends; each side's first candidate's cell
    crowded to at least 4x the mean atoms per cell with valid atoms moved
    there from farther than 2 cuts in x (uniform candidates); candidates
    off the grid, the box or the region (off_grid)."""
    import torch
    from obmd_tpu_torch.forces.usher_kernel import UsherPlan
    o = cfg.obmd
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    k = EDGE_K * o.insert_kmax
    u = torch.rand((2, k, 3), generator=g, device=DEV)
    cl = o.region5.sample_uniform(u[0])
    cr = o.region6.sample_uniform(u[1])

    def holed(sub):
        drop = torch.rand(sub.valid.shape, generator=g, device=DEV) < 1 / 3
        return sub._replace(valid=sub.valid & ~drop)

    def near_faces(region):
        lo = torch.tensor(region.lo, device=DEV)
        hi = torch.tensor(region.hi, device=DEV)
        u = 0.05 * torch.rand((k, 3), generator=g, device=DEV)
        side = torch.rand((k, 3), generator=g, device=DEV) < 0.5
        return torch.where(side, lo + u, hi - u).contiguous()

    grids = UsherPlan.of(cfg, o.region5, o.region6).grids
    cut = cfg.pair.max_cut

    def crowded(sub, grid, c):
        c3 = grid.cell3(c[None])[0]
        lo = torch.tensor(grid.lo, device=DEV) + c3 * torch.tensor(
            grid.side, device=DEV)
        n_add = int(-(-4 * int(sub.valid.sum()) // grid.n_cells))
        far = torch.nonzero(sub.valid & ((sub.x[:, 0] - c[0]).abs()
                                         > 2 * cut)).flatten()
        move = far[torch.randperm(far.numel(), generator=g,
                                  device=DEV)[:n_add]]
        x = sub.x.clone()
        x[move] = lo + torch.rand((move.numel(), 3), generator=g,
                                  device=DEV) * torch.tensor(grid.side,
                                                             device=DEV)
        return sub._replace(x=x)
    return [
        ("holes", holed(sub_l), holed(sub_r), cl, cr),
        ("faces", sub_l, sub_r, near_faces(o.region5), near_faces(o.region6)),
        ("crowded", crowded(sub_l, grids[0], cl[0]),
         crowded(sub_r, grids[1], cr[0]), cl, cr),
        ("off-grid", sub_l, sub_r, off_grid(cfg, grids[0], o.region5, k, g),
         off_grid(cfg, grids[1], o.region6, k, g))]


def check_nan_candidates(cfg, sub_l, sub_r, label):
    """One launch with a NaN coordinate in every candidate (x, y or z in
    turn) against the plain search: verdicts and iterations equal, every
    position NaN where the plain version's is."""
    import torch
    from obmd_tpu_torch.forces.usher_kernel import launch
    from obmd_tpu_torch.obmd.subset import usher_search_subset_batch
    o = cfg.obmd
    k = o.insert_kmax
    cand = []
    for region in (o.region5, o.region6):
        c = region.sample_uniform(torch.full((k, 3), 0.5, device=DEV))
        c[torch.arange(k), torch.arange(k) % 3] = torch.nan
        cand.append(c.contiguous())
    pk, ak, ik = launch(cfg, sub_l, sub_r, *cand, o.region5, o.region6)
    ct = torch.zeros((k,), dtype=torch.int32, device=DEV)
    pp, ap, ip = usher_search_subset_batch(cfg, sub_l, sub_r, *cand, ct,
                                           o.region5, o.region6)
    if not (torch.equal(ak, ap) and torch.equal(ik, ip)
            and torch.equal(pk.isnan(), pp.isnan())):
        fail(f"USHER {label}: NaN candidates differ from the plain search "
             f"(accepted {ak.tolist()} / {ap.tolist()})")
    log(f"usher {label}: {2 * k} NaN candidates as the plain search: "
        f"{int(ak.sum())} accepted, iterations {int(ik.sum())}")


def usher_grid_figures(cfg, sub_l, sub_r):
    """Each side's grid (cells per axis) and its mean and largest valid
    atoms per cell."""
    import torch
    from obmd_tpu_torch.forces.usher_kernel import UsherPlan, bin_rows
    o = cfg.obmd
    out = []
    for g, s in zip(UsherPlan.of(cfg, o.region5, o.region6).grids,
                    (sub_l, sub_r)):
        n = torch.diff(bin_rows(g, s)[1])
        out.append(dict(cells=list(g.cells),
                        atoms_per_cell_mean=float(n.float().mean()),
                        atoms_per_cell_max=int(n.max())))
    return out


def check_usher(cfg, geom, state, label, subsets=None):
    """The law's USHER kernel against its plain version, one step at a time
    (usher_compare), on the state's buffer subsets (the cellpad engine's
    slot slices, or `subsets` as another engine takes them) with K uniform
    candidates per buffer, then on the three edge inputs
    (usher_edge_inputs); two launches on each input give the same bytes; for the LJ family at least one candidate must take the
    overlap step, and for lj/cut the shifted law's rows run on the same
    input too.  The kernel's ms is the whole C call (binning and search)."""
    import torch
    from obmd_tpu_torch.config import LJCutParams, LJCutRFParams
    from obmd_tpu_torch.engine_cellpad import _subset_slice
    from obmd_tpu_torch.forces.usher_kernel import launch
    from obmd_tpu_torch.obmd.subset import usher_search_subset_batch
    o = cfg.obmd
    k = o.insert_kmax
    pad = cfg.pair.max_cut + cfg.skin
    sub_l, sub_r = subsets or (
        _subset_slice(cfg, geom, state, o.region5, pad),
        _subset_slice(cfg, geom, state, o.region6, pad))
    g = torch.Generator(device=DEV)
    g.manual_seed(1234)
    u = torch.rand((2, k, 3), generator=g, device=DEV)
    cl = o.region5.sample_uniform(u[0])
    cr = o.region6.sample_uniform(u[1])
    ct = torch.zeros((k,), dtype=torch.int32, device=DEV)
    lj = isinstance(cfg.pair, LJCutParams)
    with KeepCounts():
        ak, ik, err, checked, overlap = usher_compare(
            cfg, sub_l, sub_r, cl, cr, label)
        if isinstance(cfg.pair, (LJCutParams, LJCutRFParams)) and overlap < 1:
            fail(f"USHER {label}: no candidate took the overlap step")
        extra = {}
        if lj:
            cfg_s = dataclasses.replace(cfg, pair=dataclasses.replace(
                cfg.pair, shift=True))
            _, _, err_s, checked_s, _ = usher_compare(
                cfg_s, sub_l, sub_r, cl, cr, f"{label}, shifted")
            extra = dict(shifted_max_abs_err=err_s,
                         shifted_robust_steps=checked_s)
        for name, el, er, ecl, ecr in usher_edge_inputs(cfg, sub_l, sub_r):
            _, _, err_e, checked_e, _ = usher_compare(
                cfg, el, er, ecl, ecr, f"{label}, {name}")
            extra[f"{name}_max_abs_err"] = err_e
            extra[f"{name}_robust_steps"] = checked_e
            err = max(err, err_e)
        check_nan_candidates(cfg, sub_l, sub_r, label)
        ms = time_ms(lambda: launch(cfg, sub_l, sub_r, cl, cr, o.region5,
                                    o.region6))
        plain = time_ms(lambda: usher_search_subset_batch(
            cfg, sub_l, sub_r, cl, cr, ct, o.region5, o.region6),
            reps=5, warmup=1, batches=1)
    t0 = time.perf_counter()
    w = usher_work(cfg, sub_l, sub_r, cl, cr, ik)
    work_s = time.perf_counter() - t0
    b_ms, b_by = bound(w["bytes"], w["ops"])
    b_all, b_all_by = bound(w["bytes_all_pairs"], w["ops_all_pairs"])
    grid = usher_grid_figures(cfg, sub_l, sub_r)
    max_evals = int(ik.max()) + 1
    evals = w["evals"]
    figs = dict(
        grid_cells=[s["cells"] for s in grid],
        atoms_per_cell_mean=[round(s["atoms_per_cell_mean"], 3)
                             for s in grid],
        atoms_per_cell_max=[s["atoms_per_cell_max"] for s in grid],
        tests_per_eval=w["tests"] / evals,
        tests_per_eval_all_pairs=w["tests_all_pairs"] / evals,
        bound_all_pairs_ms=b_all, scratch_bytes=w["scratch_bytes"],
        max_evals=max_evals,
        ms_per_eval=ms / max_evals)
    log(f"usher {label}: B={sub_l.x.shape[0]},{sub_r.x.shape[0]}, K={k}, "
        f"grid {grid[0]['cells']} / {grid[1]['cells']} cells, atoms per "
        f"cell mean {figs['atoms_per_cell_mean']} max "
        f"{figs['atoms_per_cell_max']}, kernel {ms:.4f} ms, plain "
        f"{plain:.3f} ms, bound {b_ms:.5f} ms ({b_by}; {w['tests']} "
        f"distance tests, {figs['tests_per_eval']:.1f} per evaluation, "
        f"{w['inside']} within the cutoff), all-pairs bound {b_all:.5f} ms "
        f"({b_all_by}; {w['tests_all_pairs']} tests, "
        f"{figs['tests_per_eval_all_pairs']:.1f} per evaluation), "
        f"{w['bytes']} bytes in and out, {w['scratch_bytes']} of scratch "
        f"(not in the bound), "
        f"{evals} evaluations, longest candidate {max_evals}, "
        f"{1e3 * figs['ms_per_eval']:.2f} us per dependent evaluation "
        f"(counted in {work_s:.2f} s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, **figs), dict(
        B=[sub_l.x.shape[0], sub_r.x.shape[0]], K=k, robust_steps=checked,
        accepted=int(ak.sum()), overlap_candidates=overlap,
        distance_tests=w["tests"], distance_tests_all_pairs=w[
            "tests_all_pairs"], within_cutoff=w["inside"], **extra)


def buffer_subsets(cfg, geom, state):
    """Both buffers' subsets of a cellpad state, as its stage takes them
    (the slot slices)."""
    from obmd_tpu_torch.engine_cellpad import _subset_slice
    o = cfg.obmd
    pad = cfg.pair.max_cut + cfg.skin
    return (_subset_slice(cfg, geom, state, o.region5, pad),
            _subset_slice(cfg, geom, state, o.region6, pad))


def widened(sub):
    """A float32 buffer subset's rows in float64 (exact), for the float64
    USHER rows' kernel-only checks."""
    import torch
    return sub._replace(x=sub.x.to(torch.float64), q=None if sub.q is None
                        else sub.q.to(torch.float64))


def check_usher_f64(cfg, sub_l, sub_r, label):
    """The float64 instantiation of the law's USHER kernel against its
    plain version (usher_search_subset_batch at float64) on float64 buffer
    subsets with K uniform float64 candidates a buffer, one step at a time
    as usher_compare holds the float32 rows, so that the summation order's
    drift does not compound over a search (whole float64 searches of the
    kernel and the plain version, with equal verdicts, end up to a few
    units apart in a liquid after tens of steps): the
    kernel runs with nattempt = n for n = 0 .. nattempt, a candidate that
    had stopped keeps its position, verdict and iterations to the byte,
    and each candidate still searching after n steps takes one step of the
    plain version from the kernel's position.  On every such step the
    kernel's verdict and whether it searches on equal the plain step's and
    the positions lie within USHER_F64_POS x Ly; a step may differ only
    where the energy at the kernel's position before it or at either
    position after it lies within USHER_F64_GATE x |etarget| of the gate
    etarget + eps (their count and margins logged).  Two launches give the
    same bytes; the whole searches' verdicts against the plain whole
    search are logged beside, not held.  Its time is the whole C call; its
    bound counts 8-byte reals and float64 operations at F64_OPS_PER_S.
    Returns (kernel figures, info)."""
    import torch
    from obmd_tpu_torch.forces.usher_kernel import launch
    from obmd_tpu_torch.obmd.subset import (EPSILON, _batched_energy_force,
                                            pad_subset,
                                            usher_search_subset_batch)
    o = cfg.obmd
    u = o.usher
    k = o.insert_kmax
    f64 = torch.float64
    if not all(s.x.dtype == f64 for s in (sub_l, sub_r)):
        fail(f"USHER {label}: the subsets are not float64")
    g = torch.Generator(device=DEV)
    g.manual_seed(1234)
    draws = torch.rand((2, k, 3), generator=g, device=DEV, dtype=f64)
    cl = o.region5.sample_uniform(draws[0])
    cr = o.region6.sample_uniform(draws[1])
    ct = torch.zeros((k,), dtype=torch.int32, device=DEV)
    b = max(sub_l.x.shape[0], sub_r.x.shape[0])
    sl, sr = pad_subset(sub_l, b), pad_subset(sub_r, b)
    ct2 = torch.stack([ct, ct])

    def energy(pos):
        return _batched_energy_force(
            cfg.pair, torch.stack([sl.x, sr.x]), torch.stack(
                [sl.type, sr.type]), torch.stack([sl.valid, sr.valid]),
            pos, ct2, box=cfg.box)[0]

    def steps_cfg(n):
        return dataclasses.replace(cfg, obmd=dataclasses.replace(
            o, usher=dataclasses.replace(u, nattempt=n)))

    def kernel(n=u.nattempt):
        return launch(steps_cfg(n), sub_l, sub_r, cl, cr, o.region5,
                      o.region6)

    def plain(n, pos_l, pos_r):
        return usher_search_subset_batch(steps_cfg(n), sub_l, sub_r, pos_l,
                                         pos_r, ct, o.region5, o.region6)
    gate = u.etarget + EPSILON
    near = USHER_F64_GATE * abs(u.etarget)
    ly = cfg.box.lengths[1]
    err, steps, ties = 0.0, 0, []
    with KeepCounts():
        kern = kernel(0)
        for n in range(u.nattempt):
            pk, ak, ik = kern
            nxt = kernel(n + 1)
            pk1, ak1, ik1 = nxt
            if pk.dtype != f64 or pk1.dtype != f64:
                fail(f"USHER {label}: the kernel's positions are not "
                     f"float64")
            searching = ik == n
            done = ~searching
            if not (torch.equal(pk1[done], pk[done])
                    and torch.equal(ak1[done], ak[done])
                    and torch.equal(ik1[done], ik[done])):
                fail(f"USHER {label}: a candidate that stopped within {n} "
                     f"steps changed in the run of {n + 1}")
            pp, ap, ip = plain(1, pk[0].contiguous(), pk[1].contiguous())
            margin = torch.minimum(
                (energy(pk) - gate).abs(),
                torch.minimum((energy(pk1) - gate).abs(),
                              (energy(pp) - gate).abs()))
            same = (ak1 == ap) & ((ik1 == n + 1) == (ip == 1))
            apart = searching & ~same
            if bool((apart & (margin >= near)).any()):
                fail(f"USHER {label}: step {n + 1}'s verdicts differ from "
                     f"the plain step's clear of the gate (margins "
                     f"{margin[apart].tolist()})")
            ties += margin[apart].tolist()
            held = searching & same
            steps += int(held.sum())
            if bool(held.any()):
                err = max(err, float((pk1 - pp).abs().amax(-1)[held].max()))
            kern = nxt
        if not err <= USHER_F64_POS * ly:
            fail(f"USHER {label}: position error {err} > {USHER_F64_POS} x "
                 f"Ly")
        if steps < 6:
            fail(f"USHER {label}: only {steps} steps checked")
        pk, ak, ik = kern
        if not all(torch.equal(a, c) for a, c in zip(kern, kernel())):
            fail(f"USHER {label}: two launches on one input differ")
        pp, ap, ip = plain(u.nattempt, cl, cr)
        sync()
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: plain(u.nattempt, cl, cr), reps=5,
                           warmup=1, batches=1)
    whole = (ak == ap) & (ik == ip)
    whole_err = float((pk - pp).abs().amax(-1)[whole].max()) \
        if bool(whole.any()) else 0.0
    w = usher_work(cfg, sub_l, sub_r, cl, cr, ik)
    b_ms, b_by = bound(w["bytes"], w["ops"], F64_OPS_PER_S)
    log(f"usher {label} (float64): B={sub_l.x.shape[0]},{sub_r.x.shape[0]}, "
        f"K={k}, {steps} steps equal to the plain step, max position error "
        f"{err:.3e} (bar {USHER_F64_POS * ly:.3e}), {len(ties)} steps apart "
        f"at the gate (margins {ties}); accepted {int(ak.sum())}/"
        f"{ak.numel()} (plain {int(ap.sum())}), iterations {int(ik.sum())} "
        f"(plain {int(ip.sum())}), whole searches: {int((~whole).sum())} "
        f"verdicts or counts apart, the others' positions within "
        f"{whole_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}; {w['bytes']} bytes, {w['ops']} "
        f"float64 operations, {w['evals']} evaluations); two launches the "
        f"same bytes")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), dict(
        B=[sub_l.x.shape[0], sub_r.x.shape[0]], K=k, steps_checked=steps,
        gate_ties=len(ties), gate_tie_margins=ties, accepted=int(ak.sum()),
        iterations=int(ik.sum()), whole_searches_apart=int((~whole).sum()),
        whole_searches_max_pos_err=whole_err)


class SeededDraws:
    """The engine's draw seam fed from one numpy generator, so that a run on
    the card and a run on the CPU try the same candidates: uniform
    positions' draws (standard normals under `gaussian`, the rotation's
    uniform in MOLECULE mode) and, where their keywords are set, the
    deposit z's and the velocities' uniforms and the trials' templates by
    `molfrac` (obmd.stage.Draws), drawn on every stage call."""

    def __init__(self, cfg, seed: int):
        import numpy as np
        from obmd_tpu_torch.engine_cellpad import mol_mode
        from obmd_tpu_torch.obmd.stage import draw_shapes, rounds_of
        from obmd_tpu_torch.config import template_stacks
        self.rng = np.random.default_rng(seed)
        self.mol = mol_mode(cfg)
        self.shapes = draw_shapes(cfg, rounds_of(cfg), cfg.obmd.insert_kmax,
                                  7 if self.mol else 3)
        self.gauss = cfg.obmd.gaussian is not None
        self.frac = template_stacks(cfg.obmd).frac if self.mol else None

    def __call__(self, state, need):
        import numpy as np
        import torch
        from obmd_tpu_torch.obmd.stage import Draws
        f32 = np.float32
        pos = (self.rng.standard_normal(self.shapes["pos"], dtype=f32)
               if self.gauss else self.rng.random(self.shapes["pos"],
                                                  dtype=f32))
        if self.mol and self.gauss:
            # the rotation's draws stay uniform
            pos[..., 3:] = self.rng.random(pos[..., 3:].shape, dtype=f32)
        more = [None if self.shapes[f] is None
                else self.rng.random(self.shapes[f], dtype=f32)
                for f in ("z", "vel")]
        tpl = None
        if self.shapes["tpl"] is not None:
            p = np.asarray(self.frac, np.float64)
            tpl = self.rng.choice(len(p), self.shapes["tpl"],
                                  p=p / p.sum()).astype(np.int32)
        if not need:
            return None
        return Draws(*(None if a is None else
                       torch.from_numpy(a).to(state.device)
                       for a in [pos] + more + [tpl]))


SMALL_EXACT = ("type", "q", "tag", "alive", "mol", "bond1", "bond2", "step",
               "maxtag", "cell_overflow", "ndeleted", "ninserted",
               "insert_fail", "usher_iters", "rebuilds", "overflow",
               "skin_trips", "tag3d", "occ")
SMALL_CLOSE = ("x", "v", "xref", "sim_time", "momentum_force_left",
               "momentum_force_right", "shear_force_left",
               "shear_force_right")


def small_dpd(dev):
    """The OBMD_DPD small path's deck: tests/test_torch_slice.py's (nbuf
    raised so that both buffers insert on every step)."""
    from obmd_tpu_torch import scenes
    sc = scenes.obmd_dpd_scene(scale=SMALL_SCALE, seed=SMALL_SEED,
                               nbuf=SMALL_NBUF, device=dev)
    return sc.cfg, sc.state


def small_obmd_lj(dev):
    """The open LJ fluid's small path: Lx = 16a, Ly = Lz = 9a (5,184
    atoms, 5 cells per periodic axis), nbuf raised to 1.05 x the buffer's
    lattice count / alpha so that both buffers ask for atoms."""
    from obmd_tpu_torch import scenes
    cfg = scenes.obmd_lj_config(nx=OLJ_SMALL[0], ny=OLJ_SMALL[1])
    o = cfg.obmd
    nbuf = 1.05 * o.nbuf / o.alpha ** 2
    sc = scenes.obmd_lj_scene(nx=OLJ_SMALL[0], ny=OLJ_SMALL[1], nbuf=nbuf,
                              device=dev)
    return sc.cfg, sc.state


def small_ljrf(dev):
    """The open charged fluid's small path: obmd_ljrf_scene(nx=16, ny=9)
    (9 x 5 x 5 cells) with its lattice thinned to RF_SMALL_KEEP of the
    sites (numpy seed 1; on the full lattice no uniform candidate lies
    below etarget) and nbuf raised to 1.05 x the buffer's lattice count /
    alpha, so that both buffers ask for atoms."""
    import numpy as np
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.state import init_state
    o = scenes.obmd_ljrf_config(nx=OLJ_SMALL[0], ny=OLJ_SMALL[1]).obmd
    sc = scenes.obmd_ljrf_scene(nx=OLJ_SMALL[0], ny=OLJ_SMALL[1],
                                nbuf=1.05 * o.nbuf / o.alpha ** 2,
                                device="cpu")
    st = sc.state
    n = int(st.natoms)
    keep = np.random.default_rng(1).random(n) < RF_SMALL_KEEP
    x, v, t, q = (a[:n][keep].numpy() for a in (st.x, st.v, st.type, st.q))
    return sc.cfg, init_state(sc.cfg, x, v=v, types=t, q=q, device=dev)


@functools.lru_cache(maxsize=1)
def _small_chain_start():
    """The chain melt's small path start: chain_scene(nx=7) with 49-bead
    chains, warmed up on the card (CHAIN_SMALL_WARM steps), as arrays."""
    from obmd_tpu_torch import convert, scenes
    nx, chain_len = CHAIN_SMALL
    sc = scenes.chain_scene(nx=nx, chain_len=chain_len, device=DEV)
    warm = scenes.chain_warm_up(sc.cfg, sc.state, steps=CHAIN_SMALL_WARM)
    return sc.cfg, convert.to_arrays(warm)


def small_chain(dev):
    """The chain melt's small path: one warmed start, copied to `dev`."""
    from obmd_tpu_torch import convert
    cfg, arrays = _small_chain_start()
    return cfg, convert.from_arrays(arrays, device=dev)


def small_run(make, dev, unsteady=None, runner="run"):
    """One device's half of check_small_path: make(dev)'s scene with
    nattempt = 0 and SeededDraws, the arrays after setup and after each of
    SMALL_STEPS steps (with an "unsteady" column where unsteady is
    given)."""
    import dataclasses as dc

    from obmd_tpu_torch import convert
    from obmd_tpu_torch.integrate import make_run, make_step, setup
    cfg, state = make(dev)
    draws = None
    if cfg.obmd is not None:
        cfg = dc.replace(cfg, obmd=dc.replace(
            cfg.obmd, usher=dc.replace(cfg.obmd.usher, nattempt=0)))
        draws = SeededDraws(cfg, SMALL_SEED)
    st = setup(cfg, state, draw=draws)

    def arrays(st):
        d = convert.to_arrays(st)
        if unsteady is not None:
            d["unsteady"] = unsteady(cfg, st).cpu().numpy()
        return d
    out = [arrays(st)]
    run = (make_step(cfg, draw=draws) if runner == "step"
           else make_run(cfg, 1, draw=draws))
    for _ in range(SMALL_STEPS):
        st = run(st)
        out.append(arrays(st))
    return out


def check_small_path(label, make, require_insert, exact=SMALL_EXACT,
                     unsteady=None, setpoint_rtol=0.0, runner="run"):
    """The whole path at a small size on the card against the same path on
    the CPU (the plain versions), from one initial state and one stream of
    candidate draws, with nattempt = 0, so that no USHER verdict sits at
    the etarget gate, where float32 summation order decides it.  After
    setup and after one step, slots, tags, alive, the kernel caches and
    every counter are equal, x, v and the setpoints agree within 1e-4 and
    f within 2e-4 * max|f|; after SMALL_STEPS steps the counters and atom
    counts are equal and positions by tag agree within 5e-3 (the CPU
    tests' bars).  `make(device)` gives the scene's (cfg, state);
    require_insert: the first step must insert atoms; `exact` the columns
    held exactly; unsteady(cfg, state), where given, a bool [N] of the
    slots whose x, v and f are not held on that state, from either device
    (ill-conditioned impropers, where float32 rounding is amplified);
    setpoint_rtol, where given, adds that share of each boundary setpoint's
    magnitude to its 1e-4 (a molecule leaving whole puts its momentum over
    dt, thousands, into one float32 sum); runner "step" steps through
    make_step (the stage where step % nfreq == 0) instead of make_run(1)
    calls (each of which starts a stage group).  The CPU's run is the side
    process's under `label` where side_start queued one (the same make,
    unsteady and runner), else run here.  Returns the largest position
    difference by tag."""
    import numpy as np

    dev_run = small_run(make, DEV, unsteady, runner)
    cpu_run = side_take(label, (make, unsteady, runner))
    if cpu_run is None:
        cpu_run = small_run(make, "cpu", unsteady, runner)
    unheld = 0
    for i in (0, 1):
        got, want = dev_run[i], cpu_run[i]
        for k in exact:
            if not np.array_equal(got[k], want[k]):
                fail(f"{label} small path, state {i}: {k} differs from the "
                     "CPU's")
        held = np.ones(len(want["f"]), bool)
        if unsteady is not None:
            held = ~(got["unsteady"] | want["unsteady"])
            unheld = max(unheld, int((~held).sum()))

        def rows(a):
            return a[held] if a.ndim and len(a) == len(held) else a
        for k in SMALL_CLOSE:
            if k not in want:
                continue
            d = float(np.abs(rows(got[k]) - rows(want[k])).max())
            bar = 1e-4
            if k.endswith("_force_left") or k.endswith("_force_right"):
                bar += setpoint_rtol * float(np.abs(want[k]).max())
            if not d <= bar:
                fail(f"{label} small path, state {i}: {k} differs by {d}")
        fmax = float(np.abs(want["f"]).max())
        d = float(np.abs(rows(got["f"]) - rows(want["f"])).max())
        if not d <= 2e-4 * fmax:
            fail(f"{label} small path, state {i}: f differs by {d} (max|f| "
                 f"{fmax})")
    if require_insert and \
            int(cpu_run[1]["ninserted"]) <= int(cpu_run[0]["ninserted"]):
        fail(f"{label} small path: the first step inserted no atoms")
    got, want = dev_run[-1], cpu_run[-1]
    for k in ("ndeleted", "ninserted", "insert_fail", "usher_iters", "maxtag",
              "rebuilds", "overflow", "cell_overflow", "step"):
        if int(got[k]) != int(want[k]):
            fail(f"{label} small path after {SMALL_STEPS} steps: {k} "
                 f"{int(got[k])} != {int(want[k])}")

    def by_tag(d):
        keep = d["alive"]
        return dict(zip(d["tag"][keep].tolist(), d["x"][keep]))
    mg, mw = by_tag(got), by_tag(want)
    if set(mg) != set(mw):
        fail(f"{label} small path after {SMALL_STEPS} steps: the alive tags "
             "differ")
    err = max(float(np.abs(mg[t] - mw[t]).max()) for t in mw)
    if not err < 5e-3:
        fail(f"{label} small path after {SMALL_STEPS} steps: positions by tag "
             f"differ by {err}")
    log(f"{label} small path ({len(mw)} atoms, {int(want['ninserted'])} "
        f"inserted, {int(want['insert_fail'])} insertions failed, "
        f"{int(want['ndeleted'])} deleted): the card agrees with the CPU, "
        f"positions by tag within {err:.2e} after {SMALL_STEPS} steps"
        + (f"; x, v and f not held on at most {unheld} slots of "
           "ill-conditioned impropers" if unsteady is not None else ""))
    return err


def profile_steps(run, state, nsteps: int):
    """Where a main-path step's time goes: torch.profiler over `nsteps`
    steps.  Device busy time is the sum of the device intervals of every
    kernel and copy (one stream, so they do not overlap); the idle share is
    1 - busy / wall.  Returns None when the profiler sees no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        state = run(state)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device intervals straight from the profiler's raw results:
    # prof.events() would first build a FunctionEvent, and a tree, for each
    # of the ~10^5 host events of an insertion step, seconds a profile
    device = ((e.name(), e.duration_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not getattr(e, "is_hidden_event", lambda: False)())
    by_name = {}
    for name, us in device:
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + us)
    if not by_name:
        return None
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        steps=nsteps, wall_ms_per_step=wall_us / nsteps / 1e3,
        device_busy_ms_per_step=busy_us / nsteps / 1e3,
        idle_share=1.0 - busy_us / wall_us,
        device_ops_per_step=launches / nsteps,
        top=[dict(name=torch._C._demangle(name)[:90],
                  ms_per_step=us / nsteps / 1e3, calls_per_step=n / nsteps)
             for name, (n, us) in top])


def warm_profiler():
    """The process's first torch.profiler session, on one trivial step:
    the profiler's set-up (seconds) is paid while the kernels build."""
    import torch
    t0 = time.perf_counter()
    prof = profile_steps(lambda x: x * 2.0, torch.ones(1024, device=DEV), 1)
    log(f"the profiler's first session, beside the build: "
        f"{time.perf_counter() - t0:.1f} s ({prof and prof['steps']} step)")


def max_cell_count(geom, state) -> int:
    """The most alive atoms in one cell: what a fresh layout at this
    state must file (more than the filing cap is a cell overflow)."""
    import torch
    cell = geom.cell_of(state.x[state.alive]).long()
    return int(torch.bincount(cell, minlength=geom.n_cells).max())


def launch_counts():
    from obmd_tpu_torch import _build
    return {k.name: (k.launches, dict(k.launches_by_shape))
            for k in _build.KERNELS.values()}


def require_launches(launches, want, path):
    """want: {kernel name: the launch shapes it must show, or None for
    any}.  Each kernel of `want` was launched on this path, with exactly
    those shapes; no other kernel was."""
    for name, (n, by) in launches.items():
        if name not in want:
            if n:
                fail(f"{path}: kernel {name} launched {by}, expected none")
            continue
        shapes = want[name]
        if n <= 0 or (shapes is not None and set(by) != set(shapes)):
            fail(f"{path}: kernel {name} launched {by}, expected "
                 f"{shapes or 'some'}")


def thermo_line(t):
    n = int(t.natoms)
    return dict(step=t.step, etot_per_atom=(float(t.pe) + float(t.ke)) / n,
                epair_per_atom=float(t.epair) / n, temp=float(t.temp),
                press=float(t.pressure))


def log_thermo(marks, label):
    for m in marks:
        log(f"{label} thermo: step {m['step']} E_tot/N "
            f"{m['etot_per_atom']:.6f} E_pair/N {m['epair_per_atom']:.6f} "
            f"temp {m['temp']:.5f} press {m['press']:.5f}")


def energy_drift(marks, label):
    """|dE_tot|/N between the first and last thermo line, at most 1e-2."""
    drift = abs(marks[-1]["etot_per_atom"] - marks[0]["etot_per_atom"])
    log_thermo(marks, label)
    if not drift <= 1e-2:
        fail(f"{label}: |dE_tot|/N {drift} > 1e-2 over "
             f"{marks[-1]['step'] - marks[0]['step']} steps")
    return drift


def check_finite(state, label):
    import torch
    if not (bool(torch.isfinite(state.x[state.alive]).all())
            and bool(torch.isfinite(state.v[state.alive]).all())):
        fail(f"{label}: non-finite positions or velocities")


def run_full_path(cfg, state, label):
    """FULL_STEPS steps through the full-stencil kernel from `state`, with
    the launch counts zeroed before and read after.  Returns (end state,
    ms/step, launches)."""
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.observe import check_invariants
    run = make_run(cfg, FULL_STEPS, kernel="full")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = run(state)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    tel = check_invariants(cfg, state)
    check_finite(state, label)
    log(f"{label} through the full-stencil kernel: {FULL_STEPS} steps "
        f"{wall:.3f} s, telemetry {tel}, launches {launches}")
    return state, wall / FULL_STEPS * 1e3, launches


def window_temps(cfg, geom, label):
    """A probe for bench_torch.production: the most atoms in one cell (with
    no cellpad geometry, the longest Verlet row), the kinetic T and the
    thermal T with each T_BIN-wide x bin's mean velocity taken out
    (profile_temperature)."""
    from obmd_tpu_torch.observe import profile_temperature
    from obmd_tpu_torch.state import temperature
    nbins = round(cfg.box.lengths[0] / T_BIN)

    def probe(state):
        t, t_thermal = (float(temperature(cfg, state)),
                        float(profile_temperature(cfg, state, nbins)))
        log(f"{label}: step {state.step} T {t:.5f}, T without the mean "
            f"flow of {nbins} x bins {t_thermal:.5f}")
        fill = (max_cell_count(geom, state) if geom is not None
                else int(state.nbrs.ncount.max()))
        return fill, t, t_thermal
    return probe


def check_thermal(probes, label):
    """The thermal T (window_temps) relaxes to the thermostat's 1.0: over
    the last three marks, NSTEPS apart, it moves toward one value with
    shrinking steps, and that value (Aitken's extrapolation) is within 5%
    of 1.0.  It relaxes, and is not yet 1.0 at the window ends, because
    equilibrate's rescale set the kinetic T to 1 with a flow along x in
    it: the long box keeps the flow that the random start set going, the
    Galilean-invariant DPD thermostat leaves it be, and the rescale cooled
    the heat by the flow's share.  Returns the extrapolated T."""
    t1, t2, t3 = (p[2] for p in probes[-3:])
    d2, d3 = t2 - t1, t3 - t2
    if not (d2 != 0.0 and 0.0 < d3 / d2 < 1.0):
        fail(f"{label}: the thermal T at the last three marks {t1}, {t2}, "
             f"{t3} does not relax to one value")
    t_inf = t3 + d3 * d3 / (d2 - d3)
    log(f"{label}: the thermal T relaxes to {t_inf:.5f} (Aitken, from "
        f"{t1:.5f}, {t2:.5f}, {t3:.5f})")
    if not abs(t_inf - 1.0) <= 0.05:
        fail(f"{label}: the thermal T relaxes to {t_inf}, not within 5% of "
             f"the thermostat's 1.0")
    return t_inf


def run_obmd():
    """Phases 3-6: the OBMD_DPD main path and its kernel checks."""
    from bench_torch import (PROD_CAP, SCALE, SEED, equilibrated,
                             production, repack)
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn

    # ---- phase 3: the whole path at a small size against the CPU, then the
    # kernels against their plain versions at bench shapes (cap 24)
    with KeepCounts():
        small_err = check_small_path("OBMD_DPD", small_dpd,
                                     require_insert=True)
    sc = scenes.obmd_dpd_scene(scale=SCALE, seed=SEED, device=DEV)
    geom24 = make_geometry(sc.cfg)
    st = setup(sc.cfg, sc.state)
    sync()
    pair24, _ = check_pair(sc.cfg, geom24, st, "dpd cap 24")
    usher, _ = check_usher(sc.cfg, geom24, st, "dpd")
    del sc, st

    # ---- phase 4: the main path, then the insertion phase
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    cfg, st_eq = equilibrated(DEV)      # st_eq: path A's start (phase 19)
    sync()
    eq_s = time.perf_counter() - t_path
    cfg15, geom15, st = repack(cfg, st_eq, PROD_CAP)
    probe = window_temps(cfg15, geom15, "OBMD_DPD main path")
    probes = [probe(st)]
    st, windows, more = production(cfg15, st, probe)
    probes += more
    occupancy = [p[0] for p in probes]
    temps = [p[1:] for p in probes]
    t_relax = check_thermal(probes, "OBMD_DPD main path")
    tel = check_invariants(cfg15, st)
    natoms = int(st.natoms)
    st15 = st

    m = make_obmd_metrics_fn(cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    _, _, st = repack(cfg_ins, st, cfg.capacity.cell_capacity)
    ins0 = int(st.obmd.ninserted)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    if inserted <= 0:
        fail("insertion phase inserted no atoms")
    check_finite(st, "OBMD_DPD main path")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"main path {path_s:.1f} s (setup and equilibrate {eq_s:.1f} s), "
        f"telemetry {tel}, most atoms in one cell at the repack and after "
        f"each "
        f"production window {occupancy} (filing cap {PROD_CAP}); insertion "
        f"phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted in "
        f"{INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; launches {launches}")
    require_launches(launches, {"pair": ("dpd-cap15", "dpd-cap24"),
                                "usher_search": None}, "OBMD_DPD main path")

    # ---- phase 5: both pair kernels at cap 15 on the repacked state, and a
    # profile of two relayout epochs of the main path's runner
    pair15, full15 = check_both(cfg15, geom15, st15, "dpd cap 15")
    r_every = auto_rebuild_every(cfg15)
    prof = profile_steps(make_run(cfg15, 2 * r_every), st15, 2 * r_every)
    log(f"profile: {prof}")

    # ---- phase 6: the main path's production through the full kernel
    _, full_ms, full_launches = run_full_path(cfg15, st15, "OBMD_DPD")
    require_launches(full_launches, {"dpd_full": ("dpd-cap15",)},
                     "OBMD_DPD through the full-stencil kernel")

    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], equilibrate_s=eq_s,
                main_path_s=path_s, max_cell_count_cap15=max(occupancy),
                insertion_phase_inserted=inserted,
                small_path_max_pos_err=small_err, profile=prof,
                full_kernel_ms_per_step=full_ms,
                kinetic_thermal_temps=temps, thermal_temp_limit=t_relax)
    by = launches["pair"][1]
    kernels = [
        kernel_line("pair", "dpd, fill cap 15",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    by["dpd-cap15"], pair15),
        kernel_line("pair", "dpd, fill cap 24",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    by["dpd-cap24"], pair24),
        kernel_line("usher_search", "dpd", None,
                    launches["usher_search"][0], usher),
        kernel_line("dpd_full", "dpd, fill cap 15", None,
                    full_launches["dpd_full"][0], full15),
    ]
    return path, kernels, (cfg, st_eq, [t for t, _ in temps[-2:]])


def kernel_line(name, config, replaces, launches, figures):
    from obmd_tpu_torch import _build
    k = _build.KERNELS[name]
    return dict(name=f"{name} ({config})", route="cuda",
                source=f"obmd_tpu_torch/csrc/{k.source}",
                replaces=replaces or k.replaces, launches=launches,
                x_bound=figures["ms"] / figures["bound_ms"], **figures)


def run_lj():
    """Phases 7-9: the LJ melt path, its run through the full-stencil
    kernel, and the LJ kernel checks."""
    import torch
    import bench_lj_torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_thermo_fn

    # ---- phase 7: the LJ melt path, through bench_lj_torch.py's steps
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    cfg, st = bench_lj_torch.scene(device=DEV)
    geom = make_geometry(cfg)
    thermo = make_thermo_fn(cfg)
    st, windows, marks = bench_lj_torch.production(
        cfg, st, probe=lambda s: thermo_line(thermo(s)))
    tel = check_invariants(cfg, st)
    check_finite(st, "LJ melt path")
    natoms = int(st.natoms)
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"LJ melt path (nx {bench_lj_torch.NX}, {natoms} atoms, {geom}) "
        f"{path_s:.1f} s, "
        f"windows {windows}, telemetry {tel}, launches {launches}")
    require_launches(launches, {"pair": ("lj-cap36",)}, "LJ melt path")
    drift = energy_drift(marks, "LJ melt")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st, 2 * r_every)
    log(f"LJ profile: {prof}")

    # ---- phase 8: the LJ path through the full-stencil kernel
    st_full, full_ms, full_launches = run_full_path(cfg, st, "LJ melt")
    require_launches(full_launches, {"dpd_full": ("lj-cap36",)},
                     "LJ melt through the full-stencil kernel")
    full_drift = energy_drift([marks[-1], thermo_line(thermo(st_full))],
                              "LJ melt, full-stencil kernel")

    # ---- phase 9: the ended state against the sweep, both kernels against
    # their plain versions and each other, then 512 lanes at nx = 40
    f_path = st.f.reshape(geom.n_blocks, geom.cap, geom.lanes, 3) \
        .permute(0, 3, 1, 2)
    sweep_err, sweep_scale = against_sweep(cfg, geom, st, f_path,
                                           "LJ path forces")
    pair36, full36 = check_both(cfg, geom, st, "lj cap 36")

    wide = scenes.lj_melt_scene(nx=LJ_WIDE_NX, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(LJ_WIDE_NX)
    x = wide.state.x + 0.05 * torch.randn(wide.state.x.shape, generator=gen,
                                          device=DEV)
    wgeom = make_geometry(wide.cfg)
    with KeepCounts():
        wst = setup(wide.cfg, wide.state.replace(x=wide.cfg.box.wrap(x)))
    pair_wide, _ = check_pair(wide.cfg, wgeom, wst,
                              f"lj cap 36, {wgeom.lanes} lanes")
    del wst

    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                steps_per_s=steps / wall,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], path_s=path_s,
                thermo=marks, etot_drift_per_atom=drift,
                full_kernel_ms_per_step=full_ms,
                full_kernel_etot_drift_per_atom=full_drift,
                forces_vs_sweep_max_abs_err=sweep_err,
                forces_vs_sweep_max_f=sweep_scale,
                wide_check=dict(nx=LJ_WIDE_NX, lanes=wgeom.lanes,
                                slots=wgeom.n_slots, **pair_wide),
                telemetry=tel, profile=prof)
    kernels = [
        kernel_line("pair", "lj, cap 36, periodic x, p == 1",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1]["lj-cap36"], pair36),
        kernel_line("dpd_full", "lj, cap 36, periodic x, p == 1", None,
                    full_launches["dpd_full"][0], full36),
    ]
    return path, kernels


def run_obmd_lj():
    """Phases 10-12: the open LJ fluid's small path against the CPU, its
    main path with an insertion phase and its kernel checks."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import (check_invariants, make_obmd_metrics_fn,
                                        make_thermo_fn)

    # ---- phase 10: the path at a small size against the CPU
    with KeepCounts():
        small_err = check_small_path("open LJ", small_obmd_lj,
                                     require_insert=False)

    # ---- phase 11: the main path, then the insertion phase
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.obmd_lj_scene(nx=OLJ_NX, ny=OLJ_NY, device=DEV)
    cfg = sc.cfg
    geom = make_geometry(cfg)
    thermo = make_thermo_fn(cfg)
    metrics = make_obmd_metrics_fn(cfg)
    st = setup(cfg, sc.state)
    t_eq = time.perf_counter()
    st = equilibrate(cfg, st, OLJ_EQUIL, temp=1.44)
    sync()
    eq_s = time.perf_counter() - t_eq
    occupancy = [max_cell_count(geom, st)]
    run = make_run(cfg, OLJ_STEPS)
    st = run(st)
    sync()
    occupancy.append(max_cell_count(geom, st))
    marks = [thermo_line(thermo(st))]
    windows = []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        marks.append(thermo_line(thermo(st)))
    tel = check_invariants(cfg, st)
    check_finite(st, "open LJ main path")
    natoms = int(st.natoms)
    st_prod = st
    log_thermo(marks, "open LJ")
    t_want = cfg.langevin.temp
    for m in marks[1:]:
        if not abs(m["temp"] - t_want) <= 0.05 * t_want:
            fail(f"open LJ: T {m['temp']} at step {m['step']} is not within "
                 f"5% of {t_want}")
    m = metrics(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    deleted = int(st.obmd.ndeleted)
    log(f"open LJ: buffer censuses {int(m.nbuf_left)} and "
        f"{int(m.nbuf_right)} (alpha * nbuf = "
        f"{cfg.obmd.alpha * cfg.obmd.nbuf:.1f}), {deleted} deleted, "
        f"{int(st.obmd.ninserted)} inserted, {natoms} atoms")

    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    ins0 = int(st.obmd.ninserted)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    if inserted <= 0:
        fail("open LJ insertion phase inserted no atoms")
    check_finite(st, "open LJ insertion phase")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    # equilibrate runs whole velocity-rescale periods of 25 steps
    n_steps = OLJ_EQUIL // 25 * 25 + 3 * OLJ_STEPS + INS_STEPS
    log(f"open LJ main path (lattice {OLJ_NX} x {OLJ_NY} x {OLJ_NY}, {geom}) "
        f"{path_s:.1f} s (equilibrate {eq_s:.1f} s), windows {windows}, "
        f"telemetry {tel}, most atoms in one cell after equilibration and "
        f"after each production window {occupancy} (filing cap {geom.fcap}); "
        f"insertion phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted "
        f"in {INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; launches "
        f"{launches}")
    require_launches(launches, {"pair": (f"lj-cap{geom.fcap}",),
                                "usher_search_lj": None}, "open LJ main path")
    if launches["pair"][0] != n_steps + 1:
        fail(f"open LJ: {launches['pair'][0]} pair kernel launches for "
             f"setup and {n_steps} steps")
    if not INS_STEPS <= launches["usher_search_lj"][0] <= n_steps + 1:
        fail(f"open LJ: {launches['usher_search_lj'][0]} USHER launches, "
             f"expected one for each of the {INS_STEPS} insertion steps and "
             "at most one per step")

    # ---- phase 12: the kernels on the ended production state, a profile
    # of two relayout epochs, then FULL_STEPS steps through the full kernel
    usher, usher_info = check_usher(cfg, geom, st_prod, "lj")
    usher64, usher64_info = check_usher_f64(
        cfg, *map(widened, buffer_subsets(cfg, geom, st_prod)), "lj")
    pair, full = check_both(cfg, geom, st_prod, f"lj cap {geom.fcap}, open x")
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    with KeepCounts():
        f_k = _make_kernel(cfg, geom)(*pack_fields(cfg, geom, st_prod))
    sweep_err, sweep_scale = against_sweep(cfg, geom, st_prod, f_k,
                                           "open LJ pair kernel")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st_prod, 2 * r_every)
    log(f"open LJ profile: {prof}")
    _, full_ms, full_launches = run_full_path(cfg, st_prod, "open LJ")
    require_launches(full_launches, {"dpd_full": (f"lj-cap{geom.fcap}",)},
                     "open LJ through the full-stencil kernel")

    wall, steps = min(windows)
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], equilibrate_s=eq_s,
                path_s=path_s, thermo=marks, telemetry=tel,
                buffer_census=[int(m.nbuf_left), int(m.nbuf_right)],
                deleted=deleted, max_cell_count=max(occupancy),
                filing_cap=geom.fcap, insertion_phase_inserted=inserted,
                small_path_max_pos_err=small_err, usher=usher_info,
                forces_vs_sweep_max_abs_err=sweep_err,
                forces_vs_sweep_max_f=sweep_scale, profile=prof,
                full_kernel_ms_per_step=full_ms, usher_f64=usher64_info)
    config = f"lj, cap {geom.fcap}, open x, p = {geom.p}"
    kernels = [
        kernel_line("pair", config, "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1][f"lj-cap{geom.fcap}"], pair),
        kernel_line("usher_search_lj", "lj", None,
                    launches["usher_search_lj"][0], usher),
        kernel_line("usher_search_lj_f64", "lj rows on the open LJ fluid's "
                    "subsets widened to float64, kernel-only", None, 0,
                    usher64),
        kernel_line("dpd_full", config, None, full_launches["dpd_full"][0],
                    full),
    ]
    return path, kernels, (cfg, st_prod)


def bond_pair_slots(cfg, geom, state):
    """[nb, cap, lanes] bool: the alive slots with a bond partner inside the
    pair cut (minimum image), i.e. a 1-2 pair the exclusion drops."""
    import torch
    n = state.capacity
    near = torch.zeros_like(state.alive)
    cut2 = cfg.pair.max_cut ** 2
    for partner in state.bond_partners:
        j = torch.clamp(partner.long(), 0, n - 1)
        d = cfg.box.min_image(state.x - state.x[j])
        near |= state.alive & (partner >= 0) & ((d * d).sum(-1) < cut2)
    return near.reshape(geom.n_blocks, geom.cap, geom.lanes)


def check_exclusion(cfg, geom, state, kernel, label="chain"):
    """A kernel ("pair" or "full") with pbond (2 or 4 partner channels)
    against the same kernel without it: they differ on exactly the slots
    that have a 1-2 pair inside the cut.  Returns that slot count."""
    import torch
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    fld, tag, salt, occ, pbond = pack_fields(cfg, geom, state)
    bare = dataclasses.replace(cfg, bond=None)
    with KeepCounts():
        f_ex = _make_kernel(cfg, geom, kernel)(fld, tag, salt, occ, pbond)
        f_all = _make_kernel(bare, geom, kernel)(fld, tag, salt, occ)
        sync()
    differs = (f_ex != f_all).any(dim=1)
    near = bond_pair_slots(cfg, geom, state)
    n_near = int(near.sum())
    if n_near <= 0:
        fail(f"{label} {kernel} kernel: no 1-2 pair inside the cut")
    if not torch.equal(differs, near):
        fail(f"{label} {kernel} kernel: exclusion changed "
             f"{int(differs.sum())} slots, {n_near} have a 1-2 pair inside "
             f"the cut, {int((differs != near).sum())} disagree")
    log(f"{label} {kernel} kernel: exclusion over {pbond.shape[1]} partner "
        f"channels changes exactly the {n_near} slots with a 1-2 pair "
        "inside the cut")
    return n_near


def chain_marks(cfg, thermo, state, marks, label):
    """Thermo through the pair sweep and the bond figures at a window end;
    no bond may sit at or beyond r0 (FENE clamps it without an error)."""
    from obmd_tpu_torch.observe import bond_stats
    t = thermo(state)
    m = thermo_line(t)
    n = int(t.natoms)
    longest, over, count = bond_stats(cfg, state)
    m.update(ebond_per_atom=float(t.ebond) / n, longest_bond=longest,
             bonds_at_or_beyond_r0=over, bonds=count)
    if over:
        fail(f"{label}: {over} bonds at or beyond r0 = {cfg.bond.r0} at step "
             f"{state.step} (longest {longest})")
    marks.append(m)
    return m


def run_chain():
    """Phases 13-15: the chain melt's small path against the CPU, its main
    path, the kernels with exclusion, and the full-stencil run."""
    import bench_chain_torch
    from bench_torch import NSTEPS
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import (bond_stats, check_invariants,
                                        make_thermo_fn)
    from obmd_tpu_torch.state import temperature

    # ---- phase 13: the path at a small size against the CPU
    with KeepCounts():
        small_err = check_small_path("chain", small_chain,
                                     require_insert=False)

    # ---- phase 14: the main path, through bench_chain_torch.py's steps
    # (the generated start and its warm-up, then setup and production)
    t_path = time.perf_counter()
    _build.reset_launch_counts()
    t_warm = time.perf_counter()
    cfg, st = bench_chain_torch.start(device=DEV)
    sync()
    warm_s = time.perf_counter() - t_warm
    n_bonds = bond_stats(cfg, st)[2]
    wcfg = scenes.chain_warm_up_config(cfg)
    wgeom = make_geometry(wcfg)
    wkey = f"lj-excl2-cap{wgeom.fcap}"
    warm_launches = launch_counts()
    require_launches(warm_launches, {"pair": (wkey,)}, "chain warm-up")
    warm_t = float(temperature(cfg, st))
    warm_longest, warm_over, _ = bond_stats(cfg, st)
    warm_tel = check_invariants(wcfg, st)
    if warm_over or not abs(warm_t - 1.0) <= 0.1:
        fail(f"chain warm-up: T {warm_t}, {warm_over} bonds at or beyond r0")
    log(f"chain warm-up: {scenes.WARM_STEPS} steps at dt {scenes.WARM_DT}, "
        f"cap {scenes.WARM_CAP}, {warm_s:.2f} s; T {warm_t:.4f}, longest "
        f"bond {warm_longest:.4f}, telemetry {warm_tel}, launches "
        f"{warm_launches}")
    # the warm-up's pair kernel (its own filing cap) on the warmed state,
    # in the warm-up's layout, against its plain version
    warm_pair, _ = check_pair(wcfg, wgeom, st,
                              f"lj, exclusion, cap {wgeom.fcap}, warm-up")
    check_exclusion(wcfg, wgeom, st, "pair")
    _build.reset_launch_counts()
    geom = make_geometry(cfg)
    thermo = make_thermo_fn(cfg)
    st = setup(cfg, st)
    occupancy = [max_cell_count(geom, st)]
    marks = []

    def probe(state):
        occupancy.append(max_cell_count(geom, state))
        chain_marks(cfg, thermo, state, marks, "chain main path")
    st, windows, _ = bench_chain_torch.production(cfg, st, probe)
    launches = launch_counts()
    tel = check_invariants(cfg, st)
    check_finite(st, "chain main path")
    natoms = int(st.natoms)
    path_s = time.perf_counter() - t_path
    log_thermo(marks, "chain")
    for m in marks[1:]:
        if not abs(m["temp"] - 1.0) <= 0.05:
            fail(f"chain: T {m['temp']} at step {m['step']} is not within 5% "
                 "of 1.0")
    wall, steps = min(windows)
    log(f"chain main path ({natoms} beads, {n_bonds} bonds, {geom}) "
        f"{path_s:.1f} s (warm-up {warm_s:.1f} s), windows {windows}, "
        f"telemetry {tel}, most atoms in one cell at setup and after each "
        f"window {occupancy} (filing cap {geom.fcap}), longest bond "
        f"{max(m['longest_bond'] for m in marks):.4f}, E_bond/N "
        f"{marks[-1]['ebond_per_atom']:.4f}, {steps / wall:.1f} steps/s, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s; launches "
        f"{launches} (warm-up: {wkey} x {warm_launches['pair'][1][wkey]})")
    key = f"lj-excl2-cap{geom.fcap}"
    require_launches(launches, {"pair": (key,)}, "chain main path")
    if launches["pair"][0] != 3 * NSTEPS + 1:
        fail(f"chain: {launches['pair'][0]} pair kernel launches for setup "
             f"and {3 * NSTEPS} steps")

    # ---- phase 15: both kernels with exclusion on the ended state, the
    # exclusion's reach, a profile of two epochs, the full-stencil run
    pair, full = check_both(cfg, geom, st, f"lj, exclusion, cap {geom.fcap}")
    near = {k: check_exclusion(cfg, geom, st, k) for k in ("pair", "full")}
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st, 2 * r_every)
    log(f"chain profile: {prof}")
    st_full, full_ms, full_launches = run_full_path(cfg, st, "chain")
    require_launches(full_launches, {"dpd_full": (key,)},
                     "chain through the full-stencil kernel")
    full_marks = []
    chain_marks(cfg, thermo, st_full, full_marks,
                "chain, full-stencil kernel")

    path = dict(atoms=natoms, bonds=n_bonds, ms_per_step=wall / steps * 1e3,
                steps_per_s=steps / wall,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], warm_up_s=warm_s,
                warm_up_temp=warm_t,
                warm_up_launches={wkey: warm_launches["pair"][1][wkey]},
                path_s=path_s, thermo=marks,
                telemetry=tel, max_cell_count=max(occupancy),
                filing_cap=geom.fcap, slots_with_1_2_pair_in_cut=near["pair"],
                small_path_max_pos_err=small_err, profile=prof,
                full_kernel_ms_per_step=full_ms,
                full_kernel_thermo=full_marks[0])
    config = f"lj, 2-channel exclusion, cap {geom.fcap}, p = {geom.p}"
    kernels = [
        kernel_line("pair", config, "obmd_tpu/forces/pallas_dpd.py:575",
                    launches["pair"][1][key], pair),
        kernel_line("pair", f"lj, 2-channel exclusion, cap {wgeom.fcap}, "
                    f"p = {wgeom.p}, warm-up",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    warm_launches["pair"][1][wkey], warm_pair),
        kernel_line("dpd_full", config, None, full_launches["dpd_full"][0],
                    full),
    ]
    return path, kernels


def charge_marks(cfg, thermo, state, marks):
    """Thermo through the pair sweep (E_pair with the reaction field), the
    net charge and the ion count at one mark."""
    from obmd_tpu_torch.observe import charge_census
    m = thermo_line(thermo(state))
    net, ions = charge_census(state)
    m.update(net_charge=net, ions=ions, natoms=int(state.natoms))
    marks.append(m)
    log(f"open charged fluid: step {m['step']} T {m['temp']:.5f} E_pair/N "
        f"{m['epair_per_atom']:.6f} press {m['press']:.5f} net charge "
        f"{net:g} ions {ions} atoms {m['natoms']}")
    return m


def check_golden():
    """The fork's LAMMPS forces on validation/ljrf_golden (220 charged
    atoms in a periodic 9^3 box, lj/cut/rf 2.2 2.2, eps 0.8, sigma 1,
    eps_rf 80) through setup on the card: every force within 5e-5 *
    max|f| of dump.ref (validation/run_ljrf_golden.py's bar).  Returns the
    max error and max|f|."""
    import numpy as np
    from obmd_tpu_torch import config
    from obmd_tpu_torch.integrate import setup
    from obmd_tpu_torch.io.lammps_data import read_data
    from obmd_tpu_torch.state import init_state
    df = read_data(os.path.join(GOLDEN_DIR, "charged.data"),
                   atom_style="charge")
    ref = {}
    with open(os.path.join(GOLDEN_DIR, "dump.ref")) as fh:
        lines = fh.read().splitlines()
    for line in lines[lines.index("ITEM: ATOMS id fx fy fz") + 1:]:
        t = line.split()
        ref[int(t[0])] = np.asarray([float(v) for v in t[1:4]])
    pair = config.LJCutRFParams.create(cut_lj=2.2, cut_coul=2.2,
                                       epsilon=0.8, sigma=1.0, eps_rf=80.0)
    cfg = config.SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=pair, dt=0.002,
        capacity=config.Capacity(n_max=df.natoms, cell_capacity=48),
        skin=0.3)
    with KeepCounts():
        st = setup(cfg, init_state(cfg, df.x, types=df.types, tags=df.tags,
                                   q=df.q, device=DEV))
        sync()
    f = st.f.cpu().numpy()
    got = {int(t): f[i] for i, t in enumerate(st.tag.tolist())
           if bool(st.alive[i])}
    if set(got) != set(ref):
        fail("ljrf golden: the atom ids differ from dump.ref")
    scale = max(float(np.linalg.norm(v)) for v in ref.values())
    err = max(float(np.abs(got[t] - ref[t]).max()) for t in ref)
    if not err <= 5e-5 * scale:
        fail(f"ljrf golden: max force error {err} > 5e-5 * {scale}")
    log(f"ljrf golden ({len(ref)} atoms): the pair kernel on the card "
        f"against the fork's LAMMPS forces, max error {err:.3e} (max|f| "
        f"{scale:.1f}, bar {5e-5 * scale:.3e})")
    return dict(max_abs_err=err, max_f=scale)


def kernel_only_checks(cfg, state):
    """The typed pair kernel's other configurations against their plain
    versions: ljrf at fill cap RF_CAP_SMALL (the ended state thinned to
    RF_CAP_SMALL_KEEP, relaid out), two-type DPD on the OBMD_DPD box at
    scale 1 (a uniform gas) and four-type lj with per-pair cutoffs on the
    nx = 20 LJ melt lattice (0.05 normal jitter)."""
    import numpy as np
    import torch
    from bench_lj_torch import NX as LJ_NX
    from bench_torch import SEED, repack
    from obmd_tpu_torch import config, scenes
    from obmd_tpu_torch.cellpad import layout_build
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.state import init_state
    out = {}
    g = torch.Generator(device=DEV)
    g.manual_seed(RF_CAP_SMALL)
    keep = state.alive & (torch.rand(state.alive.shape, generator=g,
                                     device=DEV) < RF_CAP_SMALL_KEEP)
    cfg20, geom20, st20 = repack(cfg, state.replace(alive=keep), RF_CAP_SMALL)
    if int(st20.cell_overflow) != int(state.cell_overflow):
        fail(f"ljrf cap {RF_CAP_SMALL}: the thinned state overflows a cell")
    out["ljrf_cap20"], _ = check_pair(cfg20, geom20, st20,
                                      f"ljrf, 2 types, cap {geom20.fcap}")

    r = np.random.default_rng(5)
    sc = scenes.obmd_dpd_scene(scale=1.0, seed=SEED, device="cpu")
    pair = config.DPDParams.create(
        temp=1.0, cutoff=1.0, seed=5, ntypes=2,
        a0=[[209.6, 150.0], [150.0, 180.0]], gamma=[[4.5, 2.0], [2.0, 6.0]])
    dcfg = dataclasses.replace(sc.cfg, pair=pair, masses=(1.0, 2.0))
    n = int(sc.state.natoms)
    dst = init_state(dcfg, sc.state.x[:n].numpy(), v=sc.state.v[:n].numpy(),
                     types=r.integers(0, 2, n), device=DEV)
    dgeom = make_geometry(dcfg)
    dst = layout_build(dgeom, dcfg.box, dst)
    if int(dst.cell_overflow):
        fail("two-type DPD: cell overflow")
    out["dpd_t2"], _ = check_pair(dcfg, dgeom, dst,
                                  f"dpd, 2 types, cap {dgeom.fcap}")

    sc = scenes.lj_melt_scene(nx=LJ_NX, device="cpu")
    eps = np.array([[1.0, 0.8, 0.9, 1.1], [0.8, 0.6, 0.7, 0.9],
                    [0.9, 0.7, 1.2, 1.0], [1.1, 0.9, 1.0, 0.5]])
    sig = np.array([[1.0, 0.95, 1.05, 0.9], [0.95, 0.9, 1.0, 0.92],
                    [1.05, 1.0, 1.1, 0.97], [0.9, 0.92, 0.97, 0.85]])
    cut = np.where(np.add.outer(np.arange(4), np.arange(4)) % 2, 2.2, 2.5)
    pair = config.LJCutParams.create(cutoff=2.5, epsilon=eps, sigma=sig,
                                     cut=cut, ntypes=4)
    lcfg = dataclasses.replace(sc.cfg, pair=pair, masses=(1.0, 1.2, 0.8, 2.0))
    x = sc.state.x.numpy() + 0.05 * r.normal(size=sc.state.x.shape)
    lst = init_state(lcfg, lcfg.box.wrap(torch.from_numpy(x)).numpy(),
                     v=sc.state.v.numpy(), types=r.integers(0, 4, len(x)),
                     device=DEV)
    lgeom = make_geometry(lcfg)
    lst = layout_build(lgeom, lcfg.box, lst)
    if int(lst.cell_overflow):
        fail("four-type lj: cell overflow")
    out["lj_t4"], _ = check_pair(lcfg, lgeom, lst,
                                 f"lj, 4 types, cap {lgeom.fcap}")
    return out


def run_ljrf():
    """Phases 16-18: the open charged two-type fluid's small path against
    the CPU, its main path with an insertion phase, and its kernel checks."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import (charge_census, check_invariants,
                                        make_obmd_metrics_fn, make_thermo_fn)

    # ---- phase 16: the path at a small size against the CPU
    with KeepCounts():
        small_err = check_small_path("open charged", small_ljrf,
                                     require_insert=True)

    # ---- phase 17: the main path, then the insertion phase
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.obmd_ljrf_scene(nx=OLJ_NX, ny=OLJ_NY, device=DEV)
    cfg = sc.cfg
    net0, ions0 = charge_census(sc.state)
    if net0 != 0.0 or ions0 <= 0:
        fail(f"open charged fluid: start with net charge {net0}, {ions0} ions")
    geom = make_geometry(cfg)
    thermo = make_thermo_fn(cfg)
    metrics = make_obmd_metrics_fn(cfg)
    st = setup(cfg, sc.state)
    t_eq = time.perf_counter()
    st = equilibrate(cfg, st, OLJ_EQUIL, temp=1.44)
    sync()
    eq_s = time.perf_counter() - t_eq
    occupancy = [max_cell_count(geom, st)]
    run = make_run(cfg, OLJ_STEPS)
    st = run(st)
    sync()
    occupancy.append(max_cell_count(geom, st))
    marks = []
    charge_marks(cfg, thermo, st, marks)
    windows = []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        charge_marks(cfg, thermo, st, marks)
    tel = check_invariants(cfg, st)
    check_finite(st, "open charged main path")
    natoms = int(st.natoms)
    st_prod = st
    t_want = cfg.langevin.temp
    for m in marks[1:]:
        if not abs(m["temp"] - t_want) <= 0.05 * t_want:
            fail(f"open charged fluid: T {m['temp']} at step {m['step']} is "
                 f"not within 5% of {t_want}")
    m = metrics(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    deleted = int(st.obmd.ndeleted)
    log(f"open charged fluid: buffer censuses {int(m.nbuf_left)} and "
        f"{int(m.nbuf_right)} (alpha * nbuf = "
        f"{cfg.obmd.alpha * cfg.obmd.nbuf:.1f}), {deleted} deleted, "
        f"{int(st.obmd.ninserted)} inserted, {natoms} atoms")

    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    ins0, tag0 = int(st.obmd.ninserted), int(st.maxtag)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    if inserted <= 0:
        fail("open charged insertion phase inserted no atoms")
    new = st.alive & (st.tag > tag0)
    if bool((st.type[new] != 0).any()) or bool((st.q[new] != 0.0).any()):
        fail("open charged insertion phase: an inserted atom is not neutral "
             "type-0 solvent")
    check_finite(st, "open charged insertion phase")
    charge_marks(cfg, thermo, st, marks)
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    n_steps = OLJ_EQUIL // 25 * 25 + 3 * OLJ_STEPS + INS_STEPS
    key = f"ljrf-t2-cap{geom.fcap}"
    wall, steps = min(windows)
    log(f"open charged main path (lattice {OLJ_NX} x {OLJ_NY} x {OLJ_NY}, "
        f"{geom}) {path_s:.1f} s (equilibrate {eq_s:.1f} s), windows "
        f"{windows}, {wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, telemetry "
        f"{tel}, most atoms in one cell after equilibration and after each "
        f"production window {occupancy} (filing cap {geom.fcap}); insertion "
        f"phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted in "
        f"{INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; launches {launches}")
    require_launches(launches, {"pair": (key,), "usher_search_ljrf": None},
                     "open charged main path")
    if launches["pair"][0] != n_steps + 1:
        fail(f"open charged fluid: {launches['pair'][0]} pair kernel launches "
             f"for setup and {n_steps} steps")
    if not INS_STEPS <= launches["usher_search_ljrf"][0] <= n_steps + 1:
        fail(f"open charged fluid: {launches['usher_search_ljrf'][0]} USHER "
             f"launches, expected one for each of the {INS_STEPS} insertion "
             "steps and at most one per step")
    try:
        make_run(cfg, 1, kernel="full")
        fail("open charged fluid: the full-stencil kernel took two types")
    except NotImplementedError:
        pass

    # ---- phase 18: the kernels on the ended production state, a profile,
    # the kernel-only configurations and the LAMMPS golden
    usher, usher_info = check_usher(cfg, geom, st_prod, "ljrf")
    usher64, usher64_info = check_usher_f64(
        cfg, *map(widened, buffer_subsets(cfg, geom, st_prod)), "ljrf")
    pair, _ = check_pair(cfg, geom, st_prod,
                         f"ljrf, 2 types, cap {geom.fcap}, open x")
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    with KeepCounts():
        f_k = _make_kernel(cfg, geom)(*pack_fields(cfg, geom, st_prod))
    sweep_err, sweep_scale = against_sweep(cfg, geom, st_prod, f_k,
                                           "open charged pair kernel")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st_prod, 2 * r_every)
    log(f"open charged profile: {prof}")
    kernel_only = kernel_only_checks(cfg, st_prod)
    golden = check_golden()

    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], equilibrate_s=eq_s,
                path_s=path_s, thermo=marks, telemetry=tel,
                start_ions=ions0, buffer_census=[int(m.nbuf_left),
                                                 int(m.nbuf_right)],
                deleted=deleted, max_cell_count=max(occupancy),
                filing_cap=geom.fcap, insertion_phase_inserted=inserted,
                small_path_max_pos_err=small_err, usher=usher_info,
                forces_vs_sweep_max_abs_err=sweep_err,
                forces_vs_sweep_max_f=sweep_scale, profile=prof,
                kernel_only_checks=kernel_only, golden=golden,
                usher_f64=usher64_info)
    kernels = [
        kernel_line("pair", f"ljrf, 2 types, cap {geom.fcap}, open x, "
                    f"p = {geom.p}", "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1][key], pair),
        kernel_line("usher_search_ljrf", "lj/cut/rf rows, 2 types", None,
                    launches["usher_search_ljrf"][0], usher),
        kernel_line("usher_search_ljrf_f64", "lj/cut/rf rows, 2 types, on "
                    "the open charged fluid's subsets widened to float64, "
                    "kernel-only", None, 0, usher64),
    ]
    return path, kernels, (cfg, st_prod)


def run_gaussian(cfg24, st_eq, uniform_temps):
    """Phase 19: path A, the OBMD_DPD main path with gaussian pair noise
    from phase 4's equilibrated state st_eq (cfg24 is the scene's setup-cap
    configuration), and the gaussian kernel's checks.  uniform_temps: the
    kinetic T at phase 4's window ends, the same steps after st_eq."""
    import torch
    from bench_torch import NSTEPS, PROD_CAP, production, repack
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.engine_cellpad import (_make_kernel,
                                               auto_rebuild_every,
                                               pack_fields)
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn

    def gaussian(cfg):
        return dataclasses.replace(cfg, pair=dataclasses.replace(
            cfg.pair, gaussian_noise=True))
    # the bench's cap-15 layout: the gaussian kernel against its plain
    # version and against the uniform kernel with the same salt
    cfg15, geom15, st15 = repack(gaussian(cfg24), st_eq, PROD_CAP)
    pair15, f_gauss = check_pair(cfg15, geom15, st15,
                                 f"dpd, gaussian, cap {geom15.fcap}")
    with KeepCounts():
        uniform = dataclasses.replace(cfg15, pair=cfg24.pair)
        f_uni = _make_kernel(uniform, geom15)(*pack_fields(uniform, geom15,
                                                           st15))
        sync()
    alive = st15.alive.reshape(geom15.n_blocks, 1, geom15.cap, geom15.lanes)
    scale = float(torch.where(alive, f_gauss, 0.0).abs().max())
    differ = float((f_gauss - f_uni).abs().max())
    if not differ > 2e-4 * scale:
        fail(f"gaussian OBMD_DPD: the gaussian forces differ from the "
             f"uniform ones by only {differ} (max|f| {scale})")
    log(f"gaussian against uniform noise, one salt: max difference "
        f"{differ:.3e} (max|f| {scale:.1f})")

    _build.reset_launch_counts()
    t_path = time.perf_counter()
    cfg, geom, st = repack(gaussian(cfg24), st_eq, GAUSS_CAP)
    probe = window_temps(cfg, geom, "gaussian OBMD_DPD main path")
    probes = [probe(st)]
    st, windows, more = production(cfg, st, probe)
    probes += more
    occupancy = [p[0] for p in probes]
    temps = [p[1:] for p in probes]
    t_relax = check_thermal(probes, "gaussian OBMD_DPD main path")
    tel = check_invariants(cfg, st)
    check_finite(st, "gaussian OBMD_DPD main path")
    natoms = int(st.natoms)
    st_prod = st
    for (t, _), tu in zip(temps[-2:], uniform_temps):
        if not abs(t - tu) <= 0.05 * tu:
            fail(f"gaussian OBMD_DPD: kinetic T {t} at a window end is not "
                 f"within 5% of the uniform run's {tu} at that step")
    m = make_obmd_metrics_fn(cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = gaussian(dataclasses.replace(cfg24, obmd=dataclasses.replace(
        cfg24.obmd, nbuf=1.05 * census / cfg24.obmd.alpha)).finalize())
    _, geom24, st = repack(cfg_ins, st, cfg_ins.capacity.cell_capacity)
    ins0 = int(st.obmd.ninserted)
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    if inserted <= 0:
        fail("gaussian OBMD_DPD insertion phase inserted no atoms")
    check_finite(st, "gaussian OBMD_DPD insertion phase")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    k16, k24 = f"dpd-gauss-cap{geom.fcap}", f"dpd-gauss-cap{geom24.fcap}"
    wall, steps = min(windows)
    log(f"gaussian OBMD_DPD main path ({natoms} atoms, {geom}) {path_s:.1f} "
        f"s, windows {windows}, {wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, kinetic and "
        f"thermal T at the repack and after each run {temps} (kinetic at "
        f"the window ends under uniform noise: {uniform_temps}), telemetry "
        f"{tel}, most atoms in one cell "
        f"{occupancy} (filing cap {geom.fcap}); insertion phase: nbuf "
        f"{cfg_ins.obmd.nbuf:.1f}, {inserted} inserted in {INS_STEPS} steps, "
        f"{tel_ins}; launches {launches}")
    require_launches(launches, {"pair": (k16, k24), "usher_search": None},
                     "gaussian OBMD_DPD main path")
    if launches["pair"][1][k16] != 3 * NSTEPS \
            or launches["pair"][1][k24] != INS_STEPS:
        fail(f"gaussian OBMD_DPD: pair launches {launches['pair'][1]}, "
             f"expected {3 * NSTEPS} at cap {geom.fcap} and {INS_STEPS} at "
             f"cap {geom24.fcap}")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st_prod, 2 * r_every)
    log(f"gaussian OBMD_DPD profile: {prof}")
    pair16, _ = check_pair(cfg, geom, st_prod,
                           f"dpd, gaussian, cap {geom.fcap}")
    pair24, _ = check_pair(cfg_ins, geom24, st,
                           f"dpd, gaussian, cap {geom24.fcap}")
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], path_s=path_s,
                kinetic_thermal_temps=temps, thermal_temp_limit=t_relax,
                uniform_window_end_temps=uniform_temps,
                telemetry=tel, filing_cap=geom.fcap,
                max_cell_count=occupancy,
                kernel_cap15=pair15,
                insertion_phase_inserted=inserted,
                usher_launches=launches["usher_search"][0],
                gaussian_vs_uniform_max_diff=differ, profile=prof)
    kernels = [
        kernel_line("pair", f"dpd, gaussian noise, fill cap {geom.fcap}",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    launches["pair"][1][k16], pair16),
        kernel_line("pair", f"dpd, gaussian noise, fill cap {geom24.fcap}",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1][k24], pair24),
    ]
    return path, kernels


def ramp_target(pair, step):
    """The ramp's T(step) (pair_dpd_tstat.cpp:52-60)."""
    b, e = pair.ramp
    frac = min(max((step - b) / max(e - b, 1), 0.0), 1.0)
    return pair.temp + frac * (pair.t_stop - pair.temp)


def check_tstat_golden():
    """The reference binary's dpd/tstat forces
    (validation/dpdtstat_golden: 300 atoms in a periodic 9^3 box at T = 0,
    gamma 3.5, rc 1.2) through setup on the card: every force within 5e-5
    * max|f| of dump.ref (validation/run_dpdtstat_golden.py's bar)."""
    import numpy as np
    from obmd_tpu_torch import config
    from obmd_tpu_torch.integrate import setup
    from obmd_tpu_torch.io.lammps_data import read_data
    from obmd_tpu_torch.state import init_state
    df = read_data(os.path.join(TSTAT_GOLDEN_DIR, "fluid.data"),
                   atom_style="atomic")
    ref = {}
    with open(os.path.join(TSTAT_GOLDEN_DIR, "dump.ref")) as fh:
        lines = fh.read().splitlines()
    for line in lines[lines.index("ITEM: ATOMS id fx fy fz") + 1:]:
        t = line.split()
        ref[int(t[0])] = np.asarray([float(v) for v in t[1:4]])
    pair = config.DPDTstatParams.create(t_start=0.0, cutoff=1.2, seed=999,
                                        gamma=3.5)
    cfg = config.SceneConfig(
        box=df.box(periodic=(True, True, True)), masses=tuple(df.masses),
        pair=pair, dt=0.01,
        capacity=config.Capacity(n_max=df.natoms, cell_capacity=16),
        skin=0.3)
    with KeepCounts():
        st = setup(cfg, init_state(cfg, df.x, v=df.v, tags=df.tags,
                                   device=DEV))
        sync()
    f = st.f.cpu().numpy()
    got = {int(t): f[i] for i, t in enumerate(st.tag.tolist())
           if bool(st.alive[i])}
    if set(got) != set(ref):
        fail("dpd/tstat golden: the atom ids differ from dump.ref")
    scale = max(float(np.linalg.norm(v)) for v in ref.values())
    err = max(float(np.abs(got[t] - ref[t]).max()) for t in ref)
    if not err <= 5e-5 * scale:
        fail(f"dpd/tstat golden: max force error {err} > 5e-5 * {scale}")
    log(f"dpd/tstat golden ({len(ref)} atoms): the pair kernel on the card "
        f"against the reference binary's forces, max error {err:.3e} "
        f"(max|f| {scale:.4f}, bar {5e-5 * scale:.3e})")
    return dict(max_abs_err=err, max_f=scale)


def run_tstat():
    """Phases 20-21: path B, the dpd/tstat heating ramp, its kernel checks,
    and the reference binary's dpd/tstat golden."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.forces.pairs import sig_scale_of
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants
    from obmd_tpu_torch.state import temperature

    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.dpd_tstat_scene(device=DEV)
    cfg = sc.cfg
    pair = cfg.pair
    geom = make_geometry(cfg)
    r_every = auto_rebuild_every(cfg)
    st = setup(cfg, sc.state)
    run = make_run(cfg, TSTAT_MARK)
    marks, walls = [], []
    for _ in range(TSTAT_MARKS):
        t1 = time.perf_counter()
        st = run(st)
        sync()
        walls.append(time.perf_counter() - t1)
        m = dict(step=st.step, temp=float(temperature(cfg, st)),
                 target=ramp_target(pair, st.step),
                 sig_scale=sig_scale_of(cfg.pair, st.step))
        marks.append(m)
        log(f"dpd/tstat ramp: step {m['step']} T {m['temp']:.5f} T(step) "
            f"{m['target']:.4f} sig_scale {m['sig_scale']:.6f}")
    occupancy = max_cell_count(geom, st)
    tel = check_invariants(cfg, st)
    check_finite(st, "dpd/tstat ramp")
    natoms = int(st.natoms)
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    if not marks[-1]["temp"] > marks[0]["temp"]:
        fail(f"dpd/tstat ramp: T did not rise ({marks[0]['temp']} -> "
             f"{marks[-1]['temp']})")
    if not abs(marks[-1]["temp"] - pair.t_stop) < 0.15 * pair.t_stop:
        fail(f"dpd/tstat ramp: T {marks[-1]['temp']} at the end is not "
             f"within 15% of t_stop = {pair.t_stop}")
    n_timed = TSTAT_TIMED // TSTAT_MARK
    tail = sum(walls[-n_timed:])
    key = f"dpd-ramp-cap{geom.fcap}"
    log(f"dpd/tstat ramp ({natoms} atoms, {geom}) {path_s:.1f} s, relayout "
        f"every {r_every} step(s), last {TSTAT_TIMED} steps {tail:.3f} s "
        f"({tail / TSTAT_TIMED * 1e3:.3f} ms/step, "
        f"{TSTAT_TIMED / tail * natoms / 1e6:.3f} Mparticle-steps/s), "
        f"telemetry {tel}, most atoms in one cell at the end {occupancy} "
        f"(filing cap {geom.fcap}); launches {launches}")
    require_launches(launches, {"pair": (key,)}, "dpd/tstat ramp")
    if launches["pair"][0] != TSTAT_MARK * TSTAT_MARKS + 1:
        fail(f"dpd/tstat ramp: {launches['pair'][0]} pair kernel launches "
             f"for setup and {TSTAT_MARK * TSTAT_MARKS} steps")
    mid = sig_scale_of(cfg.pair, (pair.ramp[0] + pair.ramp[1]) // 2)
    ramp1, _ = check_pair(cfg, geom, st, f"dpd/tstat ramp, cap {geom.fcap}, "
                          "sig_scale 1", sig_scale=1.0)
    ramp_mid, _ = check_pair(cfg, geom, st, f"dpd/tstat ramp, cap "
                             f"{geom.fcap}, sig_scale {mid:.6f}",
                             sig_scale=mid)
    prof = profile_steps(make_run(cfg, 2 * r_every), st, 2 * r_every)
    log(f"dpd/tstat profile: {prof}")
    golden = check_tstat_golden()
    path = dict(atoms=natoms, relayout_every=r_every,
                ms_per_step=tail / TSTAT_TIMED * 1e3,
                mparticle_steps_per_s=TSTAT_TIMED / tail * natoms / 1e6,
                mark_walls_s=walls, path_s=path_s, marks=marks,
                telemetry=tel, max_cell_count=occupancy,
                filing_cap=geom.fcap,
                kernel_at_mid_sig_scale=dict(sig_scale=mid, **ramp_mid),
                profile=prof, golden=golden)
    figures = dict(ramp_mid, max_abs_err=max(ramp1["max_abs_err"],
                                             ramp_mid["max_abs_err"]))
    kernels = [kernel_line(
        "pair", f"dpd/tstat, ramp sig_scale, fill cap {geom.fcap}, "
        f"p = {geom.p}", "obmd_tpu/forces/pallas_dpd.py:324",
        launches["pair"][1][key], figures)]
    return path, kernels


def run_near(cfg24, st_eq):
    """Phase 22: path C, the OBMD_DPD deck with `near 0.35` insertion (the
    scene's usher=False configuration, dataclasses.replace of obmd) from
    phase 4's equilibrated state st_eq: repacked at cap 15, production,
    then the insertion phase at cap 24 with nbuf raised to 1.05 x census /
    alpha.  The pair kernel's two bodies and the stage's near check run;
    USHER never does."""
    from bench_torch import NSTEPS, PROD_CAP, production, repack
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn

    def near(cfg, **obmd):
        return dataclasses.replace(cfg, obmd=dataclasses.replace(
            cfg.obmd, usher=None, near=NEAR, **obmd)).finalize()

    _build.reset_launch_counts()
    t_path = time.perf_counter()
    cfg, geom, st = repack(near(cfg24), st_eq, PROD_CAP)
    st, windows, _ = production(cfg, st)
    tel = check_invariants(cfg, st)
    check_finite(st, "near OBMD_DPD main path")
    natoms = int(st.natoms)
    occupancy = max_cell_count(geom, st)
    st_prod = st
    m = make_obmd_metrics_fn(cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = near(cfg24, nbuf=1.05 * census / cfg24.obmd.alpha)
    _, geom24, st = repack(cfg_ins, st, cfg_ins.capacity.cell_capacity)
    ins0, fail0 = int(st.obmd.ninserted), int(st.obmd.insert_fail)
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    rejected = int(st.obmd.insert_fail) - fail0
    if inserted <= 0:
        fail("near OBMD_DPD insertion phase inserted no atoms")
    if int(st.obmd.usher_iters) != int(st_eq.obmd.usher_iters):
        fail("near OBMD_DPD: the USHER iteration count moved")
    check_finite(st, "near OBMD_DPD insertion phase")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    k15, k24 = f"dpd-cap{geom.fcap}", f"dpd-cap{geom24.fcap}"
    wall, steps = min(windows)
    log(f"near OBMD_DPD main path ({natoms} atoms, {geom}) {path_s:.1f} s, "
        f"windows {windows}, {wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, telemetry "
        f"{tel}, most atoms in one cell {occupancy} (filing cap "
        f"{geom.fcap}); insertion phase: nbuf {cfg_ins.obmd.nbuf:.1f}, "
        f"{inserted} inserted and {rejected} asked for but not placed in "
        f"{INS_STEPS} steps, {tel_ins}; launches {launches}")
    require_launches(launches, {"pair": (k15, k24)},
                     "near OBMD_DPD main path")
    if launches["pair"][1][k15] != 3 * NSTEPS \
            or launches["pair"][1][k24] != INS_STEPS:
        fail(f"near OBMD_DPD: pair launches {launches['pair'][1]}, "
             f"expected {3 * NSTEPS} at cap {geom.fcap} and {INS_STEPS} at "
             f"cap {geom24.fcap}")
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st_prod, 2 * r_every)
    log(f"near OBMD_DPD profile: {prof}")
    pair15, _ = check_pair(cfg, geom, st_prod, f"dpd, near, cap {geom.fcap}")
    pair24, _ = check_pair(cfg_ins, geom24, st,
                           f"dpd, near, cap {geom24.fcap}")
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], path_s=path_s,
                telemetry=tel, filing_cap=geom.fcap,
                max_cell_count=occupancy, insertion_phase_inserted=inserted,
                insertion_phase_not_placed=rejected, profile=prof)
    kernels = [
        kernel_line("pair", f"dpd, near path, fill cap {geom.fcap}",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    launches["pair"][1][k15], pair15),
        kernel_line("pair", f"dpd, near path, fill cap {geom24.fcap}",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1][k24], pair24),
    ]
    return path, kernels


def force_gap(cfg, state):
    """tests/test_conservation.py's invariant on one state: |sum f -
    (mfl + mfr + sfl + sfr)| and its bound, 2e-6 x max(2 |pxx| A,
    2 max|setpoints|), or None when a buffer is empty (its force then has
    no atom to go to)."""
    import torch
    sc = state.obmd
    for region in (cfg.obmd.region1, cfg.obmd.region2):
        if not bool((state.alive & region.match(state.x)).any()):
            return None
    mf = sum(getattr(sc, k).double() for k in (
        "momentum_force_left", "momentum_force_right", "shear_force_left",
        "shear_force_right"))
    total = torch.where(state.alive[:, None], state.f, 0.0).double().sum(0)
    gap = float((total - mf).abs().max())
    load = 2 * abs(cfg.obmd.pxx) * cfg.box.cross_area
    return gap, 2e-6 * max(load, float(mf.abs().max()) * 2)


def run_near_box():
    """Phase 23: path D, the JAX package's momentum-conservation box with
    `near` insertion (near_box_scene: 7 x 1 x 1 cells, single-cell periodic
    y and z, cap 112): setup and NEAR_BOX_STEPS steps one at a time, sum(f)
    on the boundary setpoints at every step whose buffers both hold atoms,
    insertions, check_invariants; a timed window of NEAR_BOX_STEPS steps
    without those checks and a profile; then its pair kernel and
    full-stencil kernel against their plain versions and the pair sweep,
    and FULL_STEPS steps through the full-stencil kernel."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import (auto_rebuild_every,
                                               make_geometry)
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants

    _build.reset_launch_counts()
    t_path = time.perf_counter()
    sc = scenes.near_box_scene(device=DEV)
    cfg = sc.cfg
    geom = make_geometry(cfg)
    st = setup(cfg, sc.state)
    run = make_run(cfg, 1)
    gaps = []
    t_run = time.perf_counter()
    for _ in range(NEAR_BOX_STEPS):
        st = run(st)
        g = force_gap(cfg, st)
        if g is None:
            continue
        if not g[0] < g[1]:
            fail(f"near box: step {st.step}: |sum f - setpoints| {g[0]} >= "
                 f"{g[1]}")
        gaps.append(g[0] / g[1])
    sync()
    run_s = time.perf_counter() - t_run
    tel = check_invariants(cfg, st)
    check_finite(st, "near box")
    if len(gaps) < NEAR_BOX_STEPS // 2 or tel["ninserted"] <= 0:
        fail(f"near box: {len(gaps)} steps checked, telemetry {tel}")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    key = f"dpd-1cell-cap{geom.fcap}"
    log(f"near box ({int(st.natoms)} atoms, {geom}) {path_s:.1f} s, "
        f"{NEAR_BOX_STEPS} steps {run_s:.3f} s, sum(f) on the setpoints at "
        f"{len(gaps)} steps (largest gap {max(gaps):.3f} of its bound), "
        f"telemetry {tel}; launches {launches}")
    require_launches(launches, {"pair": (key,)}, "near box")
    if launches["pair"][0] != NEAR_BOX_STEPS + 1:
        fail(f"near box: {launches['pair'][0]} pair launches for setup and "
             f"{NEAR_BOX_STEPS} steps")
    # a timed window without the per-step host checks, and a profile
    t0 = time.perf_counter()
    st = make_run(cfg, NEAR_BOX_STEPS)(st)
    sync()
    window_s = time.perf_counter() - t0
    check_invariants(cfg, st)
    r_every = auto_rebuild_every(cfg)
    prof = profile_steps(make_run(cfg, 2 * r_every), st, 2 * r_every)
    log(f"near box: {NEAR_BOX_STEPS} steps unchecked {window_s:.3f} s; "
        f"profile: {prof}")
    pair, f_k = check_pair(cfg, geom, st, f"dpd, 7 x 1 x 1 cells, cap "
                           f"{geom.fcap}")
    full, f_full = check_pair(cfg, geom, st, f"dpd, 7 x 1 x 1 cells, cap "
                              f"{geom.fcap}", "full")
    compare_forces(geom, st.alive, f_full, f_k,
                   "near box: full against pair")
    sweep_err, _ = against_sweep(cfg, geom, st, f_k, "near box pair kernel")
    _, full_ms, full_launches = run_full_path(cfg, st, "near box")
    require_launches(full_launches, {"dpd_full": (key,)},
                     "near box through the full-stencil kernel")
    path = dict(atoms=int(st.natoms), steps=NEAR_BOX_STEPS,
                ms_per_step=window_s / NEAR_BOX_STEPS * 1e3,
                mparticle_steps_per_s=NEAR_BOX_STEPS / window_s
                * int(st.natoms) / 1e6,
                checked_ms_per_step=run_s / NEAR_BOX_STEPS * 1e3,
                path_s=path_s, profile=prof,
                telemetry=tel, force_sum_checked_steps=len(gaps),
                force_sum_largest_gap_of_bound=max(gaps),
                forces_vs_sweep_max_abs_err=sweep_err,
                full_kernel_ms_per_step=full_ms)
    kernels = [
        kernel_line("pair", f"dpd, single-cell y and z, fill cap "
                    f"{geom.fcap}", "obmd_tpu/forces/pallas_dpd.py:324",
                    launches["pair"][1][key], pair),
        kernel_line("dpd_full", f"dpd, single-cell y and z, fill cap "
                    f"{geom.fcap}", None, full_launches["dpd_full"][0],
                    full),
    ]
    return path, kernels


def float_leaves(state) -> dict:
    """Every floating tensor of a State, its ObmdScalars and its layout, by
    name."""
    import torch
    out = {}
    for obj, pre in ((state, ""), (state.obmd, "obmd."),
                     (state.nbrs, "nbrs.")):
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                out[pre + f.name] = t
    return out


def require_float64(state, label):
    """Every float tensor of the state is float64."""
    import torch
    narrow = {k: str(t.dtype) for k, t in float_leaves(state).items()
              if t.dtype != torch.float64}
    if narrow:
        fail(f"{label}: float tensors not float64: {narrow}")


def run_closed_box(dtype="float32"):
    """Phase 23b: path N, the closed periodic DPD box of Milestone A
    (scenes.closed_dpd_scene at CLOSED_BOX: 2,000 atoms in a cube of
    8.736, NVE with the DPD thermostat, dt 0.04), on the nlist engine as
    the scene sets it and on the cellpad engine (force_path="cellpad" at
    CLOSED_CELLPAD_SKIN and _CAP: the pair kernel on a fully periodic DPD
    box of 5 cells a side): per engine launch counts zeroed before setup
    and read after, setup, CLOSED_SETTLE steps, then CLOSED_MEAN steps
    one at a time with the kinetic T read after each, its mean in
    CLOSED_T (the JAX package's tests/test_integrate.py:45-60),
    check_invariants; the nlist engine launches no kernel, the cellpad
    engine the pair kernel once per step and at setup; then that launch
    on the ended state against its plain version.

    Phase 23c, path N64, with dtype="float64": the same at float64.  On
    the nlist engine every float tensor of the ended state float64 and
    most forces not float32 values (a float64 force, not one cast up); on
    the cellpad engine the state float64 and every force a float32 value
    (the kernel's on float32 fields, cast up, as the JAX engine runs it),
    the same row held to its plain version."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants
    from obmd_tpu_torch.state import temperature

    f64 = dtype == "float64"
    path, kernels = {}, []
    for engine in ("nlist", "cellpad"):
        sc = scenes.closed_dpd_scene(**CLOSED_BOX, dtype=dtype, device=DEV)
        cfg = sc.cfg
        if engine == "cellpad":
            cfg = dataclasses.replace(
                cfg, force_path=engine, skin=CLOSED_CELLPAD_SKIN,
                capacity=dataclasses.replace(
                    cfg.capacity, cell_capacity=CLOSED_CELLPAD_CAP))
        cfg = cfg.finalize()
        label = f"closed DPD box, {engine} engine, {dtype}"
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        st = make_run(cfg, CLOSED_SETTLE)(setup(cfg, sc.state))
        step = make_run(cfg, 1)
        temps = []
        for _ in range(CLOSED_MEAN):
            st = step(st)
            temps.append(float(temperature(cfg, st)))
        run_s = time.perf_counter() - t0
        tel = check_invariants(cfg, st)
        check_finite(st, label)
        launches = launch_counts()
        t_mean = statistics.fmean(temps)
        log(f"{label} ({int(st.natoms)} atoms): setup and "
            f"{CLOSED_SETTLE + CLOSED_MEAN} steps {run_s:.2f} s, mean T over "
            f"the last {CLOSED_MEAN} {t_mean:.5f}, telemetry {tel}, launches "
            f"{launches}")
        if not CLOSED_T[0] < t_mean < CLOSED_T[1]:
            fail(f"{label}: mean T {t_mean} outside {CLOSED_T}")
        fig = dict(atoms=int(st.natoms), t_mean=t_mean,
                   ms_per_step=run_s / (CLOSED_SETTLE + CLOSED_MEAN) * 1e3,
                   telemetry=tel)
        if f64:
            require_float64(st, label)
            f = st.f[st.alive]
            narrow = float((f == f.to(torch.float32).to(f.dtype))
                           .all(-1).to(torch.float64).mean())
            if engine == "nlist" and not narrow < 0.1:
                fail(f"{label}: {narrow:.3f} of the forces are float32 "
                     f"values")
            if engine == "cellpad" and narrow != 1.0:
                fail(f"{label}: the kernel's forces are not float32 values "
                     f"({narrow:.3f})")
            fig["float32_valued_forces"] = narrow
        if engine == "nlist":
            require_launches(launches, {}, label)
        else:
            geom = make_geometry(cfg)
            key = f"dpd-cap{geom.fcap}"
            require_launches(launches, {"pair": (key,)}, label)
            n = launches["pair"][0]
            if n != CLOSED_SETTLE + CLOSED_MEAN + 1:
                fail(f"{label}: {n} pair launches for setup and "
                     f"{CLOSED_SETTLE + CLOSED_MEAN} steps")
            row = (f"dpd, closed periodic box of "
                   f"{' x '.join(map(str, geom.dims))} cells, fill cap "
                   f"{geom.fcap}" + (", float64 state" if f64 else ""))
            pair, _ = check_pair(cfg, geom, st, row)
            kernels.append(kernel_line("pair", row,
                                       "obmd_tpu/forces/pallas_dpd.py:324",
                                       n, pair))
            fig.update(dims=geom.dims, launches=n)
        path[engine] = fig
    return path, kernels


def run_film():
    """Phase 24: a ~100k-atom DPD film whose z axis is one cell
    (dpd_film_scene), then the same film with y open: setup and FILM_STEPS
    steps through the entry points (launch counts zeroed before and read
    after), check_invariants; then on the ended state each instantiation
    against its plain version and the pair sweep (the full-stencil kernel
    on the periodic film only: make_dpd_kernel has no open y/z, and the
    port refuses it there)."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import _make_kernel, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants

    out, figures = [], {}
    for y_open in (False, True):
        sc = scenes.dpd_film_scene(device=DEV, y_open=y_open)
        cfg = sc.cfg
        geom = make_geometry(cfg)
        label = f"dpd film, {'y open, ' if y_open else ''}z one cell, " \
            f"fill cap {geom.fcap}"
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        st = setup(cfg, sc.state)
        st = make_run(cfg, FILM_STEPS)(st)
        sync()
        run_s = time.perf_counter() - t0
        tel = check_invariants(cfg, st)
        check_finite(st, label)
        launches = launch_counts()
        key = "dpd-1cell" + ("-openyz" if y_open else "") + \
            f"-cap{geom.fcap}"
        require_launches(launches, {"pair": (key,)}, label)
        if launches["pair"][0] != FILM_STEPS + 1:
            fail(f"{label}: {launches['pair'][0]} pair launches for setup "
                 f"and {FILM_STEPS} steps")
        log(f"{label} ({int(st.natoms)} atoms, {geom}): setup and "
            f"{FILM_STEPS} steps {run_s:.2f} s, telemetry {tel}, launches "
            f"{launches}")
        pair, f_k = check_pair(cfg, geom, st, label)
        sweep_err, _ = against_sweep(cfg, geom, st, f_k, f"{label}: pair")
        figures[label] = dict(atoms=int(st.natoms), dims=geom.dims,
                              telemetry=tel,
                              pair_vs_sweep_max_abs_err=sweep_err)
        out.append(kernel_line("pair", label,
                               "obmd_tpu/forces/pallas_dpd.py:324",
                               launches["pair"][0], pair))
        if y_open:
            try:
                _make_kernel(cfg, geom, "full")
            except NotImplementedError:
                pass
            else:
                fail("DPD film: the full-stencil kernel took an open y axis")
        else:
            full, f_full = check_pair(cfg, geom, st, label, "full")
            compare_forces(geom, st.alive, f_full, f_k,
                           f"{label}: full against pair")
            _build.reset_launch_counts()
            make_run(cfg, FILM_STEPS, kernel="full")(st)
            sync()
            full_launches = launch_counts()
            require_launches(full_launches, {"dpd_full": (key,)},
                             f"{label} through the full-stencil kernel")
            out.append(kernel_line("dpd_full", label, None,
                                   full_launches["dpd_full"][0], full))
        del sc, st, f_k
        torch.cuda.empty_cache()
    return figures, out


@functools.lru_cache(maxsize=1)
def _small_star_start():
    """The star melt's small path start: star_melt_scene(n_stars=307) (the
    L = 8 box), warmed up on the card (star_warm_up, STAR_SMALL_WARM
    steps), as arrays."""
    from obmd_tpu_torch import convert, scenes
    sc = scenes.star_melt_scene(n_stars=STAR_SMALL, device=DEV)
    warm = scenes.star_warm_up(sc.cfg, sc.state, *STAR_SMALL_WARM)
    return sc.cfg, convert.to_arrays(warm)


def small_star():
    """The star melt's small path, make(device): one warmed start
    (_small_star_start), copied to the device, at the production filing
    cap."""
    return functools.partial(_small_star_make, _small_star_start())


def _small_star_make(start, dev):
    from obmd_tpu_torch import convert, scenes
    cfg, arrays = start
    return (scenes.with_cap(cfg, scenes.STAR_PROD_CAP),
            convert.from_arrays(arrays, device=dev))


def star_marks(cfg, thermo, state, marks, label):
    """Thermo through the pair sweep, the bonded energies and the bond
    figures at a window end; no bond may reach STAR_BOND_LIMIT."""
    from obmd_tpu_torch.observe import bond_stats
    t = thermo(state)
    m = thermo_line(t)
    n = int(t.natoms)
    longest, over, count = bond_stats(cfg, state, limit=STAR_BOND_LIMIT)
    m.update(ebond_per_atom=float(t.ebond) / n,
             eangle_per_atom=float(t.eangle) / n,
             eimp_per_atom=float(t.eimp) / n, longest_bond=longest,
             bonds_beyond_limit=over, bonds=count)
    log(f"{label}: step {m['step']} T {m['temp']:.5f} E_pair/N "
        f"{m['epair_per_atom']:.6f} E_bond/N {m['ebond_per_atom']:.6f} "
        f"E_angle/N {m['eangle_per_atom']:.6f} E_imp/N "
        f"{m['eimp_per_atom']:.6f} longest bond {longest:.4f}")
    if over:
        fail(f"{label}: {over} bonds at or beyond {STAR_BOND_LIMIT} at step "
             f"{state.step} (longest {longest})")
    marks.append(m)
    return m


def check_bonded_goldens():
    """The reference binary's bonded goldens through the port's reader and
    setup on the card (scenes.golden_scene: DPD a0 = 0, T = 0 for `pair
    zero`): validation/bonded_golden (harmonic bonds, angles, dihedrals on
    30 4-bead chains) within 5e-5 * max|f| of dump.ref, and
    validation/improper_golden (24 three-arm stars, 4-channel exclusion)
    within 2e-4 * max|f| (float32: near-degenerate stars amplify rounding,
    validation/run_improper_golden.py:142-150).  Returns each one's max
    error and max|f|."""
    import numpy as np
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import setup
    out = {}
    for folder, bar in (("bonded_golden", 5e-5), ("improper_golden", 2e-4)):
        sc = scenes.golden_scene(folder, device=DEV)
        with KeepCounts():
            st = setup(sc.cfg, sc.state)
            sync()
        ref = scenes.golden_forces(folder)
        f = st.f.cpu().numpy()
        got = {int(t): f[i] for i, t in enumerate(st.tag.tolist())
               if bool(st.alive[i])}
        if set(got) != set(ref):
            fail(f"{folder}: the atom ids differ from dump.ref")
        scale = max(float(np.linalg.norm(v)) for v in ref.values())
        err = max(float(np.abs(got[t] - ref[t]).max()) for t in ref)
        if not err <= bar * scale:
            fail(f"{folder}: max force error {err} > {bar} * {scale}")
        log(f"{folder} ({len(ref)} atoms): setup on the card against LAMMPS' "
            f"forces, max error {err:.3e} (max|f| {scale:.2f}, bar "
            f"{bar * scale:.3e})")
        out[folder] = dict(max_abs_err=err, max_f=scale)
    return out


def run_star():
    """Phases 25-27: path E, the closed star-polymer melt: its small path
    against the CPU, its main path with the 4-channel pair kernel at the
    warm-up's caps and the production cap, the kernel and exclusion
    checks, a profile, and the two bonded goldens."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import (bond_stats, check_invariants,
                                        ill_conditioned_impropers,
                                        make_thermo_fn)
    from obmd_tpu_torch.state import temperature

    # ---- phase 25: the path at a small size against the CPU, checked
    # after phase 26: its start is warmed on the card here, its CPU run
    # goes to the side process meanwhile
    exact = SMALL_EXACT + ("bond3", "bond4", "impr")
    with KeepCounts():
        star_small = small_star()
    side_queue_small("star melt", star_small, ill_conditioned_impropers)
    for free in (False, True):
        side_queue(f"rigid golden, free {free}", rigid_golden_run, "cpu",
                   free)

    # ---- phase 26: the main path
    t_path = time.perf_counter()
    sc = scenes.star_melt_scene(device=DEV)
    cfg = sc.cfg
    n_bonds = bond_stats(cfg, sc.state)[2]
    caps = (scenes.STAR_START_CAP, scenes.STAR_WARM_CAP)
    wcfgs = [scenes.with_cap(cfg, c) for c in caps]
    wgeoms = [make_geometry(c) for c in wcfgs]
    wkeys = [f"dpd-t2-excl4-cap{g.fcap}" for g in wgeoms]
    start_max = max_cell_count(wgeoms[0], sc.state)
    # the start's kernel at its own cap, against its plain version
    with KeepCounts():
        st0 = setup(wcfgs[0], sc.state)
    start_pair, _ = check_pair(wcfgs[0], wgeoms[0], st0,
                               f"dpd, 2 types, 4-channel exclusion, cap "
                               f"{wgeoms[0].fcap}, the random start")
    del st0
    _build.reset_launch_counts()
    t_warm = time.perf_counter()
    st = scenes.star_warm_up(cfg, sc.state)
    sync()
    warm_s = time.perf_counter() - t_warm
    warm_launches = launch_counts()
    require_launches(warm_launches, {"pair": tuple(wkeys)}, "star warm-up")
    warm_t = float(temperature(cfg, st))
    warm_longest, warm_over, _ = bond_stats(cfg, st, limit=STAR_BOND_LIMIT)
    warm_tel = check_invariants(wcfgs[1], st)
    warm_max = max_cell_count(wgeoms[1], st)
    if warm_over or not abs(warm_t - 1.0) <= 0.05:
        fail(f"star warm-up: T {warm_t}, {warm_over} bonds beyond "
             f"{STAR_BOND_LIMIT}")
    log(f"star warm-up: {scenes.STAR_START_STEPS} steps at cap {caps[0]} "
        f"(the start's fullest cell {start_max}), {scenes.STAR_WARM_STEPS} "
        f"at cap {caps[1]}, {warm_s:.2f} s; T {warm_t:.4f}, longest bond "
        f"{warm_longest:.4f}, fullest cell {warm_max}, telemetry {warm_tel}, "
        f"launches {warm_launches}")
    # the warm-up's pair kernel (the rank-looped body) on the warmed state,
    # in the warm-up's layout: against its plain version, and against
    # itself without pbond
    warm_pair, _ = check_pair(wcfgs[1], wgeoms[1], st,
                              f"dpd, 2 types, 4-channel exclusion, cap "
                              f"{wgeoms[1].fcap}, warm-up")
    warm_near = check_exclusion(wcfgs[1], wgeoms[1], st, "pair",
                                label=f"star cap {wgeoms[1].fcap}")
    pcfg = scenes.with_cap(cfg, scenes.STAR_PROD_CAP)
    geom = make_geometry(pcfg)
    key = f"dpd-t2-excl4-cap{geom.fcap}"
    thermo = make_thermo_fn(pcfg)
    _build.reset_launch_counts()
    st = setup(pcfg, st)
    occupancy = [max_cell_count(geom, st)]
    run = make_run(pcfg, STAR_STEPS)
    st = run(st)
    sync()
    occupancy.append(max_cell_count(geom, st))
    marks = []
    star_marks(pcfg, thermo, st, marks, "star main path")
    windows = []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        star_marks(pcfg, thermo, st, marks, "star main path")
    launches = launch_counts()
    tel = check_invariants(pcfg, st)
    check_finite(st, "star main path")
    natoms = int(st.natoms)
    path_s = time.perf_counter() - t_path
    for m in marks[1:]:
        if not abs(m["temp"] - 1.0) <= 0.05:
            fail(f"star melt: T {m['temp']} at step {m['step']} is not "
                 "within 5% of 1.0")
    wall, steps = min(windows)
    longest = max(m["longest_bond"] for m in marks)
    log(f"star main path ({natoms} beads, {n_bonds} bonds, {geom}) "
        f"{path_s:.1f} s (warm-up {warm_s:.1f} s), windows {windows}, "
        f"telemetry {tel}, most atoms in one cell at setup and after each "
        f"window {occupancy} (filing cap {geom.fcap}), longest bond "
        f"{longest:.4f}, {steps / wall:.1f} steps/s, "
        f"{wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s; launches "
        f"{launches}")
    require_launches(launches, {"pair": (key,)}, "star main path")
    if launches["pair"][0] != 3 * STAR_STEPS + 1:
        fail(f"star melt: {launches['pair'][0]} pair kernel launches for "
             f"setup and {3 * STAR_STEPS} steps")

    # the production kernel (the big-tile body) on the ended state: against
    # its plain version and against itself without pbond; a profile of two
    # relayout epochs
    pair, _ = check_pair(pcfg, geom, st, f"dpd, 2 types, 4-channel "
                         f"exclusion, cap {geom.fcap}")
    near = check_exclusion(pcfg, geom, st, "pair",
                           label=f"star cap {geom.fcap}")
    r_every = auto_rebuild_every(pcfg)
    prof = profile_steps(make_run(pcfg, 2 * r_every), st, 2 * r_every)
    log(f"star profile: {prof}")
    if prof is None:
        fail("star profile: no device activity traced")

    with KeepCounts():
        small_err = check_small_path("star melt", star_small,
                                     require_insert=False, exact=exact,
                                     unsteady=ill_conditioned_impropers)

    # ---- phase 27: the bonded goldens on the card
    goldens = check_bonded_goldens()

    path = dict(atoms=natoms, stars=natoms // 5, bonds=n_bonds,
                ms_per_step=wall / steps * 1e3, steps_per_s=steps / wall,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], warm_up_s=warm_s,
                warm_up_temp=warm_t, start_max_cell_count=start_max,
                warm_up_launches=warm_launches["pair"][1],
                path_s=path_s, thermo=marks, telemetry=tel,
                max_cell_count=max(occupancy), filing_cap=geom.fcap,
                relayout_every=r_every, longest_bond=longest,
                slots_with_1_2_pair_in_cut={wkeys[1]: warm_near, key: near},
                small_path_max_pos_err=small_err, profile=prof,
                goldens=goldens)
    kernels = [
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, cap "
                    f"{geom.fcap}, star melt",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    launches["pair"][1][key], pair),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, cap "
                    f"{wgeoms[1].fcap}, star warm-up",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    warm_launches["pair"][1][wkeys[1]], warm_pair),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, cap "
                    f"{wgeoms[0].fcap}, star warm-up start",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    warm_launches["pair"][1][wkeys[0]], start_pair),
    ]
    del sc, st
    torch.cuda.empty_cache()
    return path, kernels


def small_mol(law):
    """The small molecule-mode path of `law` (scenes.MOL_LAWS): the
    star box (DPD laws) or the stretched LJ lattice (LJ laws) of
    scenes.mol_box_scene at MOL_SMALL_ETARGET[law]; `make(device)`."""
    return functools.partial(_small_mol_make, law)


def _small_mol_make(law, dev):
    from obmd_tpu_torch import scenes
    sc = scenes.mol_box_scene(law, device=dev,
                              etarget=MOL_SMALL_ETARGET[law])
    return sc.cfg, sc.state


def whole_molecules(cfg, state, label):
    """(molecules, live atoms) of a molecule-mode state; fails unless every
    molecule is whole (observe.molecule_census)."""
    from obmd_tpu_torch.observe import molecule_census
    n, broken = molecule_census(cfg, state)
    if broken:
        fail(f"{label}: {broken} of {n} molecules are not whole")
    return n, int(state.natoms)


def star_groups(cfg, state):
    """The live atoms of a state grouped into 5-atom stars for the
    4-channel row checks: in slot order, each atom not yet taken becomes
    a center and takes its four nearest live atoms not yet taken (of its
    STAR_NEIGHBOURS nearest, minimum image on the periodic axes; too few
    left: it stays alone), the bonds written both ways.  Returns the
    state with the four partner columns set and the star count."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    alive = state.alive.cpu().numpy()
    slots = np.flatnonzero(alive)
    x = state.x[state.alive].double().cpu().numpy()
    lo = np.asarray(cfg.box.lo)
    lengths = np.asarray(cfg.box.lengths)
    size = np.where(cfg.box.periodic, lengths, 1e6)
    tree = cKDTree(np.mod(x - lo, size), boxsize=size)
    _, nbr = tree.query(np.mod(x - lo, size), k=STAR_NEIGHBOURS + 1)
    taken = np.zeros(len(x), bool)
    cols = np.full((4, state.capacity), -1, np.int32)
    stars = 0
    for i in range(len(x)):
        if taken[i]:
            continue
        taken[i] = True
        arms = [j for j in nbr[i, 1:] if not taken[j]][:4]
        if len(arms) < 4:
            continue
        taken[arms] = True
        cols[:, slots[i]] = slots[arms]
        cols[0, slots[arms]] = slots[i]
        stars += 1
    t = torch.from_numpy(cols).to(state.device)
    return state.replace(bond1=t[0], bond2=t[1], bond3=t[2], bond4=t[3],
                         impr=None), stars


def check_row(cfg, state, pair, label):
    """A 4-channel row of the pair kernel on a real state: its live atoms
    grouped into stars (star_groups), under `pair` (None: the state's own
    law), held to the plain version with holes and same bytes (check_pair)
    and against itself without pbond (check_exclusion).  Returns (figures,
    launch key, stars)."""
    from obmd_tpu_torch.config import BondHarmonicParams
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    rcfg = dataclasses.replace(cfg, pair=pair or cfg.pair, obmd=None,
                               langevin=None, bond=BondHarmonicParams(),
                               branched_topology=True)
    geom = make_geometry(rcfg)
    st, stars = star_groups(rcfg, state)
    key = launch_key(geom, PairCoef.of(geom, rcfg.pair, rcfg.dt), 4)
    figures, _ = check_pair(rcfg, geom, st, f"{label} ({key}, {stars} "
                            "stars)")
    check_exclusion(rcfg, geom, st, "pair", label=f"{label} ({key})")
    return figures, key, stars


def run_open_star(ended):
    """Phases 28-30: the small molecule-mode paths against the CPU, path F
    (the open star melt under shear) and the pair kernel's 4-channel rows
    on the ended states of OBMD_DPD, the open LJ fluid and the charged
    fluid (`ended`: law -> (cfg, state)).  Returns (path, kernels, (the
    production's config, its ended state as convert.to_arrays gives it,
    its buffer census in molecules))."""
    import torch
    from obmd_tpu_torch import _build, convert, scenes
    from obmd_tpu_torch.config import LJCutParams
    from obmd_tpu_torch.engine_cellpad import auto_rebuild_every, make_geometry
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import (check_invariants,
                                        ill_conditioned_impropers,
                                        make_obmd_metrics_fn)
    from obmd_tpu_torch.state import temperature

    # ---- phase 28: each law's small molecule-mode path against the CPU;
    # its launches on the card are the row's path launches
    exact = SMALL_EXACT + ("bond3", "bond4", "impr", "rep_atom")
    small, row_launches = {}, {}
    for law in scenes.MOL_LAWS:
        _build.reset_launch_counts()
        err = check_small_path(f"molecule-mode {law}", small_mol(law),
                               require_insert=True, exact=exact,
                               unsteady=ill_conditioned_impropers,
                               setpoint_rtol=1e-6)
        by = launch_counts()["pair"][1]
        small[law] = dict(max_pos_err=err, launches=by)
        row_launches.update(by)

    # ---- phase 29: path F
    t_path = time.perf_counter()
    sc = scenes.open_star_scene(device=DEV)
    cfg = sc.cfg
    metrics = make_obmd_metrics_fn(cfg)
    caps = (scenes.STAR_START_CAP, scenes.STAR_WARM_CAP)
    wcfgs = [scenes.with_cap(cfg, c) for c in caps]
    wkeys = [f"dpd-t2-excl4-cap{make_geometry(c).fcap}" for c in wcfgs]
    start_atoms, start_mols = int(sc.state.natoms), whole_molecules(
        cfg, sc.state, "path F start")[0]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    st = scenes.star_warm_up(cfg, sc.state)
    sync()
    warm_s = time.perf_counter() - t0
    warm_launches = launch_counts()
    require_launches(warm_launches, {"pair": tuple(wkeys)}, "path F warm-up")
    warm_tel = check_invariants(wcfgs[1], st)
    warm_mols = whole_molecules(cfg, st, "path F warm-up")
    m = metrics(st)
    log(f"path F warm-up: {start_atoms} beads ({start_mols} stars) -> "
        f"{warm_mols[1]} ({warm_mols[0]} stars, all whole) in "
        f"{scenes.STAR_START_STEPS} + {scenes.STAR_WARM_STEPS} steps, "
        f"{warm_s:.2f} s; buffer censuses {int(m.nbuf_left)} and "
        f"{int(m.nbuf_right)} beads, telemetry {warm_tel}, launches "
        f"{warm_launches}")
    warm_pair, _ = check_pair(wcfgs[1], make_geometry(wcfgs[1]), st,
                              "dpd, 2 types, 4-channel exclusion, cap "
                              f"{caps[1]}, path F warm-up (open x)")

    pcfg = scenes.with_cap(cfg, scenes.STAR_PROD_CAP)
    geom = make_geometry(pcfg)
    key = f"dpd-t2-excl4-cap{geom.fcap}"
    _build.reset_launch_counts()
    st = setup(pcfg, st)
    prod_start = int(st.natoms)
    occupancy = [max_cell_count(geom, st)]
    run = make_run(pcfg, OPEN_STEPS)
    windows, temps = [], []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        temps.append(float(temperature(pcfg, st)))
    launches = launch_counts()
    tel = check_invariants(pcfg, st)
    check_finite(st, "path F production")
    prod_mols = whole_molecules(pcfg, st, "path F production")
    require_launches(launches, {"pair": (key,)}, "path F production")
    if launches["pair"][0] != 2 * OPEN_STEPS + 1:
        fail(f"path F: {launches['pair'][0]} pair kernel launches for "
             f"setup and {2 * OPEN_STEPS} steps")
    for t in temps:
        if not abs(t - 1.0) <= 0.05:
            fail(f"path F production: T {t} is not within 5% of 1.0")
    wall, steps = min(windows)
    m = metrics(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right)) / cfg.obmd.mol_len
    log(f"path F production ({geom}): {steps / wall:.1f} steps/s, "
        f"{wall / steps * 1e3:.3f} ms/step, windows {windows}, beads "
        f"{prod_start} -> {prod_mols[1]} ({prod_mols[0]} stars, all whole), "
        f"T {temps}, telemetry {tel}, most atoms in one cell at setup and "
        f"after each window {occupancy} (filing cap {geom.fcap}), buffer "
        f"census {census:.1f} molecules")
    pair, _ = check_pair(pcfg, geom, st, "dpd, 2 types, 4-channel "
                         f"exclusion, cap {geom.fcap}, path F (open x)")
    near = check_exclusion(pcfg, geom, st, "pair",
                           label=f"path F cap {geom.fcap}")
    # path M starts from the production's ended state
    prod_end = (pcfg, convert.to_arrays(st), census)
    gauss = run_open_star_gaussian(pcfg, geom, st)
    prof = profile_steps(make_run(pcfg, 2 * auto_rebuild_every(pcfg)), st,
                         2 * auto_rebuild_every(pcfg))
    log(f"path F profile (production): {prof}")
    if prof is None:
        fail("path F profile: no device activity traced")

    # the insertion phase: nbuf raised to 1.05 x census / alpha at the
    # warm-up's cap, so that both buffers ask for molecules
    cfg_ins = dataclasses.replace(wcfgs[1], obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    ikey = wkeys[1]
    _build.reset_launch_counts()
    st = setup(cfg_ins, st)
    c0 = {k: int(getattr(st.obmd, k)) for k in (
        "ninserted", "ndeleted", "insert_fail", "usher_iters")}
    t0 = time.perf_counter()
    st = make_run(cfg_ins, OPEN_INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t0
    ins_launches = launch_counts()
    tel_ins = check_invariants(cfg_ins, st)
    ins = {k: int(getattr(st.obmd, k)) - v for k, v in c0.items()}
    ins_mols = whole_molecules(cfg_ins, st, "path F insertion phase")
    require_launches(ins_launches, {"pair": (ikey,)}, "path F insertion")
    if (ins["ninserted"] <= 0 or ins["ninserted"] % 5
            or ins["usher_iters"] <= 0):
        fail(f"path F insertion phase: {ins}")
    check_finite(st, "path F insertion phase")
    ins_prof = profile_steps(make_run(cfg_ins, 2), st, 2)
    log(f"path F insertion phase: nbuf {cfg_ins.obmd.nbuf:.1f}, "
        f"{ins['ninserted'] // 5} stars inserted, {ins['ndeleted']} beads "
        f"deleted, {ins['insert_fail']} insertions failed, "
        f"{ins['usher_iters']} USHER iterations in {OPEN_INS_STEPS} steps "
        f"({ins_s:.2f} s), {ins_mols[0]} stars, all whole; telemetry "
        f"{tel_ins}; profile {ins_prof}")
    path_s = time.perf_counter() - t_path

    # ---- phase 30: the 4-channel rows a-c on real states grouped into
    # stars: one-type dpd on OBMD_DPD's, lj on the open LJ fluid's, lj
    # with two types and lj/cut/rf on the charged fluid's
    rows = []
    for law, rpair, what in (
            ("dpd", None, "dpd, 1 type, OBMD_DPD's equilibrated state"),
            ("lj", None, "lj, 1 type, the open LJ fluid's ended state"),
            ("ljrf", LJCutParams.create(
                cutoff=2.5, ntypes=2, epsilon=scenes.LJRF_EPSILON,
                sigma=scenes.LJRF_SIGMA),
             "lj, 2 types, the charged fluid's ended state"),
            ("ljrf", None, "lj/cut/rf, 2 types, the charged fluid's ended "
             "state")):
        rcfg, rst = ended[law]
        figs, rkey, stars = check_row(rcfg, rst, rpair, what)
        rows.append((what, rkey, stars, figs))

    path = dict(beads_start=start_atoms, stars_start=start_mols,
                warm_up_s=warm_s, warm_up_launches=warm_launches["pair"][1],
                warm_up_telemetry=warm_tel, beads_after_warm_up=warm_mols[1],
                production_beads=[prod_start, prod_mols[1]],
                production_stars=prod_mols[0], ms_per_step=wall / steps * 1e3,
                steps_per_s=steps / wall,
                mparticle_steps_per_s=steps / wall * prod_mols[1] / 1e6,
                windows_s=[w for w, _ in windows], temps=temps,
                telemetry=tel, max_cell_count=max(occupancy),
                filing_cap=geom.fcap, buffer_census_molecules=census,
                slots_with_1_2_pair_in_cut=near, profile=prof,
                insertion=dict(nbuf=cfg_ins.obmd.nbuf, steps=OPEN_INS_STEPS,
                               stars_inserted=ins["ninserted"] // 5,
                               beads_deleted=ins["ndeleted"],
                               insert_fail=ins["insert_fail"],
                               usher_iters=ins["usher_iters"],
                               stars=ins_mols[0], seconds=ins_s,
                               telemetry=tel_ins, profile=ins_prof),
                path_s=path_s, small_paths=small, gaussian=gauss[0],
                rows={k: dict(stars=n, **f) for _, k, n, f in rows})
    kernels = [
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, cap "
                    f"{geom.fcap}, open x, path F",
                    "obmd_tpu/forces/pallas_dpd.py:575",
                    launches["pair"][1][key], pair),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, cap "
                    f"{caps[1]}, open x, path F warm-up and insertion",
                    "obmd_tpu/forces/pallas_dpd.py:324",
                    warm_launches["pair"][1][wkeys[1]]
                    + ins_launches["pair"][1][ikey], warm_pair),
        gauss[1],
    ]
    for what, rkey, stars, figs in rows:
        row = rkey.rsplit("-cap", 1)[0]
        small_key = next(k for k in row_launches
                         if k.rsplit("-cap", 1)[0] == row)
        kernels.append(kernel_line(
            "pair", f"{rkey}: {what} grouped into {stars} stars; launches: "
            f"the small molecule-mode path ({small_key})",
            "obmd_tpu/forces/pallas_dpd.py:"
            + ("575" if rkey.endswith(("-cap15", "-cap16", "-cap20"))
               else "324"), row_launches[small_key], figs))
    del sc, st
    torch.cuda.empty_cache()
    return path, kernels, prod_end


def run_open_star_gaussian(pcfg, geom, state):
    """Path F's production under gaussian pair noise (LAMMPS pair dpd's
    own: the kernel's stream, 0x7F4A7C15 with the clamp 1e-12) from the
    production's ended state at its filing cap: GAUSS_F_STEPS steps after
    setup, the row `dpd-t2-gauss-excl4-capNN` the only pair launch, T
    within 5% of 1, every star whole; the row held to its plain version.
    Returns (figures, kernel line)."""
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants
    from obmd_tpu_torch.state import temperature
    gcfg = dataclasses.replace(pcfg, pair=dataclasses.replace(
        pcfg.pair, gaussian_noise=True))
    key = f"dpd-t2-gauss-excl4-cap{geom.fcap}"
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    st = make_run(gcfg, GAUSS_F_STEPS)(setup(gcfg, state))
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    require_launches(launches, {"pair": (key,)}, "path F gaussian")
    if launches["pair"][0] != GAUSS_F_STEPS + 1:
        fail(f"path F gaussian: {launches['pair'][0]} pair launches for "
             f"setup and {GAUSS_F_STEPS} steps")
    tel = check_invariants(gcfg, st)
    check_finite(st, "path F gaussian")
    mols = whole_molecules(gcfg, st, "path F gaussian")
    temp = float(temperature(gcfg, st))
    if not abs(temp - 1.0) <= 0.05:
        fail(f"path F gaussian: T {temp} is not within 5% of 1.0")
    most = max_cell_count(geom, st)
    log(f"path F gaussian ({key}): {GAUSS_F_STEPS} steps in {wall:.2f} s "
        f"({wall / GAUSS_F_STEPS * 1e3:.3f} ms/step with setup), T {temp}, "
        f"{mols[0]} stars, all whole, telemetry {tel}, most atoms in one "
        f"cell {most} (filing cap {geom.fcap})")
    figs, _ = check_pair(gcfg, geom, st, "dpd, 2 types, gaussian noise, "
                         f"4-channel exclusion, cap {geom.fcap}, path F")
    path = dict(steps=GAUSS_F_STEPS, wall_s=wall, temp=temp, telemetry=tel,
                stars=mols[0], max_cell_count=most,
                launches=launches["pair"][1])
    return path, kernel_line(
        "pair", f"{key}: dpd, 2 types, gaussian noise, 4-channel "
        f"exclusion, cap {geom.fcap}, open x, path F under gaussian noise",
        "obmd_tpu/forces/pallas_dpd.py:575", launches["pair"][1][key], figs)


def nlist_pair_forces(cfg, state):
    """The nlist engine's pure pair forces on a state with a NeighborState
    (no boundary force), [N, 3]."""
    from obmd_tpu_torch.engine_cellpad import pair_salt
    from obmd_tpu_torch.forces.nlist import nlist_sweep
    from obmd_tpu_torch.forces.pairs import sig_scale_of
    return nlist_sweep(cfg.pair, cfg.box, state.nbrs.nlist, state.x, state.v,
                       state.type, state.tag, state.q, state.alive,
                       pair_salt(cfg, state.step), dt=cfg.dt,
                       sig_scale=sig_scale_of(cfg.pair, state.step)).f


def cross_engine_check(cfg24, st_eq):
    """Path G's first check: phase 4's equilibrated OBMD_DPD state (DPD)
    repacked at the production cap, its Verlet list built by
    rebuild_neighbors on the nlist engine; on the state's salt the list's
    forces (nlist_sweep) against the dpd-cap15 pair kernel's within 2e-4 *
    max|f| over alive slots, and the list's pure pair forces summing to
    within 1e-3 * max|f| of zero (compare_forces); no list overflow.
    Returns the max error and max|f|."""
    from bench_torch import PROD_CAP, repack
    from obmd_tpu_torch.engine_cellpad import _make_kernel, pack_fields
    from obmd_tpu_torch.integrate import rebuild_neighbors
    cfg15, geom, st = repack(cfg24, st_eq, PROD_CAP)
    cfg_n = dataclasses.replace(cfg15, force_path="nlist").finalize()
    st_n = rebuild_neighbors(cfg_n, st)
    if int(st_n.nbrs.overflow) != 0:
        fail(f"cross-engine check: Verlet list overflow "
             f"{int(st_n.nbrs.overflow)}")
    with KeepCounts():
        f_k = _make_kernel(cfg15, geom)(*pack_fields(cfg15, geom, st))
        f_n = nlist_pair_forces(cfg_n, st_n)
        sync()
    f_n = f_n.reshape(geom.n_blocks, geom.cap, geom.lanes, 3) \
        .permute(0, 3, 1, 2)
    err, scale, fsum = compare_forces(geom, st.alive, f_n, f_k,
                                      "nlist_sweep against dpd-cap15")
    log(f"cross-engine check ({int(st.natoms)} atoms): nlist_sweep against "
        f"the dpd-cap{geom.fcap} pair kernel, max_abs_err {err:.3e} (max|f| "
        f"{scale:.1f}), |sum f| {fsum:.3e}, rows up to "
        f"{int(st_n.nbrs.ncount.max())} of {cfg_n.capacity.max_neighbors}")
    return dict(max_abs_err=err, max_f=scale, sum_f=fsum)


def check_dpdext_golden():
    """validation/dpdext_golden (300 atoms, dpd/ext at T = 0) through the
    nlist engine's setup on the card: every force within 5e-5 * max|f| of
    the reference binary's dump.ref (validation/run_dpdext_golden.py's
    bar).  Returns the max error and max|f|."""
    import numpy as np
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import setup
    sc = scenes.dpdext_golden_scene(device=DEV)
    ref = scenes.golden_forces("dpdext_golden")
    with KeepCounts():
        st = setup(sc.cfg, sc.state)
        sync()
    f = st.f.cpu().numpy()
    got = {int(t): f[i] for i, t in enumerate(st.tag.tolist())
           if bool(st.alive[i])}
    if set(got) != set(ref):
        fail("dpd/ext golden: the atom ids differ from dump.ref")
    scale = max(float(np.linalg.norm(v)) for v in ref.values())
    err = max(float(np.abs(got[t] - ref[t]).max()) for t in ref)
    if not err <= 5e-5 * scale:
        fail(f"dpd/ext golden: max force error {err} > 5e-5 * {scale}")
    log(f"dpd/ext golden ({len(ref)} atoms): nlist_sweep on the card "
        f"against the reference binary's forces, max error {err:.3e} "
        f"(max|f| {scale:.1f}, bar {5e-5 * scale:.3e})")
    return dict(max_abs_err=err, max_f=scale)


def run_dpdext(cfg24, st_eq):
    """Phases 31-33: path G, the OBMD_DPD deck under pair_style dpd/ext on
    the nlist engine.  The cross-engine check and the dpd/ext golden; then
    from phase 4's equilibrated state st_eq, its atoms in a store of n_max
    slots (slots_of): setup under
    scenes.obmd_dpdext_config() (the deck's a0, gamma, cut, T and seed,
    gammaT 2.5, ws 0.8, wsT 1.3), DPDEXT_RELAX steps, two timed windows of
    DPDEXT_STEPS, a profile of two steps; the insertion phase with nbuf
    raised to 1.05 x census / alpha (INS_STEPS steps, insertions > 0);
    check_invariants, the thermal T relaxing to within 5% of 1.0 over the
    three marks, the net pair force about zero.  Launch counts are zeroed
    before setup and read after the insertion phase: the USHER kernel's
    dpd/ext rows (usher_search_dpdext), and no other kernel, on every step
    that needs atoms.  Then the USHER kernel on the insertion state's
    subsets (the nlist stage's region_subset rows) against its plain
    version (check_usher)."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.obmd.stage import insertion_subsets
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn
    cross = cross_engine_check(cfg24, st_eq)
    golden = check_dpdext_golden()
    cfg = scenes.obmd_dpdext_config()
    start = slots_of(cfg, st_eq)
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    st = setup(cfg, start)
    natoms0 = int(st.natoms)
    run = make_run(cfg, DPDEXT_RELAX)
    st = run(st)
    sync()
    probe = window_temps(cfg, None, "path G")
    probes = [probe(st)]
    run = make_run(cfg, DPDEXT_STEPS)
    windows = []
    for _ in range(2):
        s0 = st.step
        t0 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t0, st.step - s0))
        probes.append(probe(st))
    t_relax = check_thermal(probes, "path G")
    tel = check_invariants(cfg, st)
    check_finite(st, "path G")
    natoms = int(st.natoms)
    f_pair = nlist_pair_forces(cfg, st)
    scale = float(f_pair[st.alive].abs().max())
    fsum = float(f_pair[st.alive].sum(0).abs().max())
    if not fsum <= 1e-3 * scale:
        fail(f"path G: net pair force {fsum} > 1e-3 * {scale}")
    st_prod = st
    m = make_obmd_metrics_fn(cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    ins0, it0 = int(st.obmd.ninserted), int(st.obmd.usher_iters)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    iters = int(st.obmd.usher_iters) - it0
    if inserted <= 0:
        fail("path G: the insertion phase inserted no atoms")
    check_finite(st, "path G insertion phase")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    wall, steps = min(windows)
    log(f"path G ({natoms0} atoms at setup, {natoms} after the windows, "
        f"n_max {cfg.capacity.n_max}) {path_s:.1f} s, windows {windows}, "
        f"{wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, telemetry "
        f"{tel}, net pair force {fsum:.3e} (max|f| {scale:.1f}); insertion "
        f"phase: nbuf {cfg_ins.obmd.nbuf:.1f}, {inserted} inserted, {iters} "
        f"USHER iterations in {INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; "
        f"launches {launches}")
    require_launches(launches, {"usher_search_dpdext": None}, "path G")
    prof = profile_steps(make_run(cfg, 2), st_prod, 2)
    log(f"path G profile: {prof}")
    subsets = insertion_subsets(cfg_ins, st)
    scratch = scratch_figure(cfg_ins, subsets)
    usher, _ = check_usher(cfg_ins, None, st, "dpd/ext", subsets=subsets)
    usher64, usher64_info = check_usher_f64(
        cfg_ins, *map(widened, subsets), "dpd/ext")
    log(f"path G USHER: kernel {usher['ms']:.4f} ms, bound "
        f"{usher['bound_ms']:.5f} ms ({usher['bound_by']}), plain "
        f"{usher['plain_ms']:.3f} ms, scratch {scratch}")
    path = dict(atoms_at_setup=natoms0, atoms=natoms,
                n_max=cfg.capacity.n_max, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], path_s=path_s,
                telemetry=tel, thermal_temp_limit=t_relax,
                kinetic_thermal_temps=[p[1:] for p in probes],
                net_pair_force=fsum, insertion_phase_inserted=inserted,
                insertion_phase_usher_iters=iters, profile=prof,
                cross_engine=cross, golden=golden, usher_scratch=scratch,
                usher_f64=usher64_info)
    kernels = [kernel_line("usher_search_dpdext", "dpd/ext, path G", None,
                           launches["usher_search_dpdext"][0], usher),
               kernel_line("usher_search_dpdext_f64", "dpd/ext rows on path "
                           "G's insertion subsets widened to float64, "
                           "kernel-only", None, 0, usher64)]
    return path, kernels


def run_float64(cfg24, st_eq, g_path, l64):
    """Phase 43b: path O, OBMD_DPD at float64 on the nlist engine
    (obmd_dpd_config(scale=9, dtype="float64", force_path="nlist"), the
    scene's own list settings), from phase 4's equilibrated state st_eq
    widened to float64 (slots_of: exact, so paths A, G and O share one
    start).  Setup; at the start every float tensor float64, the list's
    pure pair forces against the plain pair_sweep at float64 within
    1e-10 x max|f| and summing to within 1e-10 x max|f| of zero; O_RELAX
    steps, two timed windows of O_STEPS (host clock, synchronized),
    check_invariants (no list or cell overflow), the thermal T relaxing to
    within 5% of 1.0 over the three marks (check_thermal), every float
    tensor still float64, a profile of two steps beside path G's (g_path,
    the same card); then the insertion phase with nbuf raised to 1.05 x
    census / alpha (INS_STEPS steps, insertions > 0, check_invariants).
    Launch counts are zeroed before setup and read after the insertion
    phase: the float64 USHER kernel (usher_search_f64) on every step that
    needs atoms, and no other kernel.  Then that kernel on the insertion
    state's subsets against its plain version (check_usher_f64).  l64:
    path L64's figures (its one NCCL rank's ms/step from the same start is
    logged beside this engine's)."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.integrate import (compute_forces, make_grid_spec,
                                          make_run, setup)
    from obmd_tpu_torch.obmd.stage import insertion_subsets
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn
    label = "path O"
    cfg = scenes.obmd_dpd_config(scale=O_SCALE, dtype="float64",
                                 force_path="nlist")
    start = slots_of(cfg, st_eq)
    require_float64(start, f"{label} start")
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    st = setup(cfg, start)
    require_float64(st, f"{label} after setup")
    natoms0 = int(st.natoms)
    with KeepCounts():
        f_list = nlist_pair_forces(cfg, st)
        pf, ctab = compute_forces(dataclasses.replace(cfg, obmd=None),
                                  make_grid_spec(cfg), st)
        sync()
    if int(ctab.overflow) != 0:
        fail(f"{label}: the pair sweep's cell overflow {int(ctab.overflow)}")
    alive = st.alive
    scale = float(pf.f[alive].abs().max())
    sweep_err = float((f_list - pf.f)[alive].abs().max())
    fsum = float(f_list[alive].sum(0).abs().max())
    if not (f_list.dtype == pf.f.dtype == torch.float64
            and sweep_err <= 1e-10 * scale and fsum <= 1e-10 * scale):
        fail(f"{label}: the list force against the plain pair_sweep "
             f"{sweep_err} (max|f| {scale}), |sum f| {fsum}, dtypes "
             f"{f_list.dtype}, {pf.f.dtype}")
    del pf, ctab
    st = make_run(cfg, O_RELAX)(st)
    sync()
    probe = window_temps(cfg, None, label)
    probes = [probe(st)]
    run = make_run(cfg, O_STEPS)
    windows = []
    for _ in range(2):
        s0 = st.step
        t0 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t0, st.step - s0))
        probes.append(probe(st))
    t_relax = check_thermal(probes, label)
    tel = check_invariants(cfg, st)
    check_finite(st, label)
    require_float64(st, f"{label} after the windows")
    natoms = int(st.natoms)
    st_prod = st
    m = make_obmd_metrics_fn(cfg)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=1.05 * census / cfg.obmd.alpha)).finalize()
    ins0, it0 = int(st.obmd.ninserted), int(st.obmd.usher_iters)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, INS_STEPS)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    inserted = int(st.obmd.ninserted) - ins0
    iters = int(st.obmd.usher_iters) - it0
    if inserted <= 0:
        fail(f"{label}: the insertion phase inserted no atoms")
    check_finite(st, f"{label} insertion phase")
    require_float64(st, f"{label} after the insertion phase")
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    wall, steps = min(windows)
    log(f"{label} ({natoms0} atoms at setup, {natoms} after the windows, "
        f"n_max {cfg.capacity.n_max}, float64) {path_s:.1f} s, windows "
        f"{windows}, {wall / steps * 1e3:.3f} ms/step (path G "
        f"{g_path['ms_per_step']:.3f}; path L64 (d')'s one NCCL rank of the "
        f"slab from the same start {l64['nccl_world1_ms_per_step']:.3f}), "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, telemetry "
        f"{tel}; list force against the plain pair_sweep {sweep_err:.3e}, "
        f"|sum f| {fsum:.3e} (max|f| {scale:.1f}); insertion phase: nbuf "
        f"{cfg_ins.obmd.nbuf:.1f}, {inserted} inserted, {iters} USHER "
        f"iterations in {INS_STEPS} steps ({ins_s:.2f} s), {tel_ins}; "
        f"launches {launches}")
    require_launches(launches, {"usher_search_f64": None}, label)
    prof = profile_steps(make_run(cfg, 2), st_prod, 2)
    log(f"{label} profile: {prof}; path G's: {g_path['profile']}")
    subsets = insertion_subsets(cfg_ins, st)
    usher, usher_info = check_usher_f64(cfg_ins, *subsets, "dpd, path O")
    path = dict(atoms_at_setup=natoms0, atoms=natoms,
                n_max=cfg.capacity.n_max, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                path_g_ms_per_step=g_path["ms_per_step"],
                path_l64_nccl_ms_per_step=l64["nccl_world1_ms_per_step"],
                windows_s=[w for w, _ in windows], path_s=path_s,
                telemetry=tel, thermal_temp_limit=t_relax,
                kinetic_thermal_temps=[p[1:] for p in probes],
                list_vs_sweep_max_abs_err=sweep_err, net_pair_force=fsum,
                max_f=scale, insertion_phase_inserted=inserted,
                insertion_phase_usher_iters=iters, profile=prof,
                path_g_profile=g_path["profile"], usher=usher_info)
    kernels = [kernel_line("usher_search_f64", "dpd, float64, path O", None,
                           launches["usher_search_f64"][0], usher)]
    return path, kernels


NLIST_SMALL_EXACT = ("type", "q", "tag", "alive", "mol", "bond1", "bond2",
                     "step", "maxtag", "cell_overflow", "ndeleted",
                     "ninserted", "insert_fail", "usher_iters", "rebuilds",
                     "overflow", "table", "cell_id", "nlist", "ncount",
                     "tombstone", "force_rebuild")


def small_keywords(kind):
    """make(device) of phase 34's small paths: "cellpad" the OBMD_DPD
    small deck with maxattempt 3, `local`, `vx`/`vy`/`vz`, `target` and
    `id max`; "nlist" the same deck on the nlist engine under dpd/tstat
    (every candidate taken at iteration 0) with maxattempt 2, nfreq 2,
    `gaussian` (around region5's middle, sigma 1: the other side's draws
    invalid) and `rate`; "census" the open charged fluid's small deck (two
    types) counting type 0 only, with maxattempt 2 and `global`."""
    return functools.partial(_small_keywords_make, kind)


def _small_keywords_make(kind, dev):
    from obmd_tpu_torch.config import DPDTstatParams
    v = (-1.732, 1.732)
    if kind == "census":
        cfg, st = small_ljrf(dev)
        kw = dict(maxattempt=2, group_types=(0,),
                  deposit_global=(-1.0, -0.2))
    else:
        cfg, st = small_dpd(dev)
        if kind == "cellpad":
            kw = dict(maxattempt=3, deposit_local=(0.0, 0.5, 1.0),
                      vx=v, vy=v, vz=v, target=(4.2, 5.6, 5.6),
                      id_policy="max")
        else:
            cfg = dataclasses.replace(
                cfg, force_path="nlist", pair=DPDTstatParams.create(
                    t_start=1.0, cutoff=1.0, seed=9, gamma=4.5))
            kw = dict(maxattempt=2, nfreq=2, rate=2.0,
                      gaussian=(0.6, 5.6, 5.6, 1.0))
    return dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, **kw)).finalize(), st


def drained(cfg, state, share, seed):
    """The state with a seeded `share` of the atoms in region1 and region2
    taken out (alive False, tag -1, v 0): buffers drained, as a strong
    outflow leaves them."""
    import torch
    o = cfg.obmd
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    band = state.alive & (o.region1.match(state.x) | o.region2.match(state.x))
    out = band & (torch.rand(band.shape, generator=g, device=DEV) < share)
    keep = state.alive & ~out
    return state.replace(alive=keep, tag=torch.where(keep, state.tag, -1),
                         v=torch.where(keep[:, None], state.v, 0.0))


class StageLog:
    """A draw seam that notes, on each stage call, whether a buffer needs
    atoms, the inserted count and the USHER kernel's launches before the
    call (one device read a call), then hands over the production
    draws."""

    def __init__(self, cfg):
        from obmd_tpu_torch.engine_cellpad import own_draws
        self.draw = own_draws(cfg)
        self.calls = []

    def __call__(self, state, need):
        from obmd_tpu_torch import _build
        self.calls.append((need, int(state.obmd.ninserted),
                           _build.KERNELS["usher_search"].launches))
        return self.draw(state, need)

    def per_call(self, state):
        """[(need, inserted, USHER launches)] of each call."""
        from obmd_tpu_torch import _build
        ends = self.calls[1:] + [(None, int(state.obmd.ninserted),
                                  _build.KERNELS["usher_search"].launches)]
        return [(need, n1 - n0, l1 - l0) for (need, n0, l0), (_, n1, l1)
                in zip(self.calls, ends)]


def stage_call_checks(cfg, geom, state, label):
    """One stage call of path H's insertion phase (nattempt 0, SeededDraws)
    on the card against the same call on the CPU, and against the call
    without the velocity keywords: the inserted momentum in the tally.
    Returns the figures."""
    import numpy as np
    from obmd_tpu_torch import convert
    from obmd_tpu_torch.engine_cellpad import _obmd_stage
    o = cfg.obmd
    cfg0 = dataclasses.replace(cfg, obmd=dataclasses.replace(
        o, usher=dataclasses.replace(o.usher, nattempt=0))).finalize()
    draws = SeededDraws(cfg0, H_SEED)(state, True)
    cpu = convert.from_arrays(convert.to_arrays(state), device="cpu")
    with KeepCounts():
        a = _obmd_stage(cfg0, geom, state, lambda s, n: draws)
        b = _obmd_stage(dataclasses.replace(cfg0, obmd=dataclasses.replace(
            cfg0.obmd, vx=None, vy=None, vz=None)).finalize(), geom, state,
            lambda s, n: draws._replace(vel=None))
    c = _obmd_stage(cfg0, geom, cpu, lambda s, n: draws._replace(
        **{f: None if t is None else t.cpu()
           for f, t in draws._asdict().items()}))
    ga, gc = convert.to_arrays(a), convert.to_arrays(c)
    for k in ("tag", "alive", "maxtag", "ninserted", "insert_fail",
              "ndeleted", "tag3d", "occ"):
        if not np.array_equal(ga[k], gc[k]):
            fail(f"{label}: one stage call's {k} differs from the CPU's")
    inserted = int(ga["ninserted"]) - int(state.obmd.ninserted)
    if inserted <= 0:
        fail(f"{label}: the checked stage call inserted no atoms")
    gaps = {}
    for k in ("momentum_force_left", "momentum_force_right"):
        d = float(np.abs(ga[k] - gc[k]).max())
        if not d <= 1e-5 * float(np.abs(gc[k]).max()) + 1e-3:
            fail(f"{label}: {k} differs from the CPU's by {d}")
        gaps[k] = d
    new = a.alive & ~state.alive
    mid = 0.5 * (cfg.box.lo[0] + cfg.box.hi[0])
    left = new & (a.x[:, 0] < mid)
    mass = float(cfg.masses[o.ntype])
    dt = float(np.float32(cfg.dt))
    tally = []
    for side, sel, k in ((0, left, "momentum_force_left"),
                         (1, new & ~left, "momentum_force_right")):
        pins = mass * a.v[sel].sum(0)
        want = -pins / dt
        got = getattr(a.obmd, k) - getattr(b.obmd, k)
        tol = 4e-6 * float(getattr(a.obmd, k).abs().max()) \
            + 1e-4 * float(want.abs().max()) + 1e-3
        d = float((got - want).abs().max())
        if not d <= tol or not float(pins.abs().max()) > 0.0:
            fail(f"{label}: side {side}'s setpoint less the at-rest call's "
                 f"is {got.tolist()}, not -m v / dt = {want.tolist()}")
        tally.append(dict(pins=pins.tolist(), err=d))
    log(f"{label}: one stage call (nattempt 0) inserted {inserted} (K "
        f"{o.insert_kmax}, {int(new.sum())} new slots) as on the CPU, "
        f"setpoints within {gaps}; inserted momentum in the tally {tally}")
    return dict(inserted=inserted, setpoint_gap_cpu=gaps, tally=tally)


def round_checks(cfg, geom, state, label):
    """The USHER kernel on each round of one stage call (seeded draws):
    each round's subsets with the earlier rounds' accepted candidates
    appended, held to its plain version one step at a time
    (usher_compare); the budgets are the feedback law's.  Returns the
    last round's subsets and the figures."""
    import torch
    from obmd_tpu_torch.engine_cellpad import (_region_count_sliced,
                                               _subset_slice)
    from obmd_tpu_torch.forces.usher_kernel import usher_search
    from obmd_tpu_torch.obmd.stage import (_append_subset,
                                           _sequential_accept,
                                           draw_candidates, feedback_count,
                                           rounds_of, stage_params)
    o = cfg.obmd
    k = o.insert_kmax
    pad = cfg.pair.max_cut + cfg.skin
    subs = [_subset_slice(cfg, geom, state, r, pad)
            for r in (o.region5, o.region6)]
    prm = stage_params(cfg, state)
    rem = [torch.clamp(feedback_count(
        _region_count_sliced(cfg, geom, state, r), o.mol_len, prm["alpha"],
        prm["nbuf"], prm["dt"], prm["tau"]), 0, rounds_of(cfg) * k)
        for r in (o.region1, o.region2)]
    draws = SeededDraws(cfg, H_SEED + 1)(state, True)
    ct = torch.full((k,), o.ntype, dtype=torch.int32, device=DEV)
    regions = (o.region5, o.region6)
    figs = []
    with KeepCounts():
        for r in range(rounds_of(cfg)):
            cand = [draw_candidates(cfg, draws.pos[s, r], None, regions[s],
                                    state)[0] for s in (0, 1)]
            _, _, err, checked, _ = usher_compare(
                cfg, subs[0], subs[1], cand[0], cand[1],
                f"{label}, round {r + 1}")
            pos, ok, _ = usher_search(cfg, subs[0], subs[1], *cand,
                                      *regions)
            took = []
            for s in (0, 1):
                acc, cnt = _sequential_accept(cfg, pos[s], ct, ok[s],
                                              torch.clamp(rem[s], max=k))
                rem[s] = rem[s] - cnt
                subs[s] = _append_subset(subs[s], pos[s], acc, ct,
                                         geom.n_slots)
                took.append(int(cnt))
            figs.append(dict(rows=[int(x.x.shape[0]) for x in subs],
                             taken=took, max_abs_err=err,
                             robust_steps=checked))
    log(f"{label}: the USHER kernel on each round's appended subsets "
        f"against its plain version: {figs}")
    return subs, figs


def run_keywords(cfg24, st_eq):
    """Phases 34-36: the fix's keywords at a small size, then path H from
    phase 4's equilibrated state st_eq."""
    from bench_torch import PROD_CAP, production, repack
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import (_region_count_sliced,
                                               auto_rebuild_every)
    from obmd_tpu_torch.integrate import make_run
    from obmd_tpu_torch.obmd.stage import feedback_count, stage_params
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn
    # ---- phase 34: the keywords at a small size against the CPU
    small = {}
    with KeepCounts():
        # the inserted momentum over dt enters the setpoints from a
        # float32 sum in another order on each device
        for kind, kw in (("cellpad", dict(require_insert=True,
                                          setpoint_rtol=2e-6)),
                         ("nlist", dict(require_insert=True,
                                        exact=NLIST_SMALL_EXACT,
                                        runner="step")),
                         ("census", dict(require_insert=False))):
            small[kind] = check_small_path(f"keywords {kind}",
                                           small_keywords(kind), **kw)

    # ---- phase 35: path H's production
    cfg = scenes.obmd_dpd_keywords_config()
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    cfg15, geom15, st = repack(cfg, st_eq, PROD_CAP)
    probe = window_temps(cfg15, geom15, "path H")
    probes = [probe(st)]
    st, windows, more = production(cfg15, st, probe)
    probes += more
    t_relax = check_thermal(probes, "path H")
    tel = check_invariants(cfg15, st)
    check_finite(st, "path H")
    natoms = int(st.natoms)
    prod_s = time.perf_counter() - t_path
    r_every = auto_rebuild_every(cfg15)
    r_every = max(1, r_every // cfg15.obmd.nfreq) * cfg15.obmd.nfreq
    with KeepCounts():
        prof = profile_steps(make_run(cfg15, 2 * r_every), st, 2 * r_every)
    log(f"path H profile: {prof}")

    # ---- phase 36: the insertion phase from drained buffers
    m = make_obmd_metrics_fn(cfg15)(st)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=census / cfg.obmd.alpha)).finalize()
    _, geom_ins, st = repack(cfg_ins, drained(cfg15, st, H_DRAIN, H_SEED),
                             cfg.capacity.cell_capacity)
    prm = stage_params(cfg_ins, st)
    k = cfg_ins.obmd.insert_kmax
    demand = [int(feedback_count(
        _region_count_sliced(cfg_ins, geom_ins, st, r), 1, prm["alpha"],
        prm["nbuf"], prm["dt"], prm["tau"]))
        for r in (cfg_ins.obmd.region1, cfg_ins.obmd.region2)]
    if not min(demand) > 3 * k:
        fail(f"path H: the first stage call asks for {demand}, not more "
             f"than 3 K = {3 * k} a side")
    one = stage_call_checks(cfg_ins, geom_ins, st, "path H")
    subs, rounds = round_checks(cfg_ins, geom_ins, st, "path H")
    usher, _ = check_usher(cfg_ins, geom_ins, st, "dpd, path H appended",
                           subsets=tuple(subs))
    stage_log = StageLog(cfg_ins)
    ins0 = int(st.obmd.ninserted)
    t_ins = time.perf_counter()
    st = make_run(cfg_ins, H_INS_STEPS, draw=stage_log)(st)
    sync()
    ins_s = time.perf_counter() - t_ins
    tel_ins = check_invariants(cfg_ins, st)
    check_finite(st, "path H insertion phase")
    calls = stage_log.per_call(st)
    if len(calls) != H_INS_STEPS // cfg_ins.obmd.nfreq:
        fail(f"path H: {len(calls)} stage calls in {H_INS_STEPS} steps")
    rounds_n = cfg_ins.obmd.maxattempt
    for need, n, launched in calls:
        if launched != (rounds_n if need else 0):
            fail(f"path H: a stage call (need {need}) launched the USHER "
                 f"kernel {launched} times, not {rounds_n if need else 0}")
    most = max(n for _, n, _ in calls)
    if not most > 2 * k:
        fail(f"path H: no stage call inserted more than 2 K = {2 * k} "
             f"(most {most}): rounds 2-4 never inserted")
    inserted = int(st.obmd.ninserted) - ins0
    launches = launch_counts()
    path_s = time.perf_counter() - t_path
    wall, steps = min(windows)
    log(f"path H ({natoms} atoms) production {prod_s:.1f} s, windows "
        f"{windows}, {wall / steps * 1e3:.3f} ms/step, "
        f"{steps / wall * natoms / 1e6:.3f} Mparticle-steps/s, telemetry "
        f"{tel}; insertion phase: {H_DRAIN} of the buffers drained, nbuf "
        f"{cfg_ins.obmd.nbuf:.1f}, first demand {demand}, {inserted} "
        f"inserted in {H_INS_STEPS} steps ({ins_s:.2f} s; per stage call "
        f"{[n for _, n, _ in calls]}), {tel_ins}; launches {launches}; "
        f"path {path_s:.1f} s")
    require_launches(launches, {"pair": ("dpd-cap15", "dpd-cap24"),
                                "usher_search": None}, "path H")
    path = dict(atoms=natoms, ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=steps / wall * natoms / 1e6,
                windows_s=[w for w, _ in windows], production_s=prod_s,
                path_s=path_s, telemetry=tel, thermal_temp_limit=t_relax,
                kinetic_thermal_temps=[p[1:] for p in probes], profile=prof,
                small_paths_max_pos_err=small, first_demand=demand,
                insertion_phase_inserted=inserted,
                inserted_per_stage_call=[n for _, n, _ in calls],
                usher_launches_per_stage_call=[n for _, _, n in calls],
                one_stage_call=one, rounds=rounds, insertion_s=ins_s,
                pair_launches=launches["pair"][1])
    kernels = [kernel_line("usher_search",
                           "dpd, path H: 4 rounds, appended subsets", None,
                           launches["usher_search"][0], usher)]
    return path, kernels


def film_of_stars(cfg, arrays, y_open: bool, dev, cap: int = 24):
    """A film of the warmed small star melt (arrays of an L-cube, periodic):
    the stars whose atoms, unwrapped about their first atom, all lie at z
    in [0.05, 2.15] (and with y_open at y in [0.05, L - 0.05]), in an L x
    L x 2.2 box (z one periodic cell, at least twice the cutoff; y open
    with y_open), with their bonds and impropers, at filing cap `cap`.
    Returns (cfg, state)."""
    import numpy as np
    from obmd_tpu_torch.geometry import Box
    from obmd_tpu_torch.scenes import with_cap
    from obmd_tpu_torch.state import init_state
    lz = 2.2
    L = np.asarray(cfg.box.lengths)
    alive = arrays["alive"]
    x, mol, tag = arrays["x"].astype(np.float64), arrays["mol"], arrays["tag"]
    keep = np.zeros(len(x), bool)
    pos = x.copy()
    for m in np.unique(mol[alive & (mol != 0)]):
        a = np.flatnonzero(alive & (mol == m))
        d = x[a] - x[a[0]]
        d -= L * np.round(d / L)
        p = x[a[0]] + d
        ok = (p[:, 2] >= 0.05).all() and (p[:, 2] <= lz - 0.05).all()
        if y_open:
            ok = ok and (p[:, 1] >= 0.05).all() and (p[:, 1] <= L[1] - 0.05
                                                     ).all()
        if ok:
            keep[a] = True
            pos[a] = p
    slots = np.flatnonzero(keep)
    bonds = []
    for c in ("bond1", "bond2", "bond3", "bond4"):
        col = arrays[c]
        for i in slots:
            j = int(col[i])
            if j >= 0 and tag[i] < tag[j]:
                bonds.append((tag[i], tag[j]))
    imps = [(tag[int(r[0])], tag[i], tag[int(r[1])], tag[int(r[2])])
            for i in slots for r in [arrays["impr"][i]] if r[0] >= 0]
    box = Box((0.0, 0.0, 0.0), (L[0], L[1], lz), (True, not y_open, True))
    fcfg = with_cap(dataclasses.replace(cfg, box=box, capacity=dataclasses
                                        .replace(cfg.capacity,
                                                 n_max=len(slots))), cap)
    p = pos[slots]
    p[:, 0] = np.mod(p[:, 0], L[0])
    if not y_open:
        p[:, 1] = np.mod(p[:, 1], L[1])
    return fcfg, init_state(fcfg, p, v=arrays["v"][slots],
                            types=arrays["type"][slots], tags=tag[slots],
                            mol=mol[slots], bonds=np.asarray(bonds),
                            impropers=np.asarray(imps), device=dev)


def run_small_row(cfg, state, label, ramp=False):
    """A 4-channel row on a small box: setup and EXCL4_SMALL_STEPS steps on
    the card (its launches, one key), the invariants, finite positions,
    then the row against its plain version (a ramp's at the state's step).
    Returns (launch key, launches, figures)."""
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.forces.pairs import sig_scale_of
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants
    geom = make_geometry(cfg)
    key = launch_key(geom, PairCoef.of(geom, cfg.pair, cfg.dt), 4)
    _build.reset_launch_counts()
    st = make_run(cfg, EXCL4_SMALL_STEPS)(setup(cfg, state))
    sync()
    launches = launch_counts()
    require_launches(launches, {"pair": (key,)}, label)
    tel = check_invariants(cfg, st)
    check_finite(st, label)
    figs, _ = check_pair(cfg, geom, st, f"{label} ({key})",
                         sig_scale=sig_scale_of(cfg.pair, st.step)
                         if ramp else None)
    log(f"{label} ({key}, {geom}): {int(st.natoms)} atoms, "
        f"{EXCL4_SMALL_STEPS} steps, telemetry {tel}")
    return key, launches["pair"][1][key], figs


def run_excl4_small():
    """The pair kernel's 4-channel rows under the dpd/tstat ramp and on
    thin axes, on small boxes of the warmed small star melt (307 stars,
    L = 8, two types): the closed melt under dpd/tstat with a ramp (T 1 to
    2 over 1,000 steps) at the warm-up's cap, a film whose z axis is one
    cell, then that film with y open.  Returns (figures, kernel lines)."""
    from obmd_tpu_torch.config import DPDTstatParams
    from obmd_tpu_torch import convert
    from obmd_tpu_torch.scenes import STAR_WARM_CAP, with_cap
    cfg, arrays = _small_star_start()
    ramp = DPDTstatParams.create(t_start=1.0, cutoff=1.0, seed=3, gamma=4.5,
                                 t_stop=2.0, ramp=(0, 1000), ntypes=2)
    rows = [("the small star melt under a dpd/tstat ramp", True,
             dataclasses.replace(with_cap(cfg, STAR_WARM_CAP), pair=ramp),
             convert.from_arrays(arrays, device=DEV))]
    for y_open in (False, True):
        fcfg, fst = film_of_stars(cfg, arrays, y_open, DEV)
        rows.append((f"a film of the small star melt (z one cell"
                     + (", y open)" if y_open else ")"), False, fcfg, fst))
    out, kernels = {}, []
    for what, is_ramp, rcfg, rst in rows:
        key, n, figs = run_small_row(rcfg, rst, what, ramp=is_ramp)
        out[key] = dict(what=what, atoms=int(rst.natoms), launches=n, **figs)
        kernels.append(kernel_line(
            "pair", f"{key}: {what}, {EXCL4_SMALL_STEPS} steps",
            "obmd_tpu/forces/pallas_dpd.py:"
            + ("575" if key.endswith(("-cap15", "-cap16", "-cap20"))
               else "324"), n, figs))
    return out, kernels


# the dimer and trimer of tests/test_molfrac.py
MOL_DIMER = (((-0.45, 0.0, 0.0), (0.45, 0.0, 0.0)), ((0, 1),))
MOL_TRIMER = (((-0.5, -0.15, 0.0), (0.0, 0.25, 0.0), (0.5, -0.15, 0.0)),
              ((0, 1), (1, 2)))


def small_mol_keywords(kind):
    """make(device) of the small molecule-keyword paths: "water" path I's
    stage (charged 1, shake, vx/vy/vz) on 125 waters in the 33-plane water
    box (cap 24, etarget 0), "rigid-water" path K's (rigid bodies on the
    tree template) on the same box; on a monomer gas under one-type DPD
    (10 x 4 x 4, 200 atoms, harmonic bonds K 40): "molfrac" the dimer and
    trimer at
    molfrac 0.3 / 0.7 with maxattempt 3, `orient` and vx/vy/vz with
    `target`; "deposit" the trimer with `gaussian`, `rate` and nfreq 2
    (stepped through make_step); "local" the dimer with `local` and
    maxattempt 2."""
    return functools.partial(_small_mol_keywords_make, kind)


def _small_mol_keywords_make(kind, dev):
    import numpy as np
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.config import (BondHarmonicParams, Capacity,
                                       DPDParams, MolTemplate,
                                       ObmdParams, SceneConfig,
                                       UsherParams)
    from obmd_tpu_torch.geometry import Box, RegionBlock
    from obmd_tpu_torch.state import init_state
    r = np.random.default_rng(4)
    if kind in ("water", "rigid-water"):
        rigid = kind == "rigid-water"
        cfg = scenes.open_water_config(
            planes=33, cap=24, n_max=1200, nbuf=60.0, rigid=rigid,
            usher=UsherParams(etarget=0.0, nattempt=0))
        tpl = scenes.water_template_coords()
        tpl = tpl - tpl.mean(0)
        g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * 1.1 + [0.6, 0.3, 0.3]
        x = (g[:, None] + np.einsum("sij,kj->ski",
                                    scenes._rotations(r, 125), tpl)
             ).reshape(-1, 3)
        types, q, mol, bonds = scenes._water_topology(125, tree=rigid)
        return cfg, init_state(cfg, x, v=r.normal(0.0, 0.3, x.shape),
                               types=types, q=q, mol=mol, bonds=bonds,
                               device=dev)
    dimer, trimer = (MolTemplate(dx=dx, types=(0,) * len(dx),
                                 bonds=b)
                     for dx, b in (MOL_DIMER, MOL_TRIMER))
    v = (-1.732, 1.732)
    kw = {"molfrac": dict(mol=dimer, mols=(dimer, trimer),
                          molfrac=(0.3, 0.7), maxattempt=3,
                          orient=(0.0, 0.0, 1.0), vx=v, vy=v,
                          vz=(0.0, 2.0), target=(5.0, 2.0, 2.0)),
          "deposit": dict(mol=trimer, gaussian=(1.0, 2.0, 2.0, 0.6),
                          rate=0.5, nfreq=2),
          "local": dict(mol=dimer, maxattempt=2,
                        deposit_local=(-2.0, -0.5, 0.9))}[kind]
    box = Box((0.0, 0.0, 0.0), (10.0, 4.0, 4.0), (False, True, True))
    r1 = RegionBlock((0.0, 0.0, 0.0), (2.0, 4.0, 4.0))
    r2 = RegionBlock((8.0, 0.0, 0.0), (10.0, 4.0, 4.0))
    deg = RegionBlock((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    args = dict(
        ntype=0, nfreq=1, seed=11, pxx=5.0, alpha=0.5, tau=0.01,
        nbuf=200.0, region1=r1, region2=r2, region3=deg, region4=deg,
        region5=r1, region6=r2, buffer_size=2.0,
        usher=UsherParams(etarget=40.0, nattempt=0), mol_len=2,
        insert_kmax=6)
    obmd = ObmdParams(**{**args, **kw})
    cfg = SceneConfig(
        box=box, masses=(1.0,), dt=0.01,
        pair=DPDParams.create(temp=1.0, cutoff=1.0, seed=3, a0=25.0,
                              gamma=4.5),
        capacity=Capacity(n_max=900, cell_capacity=22), obmd=obmd,
        bond=BondHarmonicParams(k=40.0, r0=0.6), skin=0.3,
        force_path="cellpad").finalize()
    x = r.uniform([1.05, 0.05, 0.05], [8.95, 3.95, 3.95], (200, 3))
    return cfg, init_state(cfg, x, v=r.normal(0.0, 1.0, x.shape),
                           device=dev)


def drained_molecules(cfg, state, share, seed):
    """The state with a seeded `share` of the molecules that have an atom in
    region1 or region2 taken out whole (alive False, tag -1, v 0)."""
    import torch
    o = cfg.obmd
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    band = state.alive & (o.region1.match(state.x) | o.region2.match(state.x))
    ids = torch.unique(state.mol[band])
    pick = ids[torch.rand(ids.shape, generator=g, device=DEV) < share]
    out = state.alive & torch.isin(state.mol, pick)
    keep = state.alive & ~out
    return state.replace(alive=keep, tag=torch.where(keep, state.tag, -1),
                         v=torch.where(keep[:, None], state.v, 0.0))


def check_water(cfg, state, label):
    """Path I's checks on a state: every molecule id holds 3 live atoms or
    none, the largest constraint error at most WATER_CONSTRAINT nm, the net
    charge within WATER_CHARGE e, finite positions, velocities and forces.
    Returns observe.molecule_report's figures."""
    import torch
    from obmd_tpu_torch.observe import molecule_report, molecule_sizes
    rep = molecule_report(cfg, state)
    sizes = molecule_sizes(state)[1:]
    if bool(((sizes != 0) & (sizes != 3)).any()) or rep["broken"]:
        fail(f"{label}: molecules not of 3 atoms: {rep}")
    if not rep["constraint_error"] <= WATER_CONSTRAINT:
        fail(f"{label}: constraint error {rep['constraint_error']} nm")
    if not abs(rep["net_charge"]) <= WATER_CHARGE:
        fail(f"{label}: net charge {rep['net_charge']}")
    check_finite(state, label)
    if not bool(torch.isfinite(state.f[state.alive]).all()):
        fail(f"{label}: non-finite forces")
    return rep


def warmed_water(cfg, state):
    """Path I's warm-up of a water scene's state: water_warm_up's melt, then
    setup and WATER_EQUIL steps of equilibrate at 2/3 kT."""
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, setup
    st = scenes.water_warm_up(cfg, state)
    return equilibrate(cfg, setup(cfg, st), WATER_EQUIL,
                       temp=scenes.WATER_THERMO_T)


def run_water():
    """Phases 37-39: path I, BASELINE config 5's open SPC/E water
    (scenes.open_water_scene: 33,212 waters, 99,636 atoms, `charged 1`,
    `shake`, USHER molecule insertion, vx/vy/vz): the lattice melted by
    water_warm_up under the stage, setup and equilibrate, an insertion
    phase on a copy whose buffers are a quarter drained (nbuf = census /
    alpha, so every stage call asks for molecules), WATER_PROD production
    steps from the warmed state in two windows, check_invariants; the checks of check_water and thermo's T
    within WATER_T_WINDOW of 2/3 kT after each window; the pair row
    ljrf-t2-excl2-cap150 against its plain version with holes and same
    bytes; then the small molecule-keyword paths against the CPU.
    Returns (figures, kernel lines, the warmed state: path K's start)."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_thermo_fn
    from obmd_tpu_torch.star_probe import census
    t_path = time.perf_counter()
    sc = scenes.open_water_scene(device=DEV)
    cfg = sc.cfg
    geom = make_geometry(cfg)
    key = launch_key(geom, PairCoef.of(geom, cfg.pair, cfg.dt), 2)
    thermo = make_thermo_fn(cfg)
    start = (int(sc.state.natoms), census(cfg, sc.state))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    st = warmed_water(cfg, sc.state)
    sync()
    warm_s = time.perf_counter() - t0
    warmed_state = st
    warm_tel = check_invariants(cfg, st)
    warm_rep = check_water(cfg, st, "path I warm-up")
    occupancy = [max_cell_count(geom, st)]
    warmed = census(cfg, st)
    log(f"path I warm-up ({geom}): {start[0]} atoms, census {start[1]} -> "
        f"{int(st.natoms)} atoms, census {warmed} molecules in "
        f"{scenes.WATER_WARM_STEPS} + {WATER_EQUIL} steps, {warm_s:.1f} s; "
        f"{warm_rep}; telemetry {warm_tel}; most atoms in one cell "
        f"{occupancy[0]}")

    # the insertion phase
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=warmed / cfg.obmd.alpha)).finalize()
    st_ins = setup(cfg_ins, drained_molecules(cfg, st, WATER_DRAIN,
                                              WATER_SEED))
    c0 = {k: int(getattr(st_ins.obmd, k)) for k in (
        "ninserted", "ndeleted", "insert_fail", "usher_iters")}
    stage_log = StageLog(cfg_ins)
    t0 = time.perf_counter()
    st_ins = make_run(cfg_ins, WATER_INS_STEPS, draw=stage_log)(st_ins)
    sync()
    ins_s = time.perf_counter() - t0
    ins_tel = check_invariants(cfg_ins, st_ins)
    ins = {k: int(getattr(st_ins.obmd, k)) - v for k, v in c0.items()}
    ins_rep = check_water(cfg_ins, st_ins, "path I insertion phase")
    needed = sum(need for need, _, _ in stage_log.calls)
    trials = 2 * cfg.obmd.insert_kmax * cfg.obmd.maxattempt * needed
    if ins["ninserted"] <= 0 or ins["ninserted"] % 3 or ins["usher_iters"] <= 0:
        fail(f"path I insertion phase: {ins}")
    if needed != WATER_INS_STEPS:
        fail(f"path I insertion phase: {needed} of {WATER_INS_STEPS} stage "
             "calls asked for molecules")
    share = ins["ninserted"] / 3 / trials
    log(f"path I insertion phase: nbuf {cfg_ins.obmd.nbuf:.1f}, "
        f"{ins['ninserted'] // 3} waters inserted of {trials} trials "
        f"({share:.4f}), {ins['ndeleted']} atoms deleted, "
        f"{ins['insert_fail']} insertions failed, {ins['usher_iters']} USHER "
        f"iterations in {WATER_INS_STEPS} steps ({ins_s:.2f} s); {ins_rep}; "
        f"telemetry {ins_tel}")

    # the production, from the warmed state (the drained copy's inflow
    # would heat it) at the warmed census
    st = setup(cfg, st)
    prod_start = int(st.natoms)
    run = make_run(cfg, WATER_PROD // 2)
    windows, temps = [], []
    for _ in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        temps.append(float(thermo(st).temp))
    launches = launch_counts()
    tel = check_invariants(cfg, st)
    rep = check_water(cfg, st, "path I production")
    for t in temps:
        if not abs(t - scenes.WATER_THERMO_T) <= \
                WATER_T_WINDOW * scenes.WATER_THERMO_T:
            fail(f"path I production: thermo's T {t} is not within "
                 f"{WATER_T_WINDOW:.0%} of 2/3 kT = {scenes.WATER_THERMO_T}")
    require_launches(launches, {"pair": (key,)}, "path I")
    wall, steps = min(windows)
    m_atoms = steps / wall * int(st.natoms) / 1e6
    log(f"path I production: {wall / steps * 1e3:.3f} ms/step, "
        f"{m_atoms:.3f} Mparticle-steps/s, windows {windows}, atoms "
        f"{prod_start} -> {int(st.natoms)}, thermo T {temps} (2/3 kT "
        f"{scenes.WATER_THERMO_T:.4f}), {rep}, telemetry {tel}, most atoms "
        f"in one cell at the warm-up's end and after each window "
        f"{occupancy} (filing cap {geom.fcap})")
    with KeepCounts():
        prof = profile_steps(make_run(cfg, 4), st, 4)
        ins_prof = profile_steps(make_run(cfg_ins, 2), st_ins, 2)
    log(f"path I profile (production): {prof}")
    log(f"path I profile (insertion phase): {ins_prof}")
    if prof is None:
        fail("path I profile: no device activity traced")
    pair, _ = check_pair(cfg, geom, st, "ljrf, 2 types, 2-channel "
                         f"exclusion, cap {geom.fcap}, path I (open x)")
    path_s = time.perf_counter() - t_path

    # the small molecule-keyword paths against the CPU
    small = {}
    with KeepCounts():
        for kind, kw in (("water", {}), ("molfrac", {}),
                         ("deposit", dict(runner="step")), ("local", {})):
            small[kind] = check_small_path(
                f"molecule keywords {kind}", small_mol_keywords(kind),
                require_insert=True, setpoint_rtol=2e-6, **kw)
    path = dict(atoms_start=start[0], census_start=start[1],
                census_warmed=warmed, warm_up_s=warm_s,
                warm_up_telemetry=warm_tel, warm_up=warm_rep,
                insertion=dict(nbuf=cfg_ins.obmd.nbuf, steps=WATER_INS_STEPS,
                               waters_inserted=ins["ninserted"] // 3,
                               trials=trials, inserted_share=share,
                               atoms_deleted=ins["ndeleted"],
                               insert_fail=ins["insert_fail"],
                               usher_iters=ins["usher_iters"],
                               seconds=ins_s, report=ins_rep,
                               telemetry=ins_tel, profile=ins_prof),
                production_atoms=[prod_start, int(st.natoms)],
                ms_per_step=wall / steps * 1e3,
                mparticle_steps_per_s=m_atoms,
                windows_s=[w for w, _ in windows], thermo_temps=temps,
                report=rep, telemetry=tel, max_cell_count=max(occupancy),
                filing_cap=geom.fcap, profile=prof, path_s=path_s,
                pair_launches=launches["pair"][1],
                small_paths_max_pos_err=small)
    kernels = [kernel_line(
        "pair", f"{key}: ljrf, 2 types, 2-channel exclusion, cap "
        f"{geom.fcap}, open x, path I (SPC/E water)",
        "obmd_tpu/forces/pallas_dpd.py:324", launches["pair"][1][key],
        pair)]
    return path, kernels, warmed_state


# ---------------------------------------------------------------------------
# path K: path I's water as rigid bodies (obmd_tpu_torch/rigid.py)
# ---------------------------------------------------------------------------

def check_rigid_water(cfg, state, label, templates=None):
    """Path K's checks on a state: every molecule id holds 3 live atoms or
    none, the bodies' largest distance error against the template (O-H and
    H-H; the stage's, or `templates` on a scene without one) at most
    RIGID_GEOMETRY nm, the net charge within WATER_CHARGE e, finite
    positions, velocities and forces.  Returns observe.molecule_report's
    figures."""
    import torch
    from obmd_tpu_torch.observe import molecule_report, molecule_sizes
    rep = molecule_report(cfg, state, templates)
    if rep["molecules"] == 0 or "rigid_error" not in rep:
        fail(f"{label}: no rigid molecule audited: {rep}")
    sizes = molecule_sizes(state)[1:]
    if bool(((sizes != 0) & (sizes != 3)).any()) or rep["broken"]:
        fail(f"{label}: molecules not of 3 atoms: {rep}")
    if not rep["rigid_error"] <= RIGID_GEOMETRY:
        fail(f"{label}: rigid bodies {rep['rigid_error']} nm off the "
             f"template (gate {RIGID_GEOMETRY})")
    if not abs(rep["net_charge"]) <= WATER_CHARGE:
        fail(f"{label}: net charge {rep['net_charge']}")
    check_finite(state, label)
    if not bool(torch.isfinite(state.f[state.alive]).all()):
        fail(f"{label}: non-finite forces")
    return rep


def check_binned_repeat(cfg, state, label, nbins: int = 450):
    """The binned observables (observe.Bins: make_profile_fn,
    profile_temperature, molecular_pxx) evaluated twice on one state give
    the same bytes.  Returns their values."""
    import torch
    from obmd_tpu_torch.observe import (make_profile_fn, molecular_pxx,
                                        profile_temperature)
    prof = make_profile_fn(cfg, nbins)
    outs = []
    for _ in range(2):
        p = prof(state)
        outs.append(([getattr(p, k).cpu() for k in p._fields],
                     profile_temperature(cfg, state, nbins).cpu(),
                     molecular_pxx(cfg, state)))
    (p0, t0, m0), (p1, t1, m1) = outs
    differ = [name for name, same in (
        ("make_profile_fn", all(torch.equal(a, b) for a, b in zip(p0, p1))),
        ("profile_temperature", torch.equal(t0, t1)),
        ("molecular_pxx", m0 == m1)) if not same]
    if differ:
        fail(f"{label}: {differ} differ between two evaluations of one "
             f"state ({t0} / {t1}, {m0} / {m1})")
    return dict(profile_temperature=float(t0), molecular_pxx=m0[0],
                atomic_pxx=m0[1], density_mean=float(p0[1].mean()))


def rigid_golden_run(dev, free):
    """validation/rigid_golden's RIGID_GOLDEN_STEPS steps on `dev` (the
    cellpad engine): {tag: (x, v)} of the live atoms."""
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import make_run, setup
    sc = scenes.rigid_golden_scene(device=dev, force_path="cellpad",
                                   free=free)
    st = make_run(sc.cfg, scenes.RIGID_GOLDEN_STEPS)(setup(sc.cfg, sc.state))
    al = st.alive.cpu().numpy()
    x, v = st.x.cpu().numpy(), st.v.cpu().numpy()
    return {int(t): (x[i], v[i]) for i, t in
            enumerate(st.tag.cpu().numpy()) if al[i]}


def check_rigid_golden():
    """validation/rigid_golden on the card (the cellpad engine, the pair
    kernel at its fill cap) against dump.ref (in.rigid's DPD law) and
    dump.rv (pair_style zero: positions and velocities) at
    run_rigid_golden.py's gates, and against the same 40 steps on the CPU.
    Returns the largest differences."""
    import numpy as np
    from obmd_tpu_torch import scenes
    out = {}
    for free in (False, True):
        ref = scenes.golden_dump("rigid_golden",
                                 "dump.rv" if free else "dump.ref")
        card = rigid_golden_run(DEV, free)
        cpu = side_take(f"rigid golden, free {free}")
        if cpu is None:
            cpu = rigid_golden_run("cpu", free)
        length = scenes.rigid_golden_scene(
            device="cpu", free=free).cfg.box.lengths[0]

        def unwrap(d):
            return d - length * np.round(d / length)
        arm = float(np.hypot(0.5, 0.4))
        pos = max(np.abs(unwrap(ref[t][:3] - card[t][0])).max() for t in ref)
        vel = (max(np.abs(ref[t][3:] - card[t][1]).max() for t in ref)
               if free else 0.0)
        arms = max(abs(np.linalg.norm(unwrap(card[3 * m + a][0]
                                             - card[3 * m + 2][0])) - arm)
                   for m in range(len(card) // 3) for a in (1, 3))
        vs_cpu = max(np.abs(unwrap(card[t][0] - cpu[t][0])).max()
                     for t in ref)
        label = "rigid golden" + (" (pair_style zero)" if free else "")
        if set(ref) != set(card) or not (
                pos < RIGID_GOLDEN_POS and vel < RIGID_GOLDEN_VEL
                and arms < RIGID_GOLDEN_ARM and vs_cpu < RIGID_GOLDEN_CPU):
            fail(f"{label}: positions {pos} from the reference's, "
                 f"velocities {vel}, arms {arms} off the template, "
                 f"{vs_cpu} from the CPU's run")
        out["free" if free else "dpd"] = dict(
            max_pos_err=float(pos), max_vel_err=float(vel),
            max_arm_err=float(arms), card_vs_cpu=float(vs_cpu))
    log(f"rigid golden on the card: {out}")
    return out


def run_rigid(warm_i, water_ms):
    """Phase 41: path K, path I's open SPC/E water (99,636 atoms) with
    rigid bodies in place of SHAKE on the tree template
    (scenes.open_water_config(rigid=True)), from path I's warmed state
    mapped by tag (scenes.rigid_water_start): setup, equilibrate
    (WATER_EQUIL) at 2/3 kT; an insertion phase on a copy with WATER_DRAIN
    of the buffers' waters taken out (nbuf = census / alpha); WATER_PROD
    production steps in two windows; after each phase check_rigid_water
    (whole waters, the bodies within RIGID_GEOMETRY nm of the template, the
    net charge, finite values) and check_invariants, and in production
    thermo's T within WATER_T_WINDOW of 2/3 kT; profiles of a production
    and an insertion step; the row ljrf-t2-excl2-cap150 against its plain
    version on path K's state (its H-H pair now in the law); the binned
    observables twice on that state (check_binned_repeat); then the rigid
    golden and the small rigid-water box against the CPU.  water_ms: path
    I's ms/step from this smoke.  Returns (figures, kernel lines, the
    production's last state)."""
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.integrate import equilibrate, make_run, setup
    from obmd_tpu_torch.observe import check_invariants, make_thermo_fn
    from obmd_tpu_torch.star_probe import census
    t_path = time.perf_counter()
    cfg = scenes.open_water_config(rigid=True)
    geom = make_geometry(cfg)
    key = launch_key(geom, PairCoef.of(geom, cfg.pair, cfg.dt), 2)
    thermo = make_thermo_fn(cfg)
    start = scenes.rigid_water_start(cfg, warm_i)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    st = setup(cfg, start)
    start_rep = check_rigid_water(cfg, st, "path K start")
    st = equilibrate(cfg, st, WATER_EQUIL, temp=scenes.WATER_THERMO_T)
    sync()
    equil_s = time.perf_counter() - t0
    equil_tel = check_invariants(cfg, st)
    equil_rep = check_rigid_water(cfg, st, "path K equilibrate")
    warmed = census(cfg, st)
    log(f"path K start ({geom}): {int(start.natoms)} atoms of path I's "
        f"warmed state, bodies {start_rep['rigid_error']:.3e} nm off the "
        f"template; after {WATER_EQUIL} steps of equilibrate "
        f"({equil_s:.1f} s, setup included) census {warmed} molecules, "
        f"{equil_rep}; telemetry {equil_tel}")

    # the insertion phase
    cfg_ins = dataclasses.replace(cfg, obmd=dataclasses.replace(
        cfg.obmd, nbuf=warmed / cfg.obmd.alpha)).finalize()
    st_ins = setup(cfg_ins, drained_molecules(cfg, st, WATER_DRAIN,
                                              WATER_SEED))
    c0 = {k: int(getattr(st_ins.obmd, k)) for k in (
        "ninserted", "ndeleted", "insert_fail", "usher_iters")}
    stage_log = StageLog(cfg_ins)
    t0 = time.perf_counter()
    st_ins = make_run(cfg_ins, WATER_INS_STEPS, draw=stage_log)(st_ins)
    sync()
    ins_s = time.perf_counter() - t0
    ins_tel = check_invariants(cfg_ins, st_ins)
    ins = {k: int(getattr(st_ins.obmd, k)) - v for k, v in c0.items()}
    ins_rep = check_rigid_water(cfg_ins, st_ins, "path K insertion phase")
    needed = sum(need for need, _, _ in stage_log.calls)
    trials = 2 * cfg.obmd.insert_kmax * cfg.obmd.maxattempt * needed
    if ins["ninserted"] <= 0 or ins["ninserted"] % 3 \
            or ins["usher_iters"] <= 0:
        fail(f"path K insertion phase: {ins}")
    if needed != WATER_INS_STEPS:
        fail(f"path K insertion phase: {needed} of {WATER_INS_STEPS} stage "
             "calls asked for molecules")
    share = ins["ninserted"] / 3 / trials
    log(f"path K insertion phase: nbuf {cfg_ins.obmd.nbuf:.1f}, "
        f"{ins['ninserted'] // 3} waters inserted of {trials} trials "
        f"({share:.4f}), {ins['ndeleted']} atoms deleted, "
        f"{ins['insert_fail']} insertions failed, {ins['usher_iters']} USHER "
        f"iterations in {WATER_INS_STEPS} steps ({ins_s:.2f} s, "
        f"{ins_s / WATER_INS_STEPS * 1e3:.1f} ms/step); {ins_rep}; "
        f"telemetry {ins_tel}")

    # the production, from the equilibrated state
    st = setup(cfg, st)
    prod_start = int(st.natoms)
    run = make_run(cfg, WATER_PROD // 2)
    windows, temps = [], []
    errors = [equil_rep["rigid_error"]]
    occupancy = [max_cell_count(geom, st)]
    for w in range(2):
        s0 = st.step
        t1 = time.perf_counter()
        st = run(st)
        sync()
        windows.append((time.perf_counter() - t1, st.step - s0))
        occupancy.append(max_cell_count(geom, st))
        temps.append(float(thermo(st).temp))
        rep = check_rigid_water(cfg, st, f"path K production window {w}")
        errors.append(rep["rigid_error"])
        log(f"path K window {w}: bodies {errors[-1]:.3e} nm off the "
            f"template (growth {errors[-1] - errors[-2]:+.3e} nm over "
            f"{WATER_PROD // 2} steps)")
    launches = launch_counts()
    tel = check_invariants(cfg, st)
    for t in temps:
        if not abs(t - scenes.WATER_THERMO_T) <= \
                WATER_T_WINDOW * scenes.WATER_THERMO_T:
            fail(f"path K production: thermo's T {t} is not within "
                 f"{WATER_T_WINDOW:.0%} of 2/3 kT = {scenes.WATER_THERMO_T}")
    require_launches(launches, {"pair": (key,)}, "path K")
    wall, steps = min(windows)
    m_atoms = steps / wall * int(st.natoms) / 1e6
    log(f"path K production: {wall / steps * 1e3:.3f} ms/step (path I "
        f"{water_ms:.3f} in this smoke), {m_atoms:.3f} Mparticle-steps/s, "
        f"windows {windows}, atoms {prod_start} -> {int(st.natoms)}, thermo "
        f"T {temps} (2/3 kT {scenes.WATER_THERMO_T:.4f}), {rep}, "
        f"telemetry {tel}, most atoms in one cell {occupancy} (filing cap "
        f"{geom.fcap})")
    with KeepCounts():
        prof = profile_steps(make_run(cfg, 4), st, 4)
        ins_prof = profile_steps(make_run(cfg_ins, 2), st_ins, 2)
    log(f"path K profile (production): {prof}")
    log(f"path K profile (insertion phase): {ins_prof}")
    if prof is None:
        fail("path K profile: no device activity traced")
    pair, _ = check_pair(cfg, geom, st, "ljrf, 2 types, 2-channel "
                         f"exclusion, cap {geom.fcap}, path K (rigid water, "
                         "H-H in the law)")
    binned = check_binned_repeat(cfg, st, "path K")
    log(f"path K binned observables, the same bytes twice: {binned}")
    path_s = time.perf_counter() - t_path

    with KeepCounts():
        golden = check_rigid_golden()
        small = check_small_path(
            "rigid water", small_mol_keywords("rigid-water"),
            require_insert=True, setpoint_rtol=2e-6)
    path = dict(atoms_start=int(start.natoms),
                start_rigid_error=start_rep["rigid_error"],
                census_equilibrated=warmed, equilibrate_s=equil_s,
                equilibrate_telemetry=equil_tel, equilibrate=equil_rep,
                insertion=dict(nbuf=cfg_ins.obmd.nbuf, steps=WATER_INS_STEPS,
                               waters_inserted=ins["ninserted"] // 3,
                               trials=trials, inserted_share=share,
                               atoms_deleted=ins["ndeleted"],
                               insert_fail=ins["insert_fail"],
                               usher_iters=ins["usher_iters"],
                               seconds=ins_s,
                               ms_per_step=ins_s / WATER_INS_STEPS * 1e3,
                               report=ins_rep, telemetry=ins_tel,
                               profile=ins_prof),
                production_atoms=[prod_start, int(st.natoms)],
                ms_per_step=wall / steps * 1e3,
                path_i_ms_per_step=water_ms,
                mparticle_steps_per_s=m_atoms,
                windows_s=[w for w, _ in windows], thermo_temps=temps,
                rigid_errors=errors, report=rep, telemetry=tel,
                max_cell_count=max(occupancy), filing_cap=geom.fcap,
                profile=prof, binned=binned, path_s=path_s,
                pair_launches=launches["pair"][1], golden=golden,
                small_path_max_pos_err=small)
    kernels = [kernel_line(
        "pair", f"{key}: ljrf, 2 types, 2-channel exclusion, cap "
        f"{geom.fcap}, open x, path K (rigid SPC/E water)",
        "obmd_tpu/forces/pallas_dpd.py:324", launches["pair"][1][key],
        pair)]
    return path, kernels, st


def run_rigid_float64(state):
    """Phase 41b: path K64, path K's rigid SPC/E water at float64 on the
    cellpad engine: path K's production end (`state`) without the OBMD
    stage (the cellpad engine runs no float64 stage, FLOAT64_STAGE), in
    open_water_config(rigid=True)'s store at float64, widened exactly
    (scenes.rigid_water_start), the waters with an atom within K64_MARGIN
    of an open x face left out.  Setup, K64_STEPS steps; no atom across an
    open x face, the bodies within RIGID_GEOMETRY of the template
    (check_rigid_water), check_invariants, every float tensor float64; the
    pair kernel launched once a step with path K's key (the dense body of
    ljrf-t2-excl2-cap150) and no other kernel, launch counts zeroed before
    setup and read after the steps; that launch on float32 fields packed
    from the float64 state against its plain version (check_pair, path
    K's bar).  Returns (figures, kernel lines)."""
    import torch
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.integrate import make_run, setup
    from obmd_tpu_torch.observe import check_invariants
    label = "path K64"
    t_path = time.perf_counter()
    k_cfg = scenes.open_water_config(rigid=True)
    water = k_cfg.obmd.templates
    cfg = dataclasses.replace(k_cfg, obmd=None, dtype="float64").finalize()
    geom = make_geometry(cfg)
    key = launch_key(geom, PairCoef.of(geom, cfg.pair, cfg.dt), 2)
    lo, hi = cfg.box.lo[0], cfg.box.hi[0]
    x0 = state.x[:, 0]
    near = state.alive & ((x0 < lo + K64_MARGIN) | (x0 > hi - K64_MARGIN))
    keep = state.alive & ~torch.isin(state.mol, state.mol[near])
    start = scenes.rigid_water_start(cfg, state.replace(alive=keep))
    require_float64(start, f"{label} start")
    _build.reset_launch_counts()
    st = setup(cfg, start)
    start_rep = check_rigid_water(cfg, st, f"{label} start", water)
    t0 = time.perf_counter()
    st = make_run(cfg, K64_STEPS)(st)
    sync()
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches(launches, {"pair": (key,)}, label)
    if launches["pair"][1][key] != K64_STEPS + 1:
        fail(f"{label}: {launches['pair']} pair launches for setup and "
             f"{K64_STEPS} steps")
    xs = st.x[st.alive, 0]
    across = int(((xs < lo) | (xs > hi)).sum())
    if across:
        fail(f"{label}: {across} atoms across an open x face")
    rep = check_rigid_water(cfg, st, label, water)
    tel = check_invariants(cfg, st)
    require_float64(st, f"{label} after the steps")
    pair, _ = check_pair(cfg, geom, st, "ljrf, 2 types, 2-channel "
                         f"exclusion, cap {geom.fcap}, float32 fields of a "
                         f"float64 state, {label} (rigid water)")
    path_s = time.perf_counter() - t_path
    natoms = int(st.natoms)
    log(f"{label}: {int(state.natoms)} atoms at path K's end, {natoms} kept "
        f"({int(state.natoms) - natoms} within {K64_MARGIN} nm of a face "
        f"left out, whole waters), {K64_STEPS} steps in {run_s:.2f} s "
        f"({run_s / K64_STEPS * 1e3:.3f} ms/step, "
        f"{K64_STEPS / run_s * natoms / 1e6:.3f} Mparticle-steps/s, setup "
        f"apart), bodies {start_rep['rigid_error']:.3e} -> "
        f"{rep['rigid_error']:.3e} nm off the template, telemetry {tel}, "
        f"launches {launches['pair']}; {path_s:.1f} s")
    path = dict(atoms_at_k_end=int(state.natoms), atoms=natoms,
                steps=K64_STEPS, ms_per_step=run_s / K64_STEPS * 1e3,
                mparticle_steps_per_s=K64_STEPS / run_s * natoms / 1e6,
                start_rigid_error=start_rep["rigid_error"], report=rep,
                telemetry=tel, path_s=path_s)
    kernels = [kernel_line(
        "pair", f"{key}: ljrf, 2 types, 2-channel exclusion, cap "
        f"{geom.fcap}, open x, float32 fields of a float64 state, path K64 "
        "(rigid SPC/E water)", "obmd_tpu/forces/pallas_dpd.py:324",
        launches["pair"][1][key], pair)]
    return path, kernels


# path J: the LAMMPS input-deck front end (obmd_tpu_torch.io.script)
# ---------------------------------------------------------------------------

# LAMMPS' own benchmark deck, the reference's code/bench/in.lj (32,000
# atoms at x = y = z = 1)
LJ_DECK = """# 3d Lennard-Jones melt

variable\tx index 1
variable\ty index 1
variable\tz index 1

variable\txx equal 20*$x
variable\tyy equal 20*$y
variable\tzz equal 20*$z

units\t\tlj
atom_style\tatomic

lattice\t\tfcc 0.8442
region\t\tbox block 0 ${xx} 0 ${yy} 0 ${zz}
create_box\t1 box
create_atoms\t1 box
mass\t\t1 1.0

velocity\tall create 1.44 87287 loop geom

pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5

neighbor\t0.3 bin
neigh_modify\tdelay 0 every 20 check no

fix\t\t1 all nve

run\t\t100
"""
LJ_DECK_T0, LJ_DECK_T100 = 1.44, (0.65, 0.85)
LJ_DECK_MIN = ("min_style fire", "minimize 0.0 1.0e-4 1000 1000")
# examples/OBMD_DPD/in.simulation's `run 2000000`, cut for the smoke
DECK_SMALL_STEPS = 2000
DECK_SMALL_EQUIL = 1000
# the scaled validation/run_ref/in.obmd: its two runs, output cadences and
# the ave/chunk bins' expected count
DECK_RUNS = (1000, 250)
DECK_DUMP_EVERY, DECK_DCD_EVERY = 500, 1000
DECK_CHUNK, DECK_THERMO = "10 10 100", 100
DECK_BINS = 450
DECK_RHO, DECK_RHO_TOL = 3.0, 0.05
# the time-dependent parameter's sample times and tolerance (relative)
TPARAM_TIMES = (0.0, 0.125, 0.37, 3.1)
TPARAM_TOL = 1e-4
# the native I/O phase: timed repeats (best of), the 11-column frame's
# tolerance against the Python frame's float32 values (%.6f rounds to half
# a unit of its last place), the C API deck's run
NATIVE_REPEATS, NATIVE_FRAME_TOL, CAPI_STEPS = 3, 5.1e-7, 100


def state_data(cfg, state):
    """A lammps_data.DataFile of the alive atoms in tag order (positions,
    velocities, types, tags)."""
    import numpy as np
    from obmd_tpu_torch.io import lammps_data
    alive = state.alive
    order = np.argsort(state.tag[alive].cpu().numpy())

    def host(t):
        return t[alive].cpu().numpy()[order]
    return lammps_data.DataFile(
        natoms=len(order), ntypes=cfg.ntypes,
        box_lo=np.asarray(cfg.box.lo), box_hi=np.asarray(cfg.box.hi),
        masses=np.asarray(cfg.masses), x=host(state.x), types=host(state.type),
        tags=host(state.tag), v=host(state.v))


def write_state_data(path, cfg, state) -> float:
    """Write state_data with the port's write_data; returns the seconds."""
    from obmd_tpu_torch.io import lammps_data
    t0 = time.perf_counter()
    lammps_data.write_data(path, state_data(cfg, state))
    return time.perf_counter() - t0


def edit_deck(text, edits):
    """edits: [(first tokens of a line, its replacement or None to drop
    it)]; each must match exactly one line of the deck."""
    lines = text.splitlines()
    for head, new in edits:
        hits = [i for i, ln in enumerate(lines)
                if ln.split()[:len(head.split())] == head.split()]
        if len(hits) != 1:
            fail(f"deck edit {head!r}: {len(hits)} matching lines")
        if new is None:
            del lines[hits[0]]
        else:
            lines[hits[0]] = new
    return "\n".join(lines) + "\n"


def thermo_rows(lines, ncols):
    """The thermo lines of a deck's log as float rows of ncols values."""
    import math
    rows = []
    for ln in lines:
        vals = ln.split()
        if len(vals) != ncols:
            continue
        try:
            row = [float(v) for v in vals]
        except ValueError:
            continue
        if not all(math.isfinite(v) for v in row):
            fail(f"deck thermo line not finite: {ln!r}")
        rows.append(row)
    return rows


def timed_lines(it, lines):
    t0 = time.perf_counter()
    it.run_lines(lines)
    sync()
    return time.perf_counter() - t0


def pair_replaces(cap):
    """The TPU body a fill cap's row ports (kernel_bigtile up to 20)."""
    return ("obmd_tpu/forces/pallas_dpd.py:575" if cap <= 20
            else "obmd_tpu/forces/pallas_dpd.py:324")


def deck_lj(tmp):
    """in.lj verbatim (32,000 atoms): T at step 0 and 100, the lj row at
    the Interpreter's cap against its plain version on the final state,
    then FIRE appended."""
    import torch
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.io.script import Interpreter
    from obmd_tpu_torch.minimize import _force_energy_fn
    path = os.path.join(tmp, "in.lj")
    with open(path, "w") as fh:
        fh.write(LJ_DECK)
    out = []
    it = Interpreter(log_fn=out.append)
    _build.reset_launch_counts()
    wall = timed_lines(it, open(path).read().splitlines())
    launches = launch_counts()
    cap = it.cfg.capacity.cell_capacity
    key = f"lj-cap{cap}"
    require_launches(launches, {"pair": (key,)}, "in.lj deck")
    rows = thermo_rows(out, 2)
    natoms = int(it.state.natoms)
    t0, t100 = rows[0][1], rows[-1][1]
    log(f"in.lj deck: {natoms} atoms, engine {it.cfg.force_path}, cap "
        f"{cap}, max_neighbors {it.cfg.capacity.max_neighbors}, thermo "
        f"{out}, {wall:.2f} s (setup included), launches {launches}")
    if natoms != 32000 or rows[0][0] != 0 or rows[-1][0] != 100:
        fail(f"in.lj deck: {natoms} atoms, thermo {out}")
    if not abs(t0 - LJ_DECK_T0) <= 1e-4 * LJ_DECK_T0:
        fail(f"in.lj deck: T {t0} at step 0, not {LJ_DECK_T0}")
    if not LJ_DECK_T100[0] <= t100 <= LJ_DECK_T100[1]:
        fail(f"in.lj deck: T {t100} at step 100 outside {LJ_DECK_T100}")
    fig, _ = check_pair(it.cfg, make_geometry(it.cfg), it.state,
                        f"in.lj deck cap {cap}")
    fe = _force_energy_fn(it.cfg.finalize())

    def rms(f):
        return float(torch.sqrt((f * f).sum() / (3 * natoms)))
    f0, pe0 = fe(it.state)
    fmax0, pe0, rms0 = float(f0.abs().max()), float(pe0), rms(f0)
    min_s = timed_lines(it, list(LJ_DECK_MIN))
    # "  minimize: N iterations, fmax F, energy E" (cmd_minimize's line)
    words = out[-1].replace(",", "").split()
    iters, fmax1, pe1 = int(words[1]), float(words[4]), float(words[6])
    st = it.state
    rms1 = rms(torch.where(st.alive[:, None], st.f, 0.0))
    log(f"in.lj deck FIRE: {iters} iterations in {min_s:.2f} s "
        f"({min_s / max(iters, 1) * 1e3:.3f} ms each), energy {pe0:.6g} "
        f"-> {pe1:.6g}, fmax {fmax0:.4g} -> {fmax1:.4g}, rms force "
        f"{rms0:.4g} -> {rms1:.4g}; log {out[-1]}")
    if not bool(torch.isfinite(st.x[st.alive]).all()):
        fail("in.lj deck FIRE: non-finite positions")
    if not (pe1 < pe0 and fmax1 * 10.0 <= fmax0):
        fail(f"in.lj deck FIRE: energy {pe0} -> {pe1}, fmax {fmax0} -> "
             f"{fmax1} (must fall, fmax at least 10x)")
    kern = kernel_line("pair", f"lj, in.lj deck, fill cap {cap}",
                       pair_replaces(cap), launches["pair"][1][key], fig)
    return dict(atoms=natoms, cap=cap, t_step0=t0, t_step100=t100,
                run_s=wall, fire_iters=iters, fire_s=min_s,
                fire_energy=[pe0, pe1], fire_fmax=[fmax0, fmax1],
                fire_rms_force=[rms0, rms1]), [kern]


def config_differences(got, want):
    """The fields in which two SceneConfigs differ in the pair law, dt,
    box, skin, the six regions and the fix's parameters: {name: (got,
    want)}."""
    diff = {}
    for f in dataclasses.fields(got.pair):
        a, b = getattr(got.pair, f.name), getattr(want.pair, f.name)
        if a != b:
            diff[f"pair.{f.name}"] = (a, b)
    for name in ("dt", "box", "skin"):
        if getattr(got, name) != getattr(want, name):
            diff[name] = (getattr(got, name), getattr(want, name))
    for f in dataclasses.fields(got.obmd):
        a, b = getattr(got.obmd, f.name), getattr(want.obmd, f.name)
        if a != b:
            diff[f"obmd.{f.name}"] = (a, b)
    return diff


def deck_small(tmp):
    """examples/OBMD_DPD/in.simulation on its own 33.6 x 11.2 x 11.2 box:
    the data file the deck reads written from obmd_dpd_scene(scale=1,
    seed=7) after equilibrate, its run cut to DECK_SMALL_STEPS; thermo
    lines, check_invariants, and its SceneConfig against
    obmd_dpd_config(scale=1), differences logged.  Returns (figures, the
    data file)."""
    from bench_torch import SEED
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import equilibrate, setup
    from obmd_tpu_torch.io.script import Interpreter
    from obmd_tpu_torch.observe import check_invariants
    sc = scenes.obmd_dpd_scene(scale=1, seed=SEED, device=DEV)
    st = equilibrate(sc.cfg, setup(sc.cfg, sc.state), DECK_SMALL_EQUIL)
    data = os.path.join(tmp, "dpd_8map_obmd.data")
    write_s = write_state_data(data, sc.cfg, st)
    here = os.path.dirname(os.path.abspath(__file__))
    src = open(os.path.join(here, "examples", "OBMD_DPD",
                            "in.simulation")).read()
    deck = os.path.join(tmp, "in.simulation")
    with open(deck, "w") as fh:
        fh.write(edit_deck(src, [
            ("read_data", f"read_data       {data}"),
            ("run", f"run             {DECK_SMALL_STEPS}")]))
    out = []
    it = Interpreter(log_fn=out.append)
    lines = open(deck).read().splitlines()
    i_run = max(i for i, ln in enumerate(lines) if ln.startswith("run"))
    it.run_lines(lines[:i_run])
    t0 = time.perf_counter()
    it._build()
    sync()
    build_s = time.perf_counter() - t0
    run_s = timed_lines(it, lines[i_run:])
    rows = thermo_rows(out, 2)
    tel = check_invariants(it.cfg, it.state)
    every = it.thermo_every
    want = sorted({0, DECK_SMALL_STEPS} | set(range(every, DECK_SMALL_STEPS,
                                                      every)))
    if [r[0] for r in rows] != want:
        fail(f"in.simulation deck: thermo lines {out}, steps {want} wanted")
    diff = config_differences(it.cfg, scenes.obmd_dpd_config(scale=1))
    log(f"in.simulation deck: {int(it.state.natoms)} atoms, engine "
        f"{it.cfg.force_path}, cap {it.cfg.capacity.cell_capacity}, "
        f"thermo {out}, setup {build_s:.2f} s, {DECK_SMALL_STEPS} steps "
        f"{run_s:.2f} s ({run_s / DECK_SMALL_STEPS * 1e3:.3f} ms/step), "
        f"telemetry {tel}; data file written in {write_s:.2f} s")
    for k, (a, b) in diff.items():
        log(f"in.simulation deck against obmd_dpd_config(scale=1): {k}: "
            f"deck {a!r}, scene {b!r}")
    return dict(atoms=int(it.state.natoms), cap=it.cfg.capacity.cell_capacity,
                ms_per_step=run_s / DECK_SMALL_STEPS * 1e3, thermo=rows,
                telemetry=tel,
                config_differences=sorted(diff)), data


def deck_time_param(tmp, data):
    """A deck whose fix obmd takes `v_p` with p = 188+60*sin(2*PI*2*time)
    (tests/test_script.py:104-142's shape, on in.simulation's regions and
    the deck-2 data): the built pxx evaluated on the card at several
    sim_time tensors against host math."""
    import math
    import torch
    from obmd_tpu_torch.io.script import Interpreter
    here = os.path.dirname(os.path.abspath(__file__))
    src = open(os.path.join(here, "examples", "OBMD_DPD",
                            "in.simulation")).read()
    text = edit_deck(src, [
        ("read_data", f"read_data       {data}"),
        ("fix 2 all obmd", "variable        p equal 188+60*sin(2*PI*2*time)\n"
         "fix             2 all obmd 1 1 7566 v_p 0.0 0.0 0.0 0.0 0.7 0.005 "
         "1327 &"),
        ("run", "run             0")])
    out = []
    it = Interpreter(log_fn=out.append)
    it.run_lines(text.splitlines())
    pxx = it.cfg.obmd.pxx
    if not callable(pxx):
        fail("time-dependent deck: pxx was not built as a function of time")
    errs = []
    for t in TPARAM_TIMES:
        got = pxx(torch.tensor(t, dtype=torch.float32, device=DEV))
        if got.device.type != torch.device(DEV).type or got.dim() != 0:
            fail(f"time-dependent deck: pxx({t}) is {got!r}")
        want = 188.0 + 60.0 * math.sin(4.0 * math.pi * t)
        errs.append(abs(float(got) - want) / abs(want))
    log(f"time-dependent deck: pxx at t = {TPARAM_TIMES} within "
        f"{max(errs):.3e} (relative) of host math; thermo {out}")
    if not max(errs) <= TPARAM_TOL:
        fail(f"time-dependent deck: pxx off by {errs} (relative)")
    return dict(times=list(TPARAM_TIMES), max_rel_err=max(errs))


def obmd_deck_text(data, cfg9, nbuf, tmp, outputs=True):
    """validation/run_ref/in.obmd 9x longer in x: x extents, the
    right-hand regions, buffersize and nbuf from obmd_dpd_config(scale=9)
    and `nbuf`, read_data from `data`; with outputs the cadences cut
    (ave/chunk DECK_CHUNK, thermo DECK_THERMO, custom thermo columns) and
    the dumps and the run-restart-run commands appended, without them
    every thermo, chunk and dump command dropped and one run of
    DECK_RUNS[0] steps."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = open(os.path.join(here, "validation", "run_ref",
                            "in.obmd")).read()
    o = cfg9.obmd
    bs, xhi = o.buffer_size, cfg9.box.hi[0]
    lyz = "0.0 11.198208286674133 0.0 11.198208286674133"
    left = f"0.0 {o.region1.hi[0]!r} {lyz}"
    right = f"{o.region2.lo[0]!r} {xhi!r} {lyz}"
    fix = [ln for ln in src.splitlines() if ln.startswith("fix             2")]
    fix = fix[0].replace(" 1327 ", f" {nbuf!r} ").replace(
        "buffersize 5.039193729003359", f"buffersize {bs!r}")
    edits = [("region leftB", f"region          leftB block {left}"),
             ("region rightB", f"region          rightB block {right}"),
             ("region leftBin", f"region          leftBin block {left}"),
             ("region rightBin", f"region          rightBin block {right}"),
             ("read_data", f"read_data       {data}"),
             ("fix 2 all obmd", fix), ("run", None)]
    if outputs:
        prof = os.path.join(tmp, "profile.out")
        edits += [("fix 3 all ave/chunk",
                   f"fix             3 all ave/chunk {DECK_CHUNK} cc "
                   f"density/number vx temp file {prof}"),
                  ("thermo", f"thermo          {DECK_THERMO}"),
                  ("thermo_style", "thermo_style    custom step temp atoms "
                   "press pxx")]
        more = [f"dump 1 all custom {DECK_DUMP_EVERY} "
                f"{os.path.join(tmp, 'deck.custom')} id type x y z vx vy vz",
                f"dump 2 all dcd {DECK_DCD_EVERY} "
                f"{os.path.join(tmp, 'deck.dcd')}",
                f"run {DECK_RUNS[0]}",
                f"write_restart {os.path.join(tmp, 'deck.restart')}",
                f"read_restart {os.path.join(tmp, 'deck.restart')}",
                f"run {DECK_RUNS[1]}",
                f"write_data {os.path.join(tmp, 'deck.final.data')}"]
    else:
        edits += [("compute cc", None), ("fix 3 all ave/chunk", None),
                  ("thermo", None), ("thermo_style", None)]
        more = [f"run {DECK_RUNS[0]}"]
    return edit_deck(src, edits) + "\n".join(more) + "\n"


def last_custom_frame(path):
    """(step, [n, 8] float32 rows id type x y z vx vy vz) of a dump custom
    file's last frame."""
    import numpy as np
    lines = open(path).read().splitlines()
    at = max(i for i, ln in enumerate(lines) if ln == "ITEM: TIMESTEP")
    step, n = int(lines[at + 1]), int(lines[at + 3])
    rows = lines[at + 9:at + 9 + n]
    if len(rows) != n:
        fail(f"dump custom: the last frame holds {len(rows)} of {n} rows")
    ids = np.asarray([int(r.split()[0]) for r in rows])
    types = np.asarray([int(r.split()[1]) for r in rows])
    vals = np.asarray([[np.float32(v) for v in r.split()[2:]] for r in rows],
                      dtype=np.float32)
    return step, ids, types, vals


def profile_blocks(path):
    """The ave/chunk file's blocks: [(step, [nbins, 3] density vx temp)]."""
    import numpy as np
    blocks = []
    lines = [ln for ln in open(path).read().splitlines()
             if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        step, nbins, _ = lines[i].split()
        rows = lines[i + 1:i + 1 + int(nbins)]
        blocks.append((int(step), np.asarray(
            [[float(v) for v in r.split()[3:]] for r in rows])))
        i += 1 + int(nbins)
    return blocks


def check_deck_frames(it, tmp, label):
    """The last custom frame and the DCD frame against the state at their
    step (slot order and tag order), bytes of float32 equal."""
    import numpy as np
    from obmd_tpu_torch.io.dump_dcd import read_dcd
    st = it.state
    alive = st.alive.cpu().numpy()
    x = st.x.cpu().numpy()[alive]
    v = st.v.cpu().numpy()[alive]
    tags = st.tag.cpu().numpy()[alive]
    step, ids, types, vals = last_custom_frame(
        os.path.join(tmp, "deck.custom"))
    if not (step == it.total_steps and np.array_equal(ids, tags)
            and np.array_equal(types, st.type.cpu().numpy()[alive] + 1)
            and np.array_equal(vals[:, :3], x)
            and np.array_equal(vals[:, 3:], v)):
        fail(f"{label}: the custom frame of step {step} differs from the "
             f"state at step {it.total_steps}")
    icntrl, cells, frames = read_dcd(os.path.join(tmp, "deck.dcd"))
    order = np.argsort(tags)
    if not (icntrl[3] == it.total_steps
            and np.array_equal(frames[-1], x[order])):
        fail(f"{label}: the DCD frame of step {icntrl[3]} differs from the "
             f"state at step {it.total_steps}")
    return dict(custom_step=step, dcd_step=icntrl[3], dcd_frames=icntrl[0])


def check_restart(it, path, label):
    """The checkpoint at `path` against the state it was written from:
    every tensor, the step and the generator state equal to the byte."""
    import torch
    from obmd_tpu_torch.io.checkpoint import _tensor_fields, load_checkpoint
    _, ld = load_checkpoint(path, device=DEV)
    st = it.state
    bad = [n for n in _tensor_fields(st)
           if (getattr(st, n) is None) != (getattr(ld, n) is None)
           or (getattr(st, n) is not None
               and not torch.equal(getattr(st, n), getattr(ld, n)))]
    bad += [f"obmd.{n}" for n in _tensor_fields(st.obmd)
            if not torch.equal(getattr(st.obmd, n), getattr(ld.obmd, n))]
    if ld.step != st.step:
        bad.append("step")
    if not torch.equal(ld.gen.get_state(), st.gen.get_state()):
        bad.append("generator state")
    if bad:
        fail(f"{label}: the restart differs from the saved state in {bad}")
    return os.path.getsize(path)


def host_copy_figures(it, tmp):
    """The seconds of one host-side sample of each output on the deck's
    state: an ave/chunk sample, a custom frame, a DCD frame and a thermo
    line."""
    out = {}
    t0 = time.perf_counter()
    it._chunk_sample(it.ave_chunks[0])
    out["chunk_sample_s"] = time.perf_counter() - t0
    cols = ("id", "type", "x", "y", "z", "vx", "vy", "vz")
    for name, style, args in (("custom_frame_s", "custom", cols),
                              ("dcd_frame_s", "dcd", ())):
        t0 = time.perf_counter()
        it._write_dump(os.path.join(tmp, f"probe.{style}"), style, args)
        out[name] = time.perf_counter() - t0
    log_fn, it.log = it.log, (lambda *a: None)
    t0 = time.perf_counter()
    it._emit_thermo()
    out["thermo_line_s"] = time.perf_counter() - t0
    it.log = log_fn
    return out


def deck_big(tmp, cfg_eq, st_eq, scene_ms):
    """validation/run_ref/in.obmd 9x longer in x (~113k atoms) from phase
    4's equilibrated state through write_data / read_data, nbuf raised so
    every stage call asks for atoms; dumps, run, write_restart,
    read_restart, run, write_data; the checks of path J; then the same
    first run with no thermo, chunk or dump command."""
    import numpy as np
    from obmd_tpu_torch import _build, scenes
    from obmd_tpu_torch.engine_cellpad import make_geometry
    from obmd_tpu_torch.io import lammps_data
    from obmd_tpu_torch.io.script import Interpreter
    from obmd_tpu_torch.observe import check_invariants, make_obmd_metrics_fn
    label = "in.obmd deck"
    data = os.path.join(tmp, "obmd_scale9.data")
    write_s = write_state_data(data, cfg_eq, st_eq)
    m = make_obmd_metrics_fn(cfg_eq)(st_eq)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    cfg9 = scenes.obmd_dpd_config(scale=9)
    nbuf = 1.05 * census / cfg9.obmd.alpha
    deck = os.path.join(tmp, "in.obmd")
    with open(deck, "w") as fh:
        fh.write(obmd_deck_text(data, cfg9, nbuf, tmp))
    lines = open(deck).read().splitlines()
    runs = [i for i, ln in enumerate(lines) if ln.startswith("run ")]
    out = []
    it = Interpreter(log_fn=out.append)
    _build.reset_launch_counts()
    read_s = timed_lines(it, lines[:runs[0]])
    t0 = time.perf_counter()
    it._build()
    sync()
    setup_s = time.perf_counter() - t0
    cap = it.cfg.capacity.cell_capacity
    n0 = int(it.state.natoms)
    run1_s = timed_lines(it, [lines[runs[0]]])
    tel1 = check_invariants(it.cfg, it.state)
    frames = check_deck_frames(it, tmp, label)
    rows1 = thermo_rows(out, 5)
    if rows1[-1][2] != int(it.state.natoms):
        fail(f"{label}: thermo counts {rows1[-1][2]} atoms, the state "
             f"{int(it.state.natoms)}")
    restart_s = timed_lines(it, [lines[runs[0] + 1]])
    restart_bytes = check_restart(it, lines[runs[0] + 1].split()[1], label)
    step_saved = it.state.step
    read_restart_s = timed_lines(it, [lines[runs[0] + 2]])
    if not (it.state.step == step_saved == it.total_steps == DECK_RUNS[0]):
        fail(f"{label}: step {it.state.step} after read_restart, "
             f"{step_saved} saved, {it.total_steps} counted")
    run2_s = timed_lines(it, [lines[runs[1]]])
    tel2 = check_invariants(it.cfg, it.state)
    if it.state.step != sum(DECK_RUNS):
        fail(f"{label}: step {it.state.step} after both runs")
    write_data_s = timed_lines(it, lines[runs[1] + 1:])
    launches = launch_counts()
    key = f"dpd-cap{cap}"
    require_launches(launches, {"pair": (key,), "usher_search": None},
                     label)
    rows = thermo_rows(out, 5)
    if rows[-1][2] != int(it.state.natoms):
        fail(f"{label}: thermo counts {rows[-1][2]} atoms, the state "
             f"{int(it.state.natoms)}")
    inserted = int(it.state.obmd.ninserted)
    if inserted <= 0:
        fail(f"{label}: no atom inserted")
    back = lammps_data.read_data(lines[-1].split()[1])
    alive = it.state.alive.cpu().numpy()
    if not (np.array_equal(back.tags, it.state.tag.cpu().numpy()[alive])
            and np.array_equal(back.x.astype(np.float32),
                               it.state.x.cpu().numpy()[alive])
            and np.array_equal(back.v.astype(np.float32),
                               it.state.v.cpu().numpy()[alive])):
        fail(f"{label}: write_data does not read back to the alive atoms")
    blocks = profile_blocks(os.path.join(tmp, "profile.out"))
    sizes = {len(b) for _, b in blocks}
    # the bulk's bins: centers outside both buffers, where the load holds
    # the fluid at its density (the buffers' outer bins run sparse)
    bs, xhi = it.cfg.obmd.buffer_size, it.cfg.box.hi[0]
    centers = (np.arange(DECK_BINS) + 0.5) * (xhi / DECK_BINS)
    bulk = (centers > bs) & (centers < xhi - bs)
    rho_all = float(np.mean([b[:, 0].mean() for _, b in blocks]))
    rho = float(np.mean([b[bulk, 0].mean() for _, b in blocks]))
    if sizes != {DECK_BINS} or not abs(rho - DECK_RHO) <= DECK_RHO_TOL * DECK_RHO:
        fail(f"{label}: profile blocks of {sizes} bins, mean density "
             f"{rho} in the {int(bulk.sum())} bulk bins ({rho_all} over "
             f"all)")
    copies = host_copy_figures(it, tmp)
    geom = make_geometry(it.cfg)
    fig_pair, _ = check_pair(it.cfg, geom, it.state, f"{label} cap {cap}")
    fig_usher, usher_more = check_usher(it.cfg, geom, it.state, label)
    # the same first run with no thermo, chunk or dump command: one run of
    # the deck's own schedule (neigh_modify's check yes, the half-skin test
    # every step), then one of a static relayout every 10 steps
    # (DECK_STATIC_SCHEDULE), each ending in the Interpreter's
    # check_invariants
    quiet = os.path.join(tmp, "in.obmd.quiet")
    with open(quiet, "w") as fh:
        fh.write(obmd_deck_text(data, cfg9, nbuf, tmp, outputs=False))
    qlines = open(quiet).read().splitlines()
    quiet_ms, quiet_tel = {}, {}
    for name, extra in (("check_yes", []),
                        ("every_10", [DECK_STATIC_SCHEDULE])):
        qi = Interpreter(log_fn=lambda *a: None)
        qi.run_lines(qlines[:-1] + extra)
        qi._build()
        sync()
        quiet_ms[name] = timed_lines(qi, qlines[-1:]) / DECK_RUNS[0] * 1e3
        quiet_tel[name] = check_invariants(qi.cfg, qi.state)
    per = [run1_s / DECK_RUNS[0] * 1e3, run2_s / DECK_RUNS[1] * 1e3]
    log(f"{label}: {n0} atoms read ({read_s:.2f} s, written by write_data "
        f"in {write_s:.2f} s), nbuf {nbuf:.1f}, engine "
        f"{it.cfg.force_path}, cap {cap}, n_max {it.cfg.capacity.n_max}, "
        f"setup {setup_s:.2f} s; run {DECK_RUNS[0]} {per[0]:.3f} ms/step, "
        f"run {DECK_RUNS[1]} {per[1]:.3f} ms/step, without outputs "
        f"{quiet_ms} ms/step, telemetry {quiet_tel} (the scene path's "
        f"production "
        f"{scene_ms:.3f}); write_restart {restart_s:.2f} s "
        f"({restart_bytes} B), read_restart {read_restart_s:.2f} s, "
        f"write_data {write_data_s:.2f} s; host copies {copies}; "
        f"{inserted} inserted, telemetry {tel1} / {tel2}; frames {frames}; "
        f"{len(blocks)} profile blocks, mean density {rho:.4f} in the "
        f"bulk's {int(bulk.sum())} bins, {rho_all:.4f} over all; thermo "
        f"{out}; launches {launches}")
    kernels = [
        kernel_line("pair", f"dpd, in.obmd deck, fill cap {cap}",
                    pair_replaces(cap), launches["pair"][1][key], fig_pair),
        kernel_line("usher_search", "dpd, in.obmd deck", None,
                    launches["usher_search"][0], fig_usher)]
    return it, dict(atoms_read=n0, atoms_end=int(it.state.natoms), cap=cap,
                n_max=it.cfg.capacity.n_max, nbuf=nbuf, inserted=inserted,
                ms_per_step=per, ms_per_step_without_outputs=quiet_ms,
                without_outputs_telemetry=quiet_tel,
                scene_ms_per_step=scene_ms, write_data_s=write_s,
                read_data_s=read_s, setup_s=setup_s,
                write_restart_s=restart_s, read_restart_s=read_restart_s,
                final_write_data_s=write_data_s, host_copies=copies,
                profile_blocks=len(blocks), mean_density_bulk=rho,
                mean_density_all=rho_all,
                frames=frames, usher=usher_more), kernels


def run_decks(cfg_eq, st_eq, scene_ms):
    """Phase 40, path J: the deck front end on the card (in.lj, the
    OBMD_DPD deck at its own size, the scaled in.obmd, a time-dependent
    fix parameter).  Returns (figures, kernel lines)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="obmd_decks_")
    try:
        wall = {}
        t0 = time.perf_counter()
        lj, lj_kernels = deck_lj(tmp)
        wall["in_lj"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small, data = deck_small(tmp)
        wall["in_simulation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tparam = deck_time_param(tmp, data)
        wall["time_param"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        it, big, big_kernels = deck_big(tmp, cfg_eq, st_eq, scene_ms)
        wall["in_obmd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = run_native(tmp, it, data)
        wall["native"] = time.perf_counter() - t0
        del it
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"path J and the native phase: {wall}")
    return dict(wall_s=wall, in_lj=lj, in_simulation=small,
                time_param=tparam, in_obmd=big,
                native=native), lj_kernels + big_kernels


def best_of(fn, repeats=NATIVE_REPEATS):
    """(the least seconds of `repeats` calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def same_datafile(a, b, label):
    """Every DataFile field equal: arrays with their dtypes, None alike."""
    import numpy as np
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(f.name)
            continue
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(f.name)
    if bad:
        fail(f"{label}: the native and Python readers differ in {bad}")


def frame_rows(path, dtype):
    """The atom rows of a custom file's one frame, parsed as `dtype`."""
    import numpy as np
    with open(path) as fh:
        head = [next(fh) for _ in range(9)]
        rows = np.loadtxt(fh, dtype=dtype, ndmin=2)
    if rows.shape[0] != int(head[3]):
        fail(f"{path}: {rows.shape[0]} rows, the frame says {head[3]}")
    return rows


def capi_session(deck):
    """The C client's calls (tests/test_c_api.py) in process, on a
    capi.Session on the card: natoms, whether the ids were 1..natoms
    (the client's ids_ok), the steps, and the final tag-ordered x and
    ids."""
    import numpy as np
    from obmd_tpu_torch.capi import Session
    s = Session(DEV)
    s.file(deck)
    n, step = s.natoms(), s.thermo("step")
    ids = np.frombuffer(s.gather_int("id"), np.int64)
    x = np.frombuffer(s.gather("x"), np.float64)
    v = np.frombuffer(s.gather("v"), np.float64) * 0.5
    s.scatter("v", v.tobytes())
    s.scatter("x", x.tobytes())
    s.command("run 5")
    return dict(natoms=n,
                ids_ok=bool(np.array_equal(ids, np.arange(1, n + 1))),
                steps=(step, s.thermo("step")),
                x=np.frombuffer(s.gather("x"), np.float64).reshape(-1, 3),
                ids=np.frombuffer(s.gather_int("id"), np.int64))


def run_native(tmp, it, data_small):
    """Phase 40b: the native reader and writers against the Python paths
    on path J's final state and deck.final.data, timed; the C API's client
    on the card against in-process sessions.  Returns the figures."""
    import numpy as np
    from obmd_tpu_torch import _build
    from obmd_tpu_torch.io import dump, lammps_data, native
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    # by path: the machine with the card has another package named tests
    spec = importlib.util.spec_from_file_location(
        "torch_capi_support", os.path.join(here, "tests",
                                           "torch_capi_support.py"))
    capi_client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(capi_client)
    label = "native phase"
    # a failed build of csrc/obmdio.cpp raises here with g++'s output
    if not native.available():
        fail(f"{label}: no C++ compiler, so no native I/O library")
    path = os.path.join(tmp, "deck.final.data")
    style = it.atom_style
    read_native_s, df_native = best_of(
        lambda: native.read_data_native(path, style))
    read_py_s, df_py = best_of(
        lambda: lammps_data.read_data(path, style, prefer_native=False))
    if df_native is None:
        fail(f"{label}: the native reader did not run")
    same_datafile(df_native, df_py, f"{label}: {path}")
    same_datafile(lammps_data.read_data(path, style), df_native,
                  f"{label}: read_data against the native reader")
    cfg, st = it.cfg, it.state
    frames = {}
    for name, write in (
            ("custom_native", lambda p: native.write_dump_custom_native(
                p, cfg, st, append=False)),
            ("custom_python", lambda p: dump._write_custom_frame_py(
                p, cfg, st, dump.NATIVE_CUSTOM_COLS, append=False)),
            ("xyz_native", lambda p: native.write_xyz_native(
                p, st, append=False)),
            ("xyz_python", lambda p: dump._write_xyz_frame_py(
                p, cfg, st, append=False))):
        out = os.path.join(tmp, f"frame.{name}")
        secs, ok = best_of(lambda: write(out))
        if ok is False:
            fail(f"{label}: the native writer refused {out}")
        frames[name] = (out, secs)
    nat = frame_rows(frames["custom_native"][0], np.float64)
    pyt = frame_rows(frames["custom_python"][0], np.float32).astype(
        np.float64)
    frame_err = float(np.abs(nat[:, 2:] - pyt[:, 2:]).max())
    if not (nat.shape == pyt.shape and np.array_equal(nat[:, :2], pyt[:, :2])
            and frame_err <= NATIVE_FRAME_TOL):
        fail(f"{label}: the 11-column frames differ: shapes {nat.shape} / "
             f"{pyt.shape}, largest float difference {frame_err}")
    with open(frames["xyz_native"][0], "rb") as a, \
            open(frames["xyz_python"][0], "rb") as b:
        if a.read() != b.read():
            fail(f"{label}: the native and Python xyz frames differ")

    # the C API on the card: the client in a subprocess, OBMD_PLATFORM unset
    src = open(os.path.join(here, "examples", "OBMD_DPD",
                            "in.simulation")).read()
    deck = os.path.join(tmp, "in.simulation.capi")
    with open(deck, "w") as fh:
        fh.write(edit_deck(src, [
            ("read_data", f"read_data       {data_small}"),
            ("run", f"run             {CAPI_STEPS}")]))
    t0 = time.perf_counter()
    exe = capi_client.build_client(str(_build.capi_library()), tmp)
    client_build_s = time.perf_counter() - t0
    xbin = os.path.join(tmp, "capi_x.bin")
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("OBMD_PLATFORM", None)
    t0 = time.perf_counter()
    p = subprocess.run([exe, deck, xbin], env=env, capture_output=True,
                       text=True, timeout=600)
    client_s = time.perf_counter() - t0
    if p.returncode != 0:
        fail(f"{label}: the C client exited {p.returncode}: "
             f"{p.stderr[-2000:]}")
    line = capi_client.parse_client_line(p.stdout)
    xc, idc = capi_client.read_client_dump(xbin)
    runs = [capi_session(deck) for _ in range(2)]
    r = runs[0]
    # the client's ids_ok asks for ids 1..natoms: on this open deck it holds
    # only while no atom has left, as the in-process gather shows
    if not (line["natoms"] == str(r["natoms"])
            and line["step"] == str(CAPI_STEPS)
            and line["ids_ok"] == str(int(r["ids_ok"]))
            and line["v_ok"] == "1"
            and line["step2"] == str(CAPI_STEPS + 5)
            and r["steps"] == (CAPI_STEPS, CAPI_STEPS + 5)):
        fail(f"{label}: the C client printed {line}; in process "
             f"{r['natoms']} atoms, ids 1..natoms {r['ids_ok']}, steps "
             f"{r['steps']}")
    x1, x2 = runs[0]["x"], runs[1]["x"]
    if not (xc.shape == x1.shape == x2.shape
            and np.array_equal(idc, runs[0]["ids"])
            and np.array_equal(idc, runs[1]["ids"])
            and bool(np.all(np.diff(idc) > 0))):
        fail(f"{label}: final atoms: client {xc.shape[0]}, in process "
             f"{x1.shape[0]} and {x2.shape[0]}, or their ids differ")
    n = r["natoms"]
    runs_equal = x1.tobytes() == x2.tobytes()
    spread = float(np.abs(x1 - x2).max())
    client_err = float(np.abs(xc - x1).max())
    if runs_equal and xc.tobytes() != x1.tobytes():
        fail(f"{label}: the in-process runs agree to the byte, the C "
             f"client differs by {client_err}")
    if not client_err <= spread:
        fail(f"{label}: the C client differs from the in-process run by "
             f"{client_err}, above the two in-process runs' {spread}")
    host_build = {lib.name: lib.build_seconds
                  for lib in _build.HOST_LIBRARIES.values()}
    out = dict(atoms=df_py.natoms, read_native_s=read_native_s,
               read_python_s=read_py_s,
               custom_native_s=frames["custom_native"][1],
               custom_python_s=frames["custom_python"][1],
               custom_frame_max_err=frame_err,
               xyz_native_s=frames["xyz_native"][1],
               xyz_python_s=frames["xyz_python"][1],
               capi_atoms=n, capi_ids_contiguous=r["ids_ok"],
               capi_client_s=client_s,
               capi_client_build_s=client_build_s,
               capi_in_process_equal=runs_equal,
               capi_in_process_spread=spread, capi_client_err=client_err,
               host_build_s=host_build)
    log(f"{label}: {out}; client line {line}")
    print("native " + json.dumps(out), flush=True)
    return out


def slots_of(cfg, state):
    """The live atoms of a state (a cellpad layout's slots are padded
    beyond n_max) in a fresh store of cfg's n_max slots, in tag order, with
    their velocities, tags, step, time and counters, in cfg's dtype (a
    float32 state widened to a float64 scene's exactly)."""
    import torch
    from obmd_tpu_torch.state import init_state
    alive = state.alive
    order = torch.argsort(state.tag[alive])
    out = init_state(cfg, state.x[alive][order].cpu().numpy(),
                     v=state.v[alive][order].cpu().numpy(),
                     tags=state.tag[alive][order].cpu().numpy(),
                     device=state.device)
    obmd = dataclasses.replace(state.obmd, **{
        f.name: getattr(state.obmd, f.name).to(out.dtype)
        for f in dataclasses.fields(state.obmd)
        if getattr(state.obmd, f.name).is_floating_point()})
    return out.replace(step=state.step,
                       sim_time=state.sim_time.to(out.dtype, copy=True),
                       maxtag=state.maxtag.clone(), obmd=obmd)


def scratch_figure(cfg, subsets):
    """The USHER kernel's scratch (int32 words) at these subsets' rows."""
    from obmd_tpu_torch.forces.usher_kernel import UsherPlan, scratch_words
    o = cfg.obmd
    plan = UsherPlan.of(cfg, o.region5, o.region6)
    return dict(rows=[s.x.shape[0] for s in subsets],
                valid=[int(s.valid.sum()) for s in subsets],
                words=scratch_words(plan.grids, *(s.x.shape[0]
                                                   for s in subsets)))


# path L: the multi-device steps (obmd_tpu_torch/parallel) on the one card,
# four gloo ranks sharing it (NCCL refuses two ranks on one device)
SLAB_WORLD = 4
SLAB_CHECK_STEPS = 10       # (a) the gathered slab against the sweep engine
SLAB_KERNEL_STEPS = 3       # (b) the kernel slab against the gathered at T 0
SLAB_WARM, SLAB_PROD = 20, 60     # (c) production through the kernel
SLAB_NCCL_STEPS = 30        # (d) one NCCL rank beside the cellpad engine
ATOM_STEPS = 10             # (e) the atom decomposition, on the slab's ranks
L64_PROD = 30               # (c') path L64's production through the kernel
L64_NCCL_STEPS = 20         # (d') its one NCCL rank
# (a') path L64's gathered slab at float64 against the nlist engine at
# float64: positions by tag within this x Ly
L64_X_REL = 1e-8
# (a) and (b) search with nattempt 0 at this etarget (unmoved candidates
# pass in the liquid): a 40-iteration USHER verdict at the etarget gate
# hangs on the float32 order of the sums over the ranks
SLAB_ETARGET = 60.0
SLAB_SEED = 11
SLAB_SCALE = 9.0
RANK_TIMEOUT_S = 300.0


def replay_draws(cfg, n_calls, seed):
    """Uniform draws for n_calls stage calls, one entry each (ranks.
    ReplayDraws), so that two engines that call the seam on every stage
    call take the same candidates whatever their demand: the positions'
    (in MOLECULE mode the centre's and the rotation axis's and angle's)
    and, where their keywords are set, the deposit z's and the
    velocities' (obmd.stage.draw_shapes; template 0 in MOLECULE mode)."""
    import torch
    from obmd_tpu_torch.engine_cellpad import mol_mode
    from obmd_tpu_torch.obmd.stage import draw_shapes, rounds_of
    shapes = draw_shapes(cfg, rounds_of(cfg), cfg.obmd.insert_kmax,
                         7 if mol_mode(cfg) else 3)
    g = torch.Generator().manual_seed(seed)
    real = getattr(torch, cfg.dtype)
    return [{k: None if shapes[k] is None
             else torch.rand(shapes[k], generator=g, dtype=real).numpy()
             for k in ("pos", "z", "vel")} for _ in range(n_calls)]


def widened_arrays(arrays):
    """A global state's arrays (convert.to_arrays) with every float array
    cast to float64, exactly: a float64 path's start from a float32
    one's."""
    import numpy as np
    return {k: np.asarray(v, np.float64)
            if np.issubdtype(np.asarray(v).dtype, np.floating) else v
            for k, v in arrays.items()}


def require_float64_arrays(arrays, label):
    """Every float array of a global state (convert.to_arrays) is
    float64."""
    import numpy as np
    narrow = {k: str(np.asarray(v).dtype) for k, v in arrays.items()
              if np.issubdtype(np.asarray(v).dtype, np.floating)
              and np.asarray(v).dtype != np.float64}
    if narrow or arrays["x"].dtype != np.float64:
        fail(f"{label}: float arrays not float64: {narrow}")


def by_tag(arrays):
    a = arrays["alive"]
    return dict(zip(arrays["tag"][a].tolist(), arrays["x"][a]))


def same_atoms(got, ref, tol, label, counters=("ndeleted", "ninserted")):
    """Two global states hold the same atoms: natoms, the counters and the
    tag sets equal, positions by tag within tol.  Returns the largest
    position difference."""
    import numpy as np
    for k in ("alive",) + tuple(counters):
        a = int(np.sum(got[k])) if k == "alive" else int(got[k])
        b = int(np.sum(ref[k])) if k == "alive" else int(ref[k])
        if a != b:
            fail(f"{label}: {k} {a} against {b}")
    m1, m2 = by_tag(got), by_tag(ref)
    if set(m1) != set(m2):
        fail(f"{label}: tag sets differ ({len(set(m1) ^ set(m2))} tags)")
    diff = max(float(np.abs(m1[t] - m2[t]).max()) for t in m1)
    if not diff <= tol:
        fail(f"{label}: positions by tag differ by {diff} > {tol}")
    return diff


def check_slab_fields(cfg, pg, fields, label):
    """The slab's pair-kernel launch (its key on pad geometry pg, with the
    partner-tag channels where the fields have them) on rank 0's filed
    owned + halo rows against its plain version (check_pair_inputs).
    Returns (its launch key, its figures)."""
    import torch
    from obmd_tpu_torch.engine_cellpad import pair_salt
    from obmd_tpu_torch.forces.pair_kernel import (PairCoef, launch_key,
                                                   make_pair_kernel)
    fld = torch.from_numpy(fields["fld"]).to(DEV)
    pbond = fields.get("pbond")
    n_excl = 0 if pbond is None else pbond.shape[1]
    coef = PairCoef.of(pg, cfg.pair, cfg.dt)
    key = launch_key(pg, coef, n_excl)
    alive = (fld[:, 0] < 0.5e8).reshape(-1)
    log(f"{label}: {key}, {pg.dims} cells, {pg.n_blocks} blocks, "
        f"{int(alive.sum())} filed rows")
    kern = make_pair_kernel(pg, cfg.pair, cfg.dt, exclude_bonded=n_excl > 0,
                            **({"n_excl": n_excl} if n_excl else {}))
    figures, _ = check_pair_inputs(
        pg, coef, kern,
        (fld, torch.from_numpy(fields["tag"]).to(DEV),
         pair_salt(cfg, fields["step"]),
         torch.from_numpy(fields["occ"]).to(DEV),
         None if pbond is None else torch.from_numpy(pbond).to(DEV)),
        alive, label)
    return key, figures


def rank_sum(res, i, key, path="path L"):
    """Launches of pair-kernel key `key` in run i, summed over the ranks,
    after checking that no rank launched any other kernel or key."""
    n = 0
    for r in res:
        got = r[i]["launches"]
        if set(got) - {"pair"} or set(got.get("pair", {})) - {key}:
            fail(f"{path}: a rank launched {got}, expected only pair {key}")
        n += got.get("pair", {}).get(key, 0)
    return n


def check_slab_production(res, i, start, label, sizes=None):
    """Run i of a multi-rank call, a production through the kernel: no
    overflow beyond the start's, every live atom inside its rank's slab
    (beyond-face atoms on the edge ranks excepted), tags unique, every rank
    drew the same numbers, finite positions; with `sizes` the molecules
    whole (tag_molecules).  Returns (the global state, its atoms, its
    molecules or None)."""
    import numpy as np
    fin = res[0][i]["state"]
    if int(fin["cell_overflow"]) != int(start["cell_overflow"]):
        fail(f"{label}: cell overflow {int(fin['cell_overflow'])}")
    outside = [r[i]["outside"] for r in res]
    if any(outside):
        fail(f"{label}: live atoms outside their rank's slab {outside}")
    tags = fin["tag"][fin["alive"]]
    if len(np.unique(tags)) != len(tags):
        fail(f"{label}: a tag is live on two ranks")
    if not all(r[i]["same_draws"] for r in res):
        fail(f"{label}: the ranks drew different numbers")
    if not np.isfinite(fin["x"][fin["alive"]]).all():
        fail(f"{label}: non-finite positions")
    mols = None if sizes is None else tag_molecules(fin, sizes, label)
    return fin, int(fin["alive"].sum()), mols


def run_slab(cfg24, st_eq):
    """Phase 42: path L, the multi-device steps on the card
    (obmd_tpu_torch/parallel, the ranks started by parallel.comm.Launch
    with the kernels built beforehand).  From phase 4's equilibrated OBMD_DPD
    state in a store of n_max slots (slots_of), scale SLAB_SCALE (9):
      (a) SLAB_WORLD gloo ranks, the gathered slab step against the sweep
          engine in this process, SLAB_CHECK_STEPS steps at the insertion
          phase's nbuf (1.05 x census / alpha) with the same replayed
          draws (nattempt 0 at SLAB_ETARGET): natoms, ndeleted, ninserted
          (> 0), the tag sets equal, positions by tag within 1e-4, no
          overflow;
      (b) at temperature 0 the kernel slab step against the gathered one,
          SLAB_KERNEL_STEPS steps each from the same start: the same atoms,
          positions by tag within 1e-5;
      (c) production at the deck's nbuf and temperature (USHER at its
          nattempt 40, the state's own draws): SLAB_WARM steps, then
          SLAB_PROD timed; no overflow, every live atom inside its rank's
          slab (beyond-face atoms on the edge ranks excepted), tags unique,
          every rank drew the same numbers, the pair kernel launched once a
          step on each rank with the slab's key and no other kernel; the
          slab's launch on rank 0's last filed rows against its plain
          version (check_slab_fields);
      (d) one NCCL rank, the same production for SLAB_NCCL_STEPS steps
          (the one-rank slab's key held the same way), beside the cellpad
          engine's ms/step over as many steps from the same start;
      (e) the same SLAB_WORLD gloo ranks after (a)-(c) (one spawn), the
          atom decomposition on OBMD_DPD at scale 1 (the nlist engine's
          setup) against the nlist engine in this
          process, ATOM_STEPS steps on replayed draws: counters equal,
          positions by tag within 2e-3.
    Path L64, the same start widened to float64 exactly (slots_of), on the
    same ranks:
      (a') the gathered slab at float64 against the nlist engine at float64
           in this process, SLAB_CHECK_STEPS steps on the same replayed
           float64 draws (nattempt 0 at SLAB_ETARGET): the counters and the
           tag sets equal, positions by tag within L64_X_REL x Ly;
      (c') production through the kernel at float64 (float32 kernel fields
           from the float64 state): SLAB_WARM steps, then L64_PROD timed,
           with (c)'s checks, every float array float64 at the end, and
           the launch on rank 0's filed rows against its plain version;
      (d') the same on the one NCCL rank for L64_NCCL_STEPS steps (path O,
           the nlist engine at float64 from the same start, logs its
           ms/step beside this one's).
    Launch counts of the main path are the ranks' own over (c) and (c').
    A generator (run_multi_rank drives it): it yields its rank tasks for
    the four gloo ranks and the one NCCL rank, which path M's share, and is
    sent their results and the calls' seconds."""
    import torch
    from obmd_tpu_torch import convert, scenes
    from obmd_tpu_torch.config import DPDParams
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.integrate import (make_run, make_step,
                                          rebuild_neighbors, setup)
    from obmd_tpu_torch.observe import make_obmd_metrics_fn
    from obmd_tpu_torch.parallel.ranks import (ReplayDraws, atom_runs,
                                               slab_runs)
    from obmd_tpu_torch.parallel.slab_decomp import make_slab_geom
    t_path = time.perf_counter()
    deck = scenes.obmd_dpd_config(scale=SLAB_SCALE, force_path="sweep")
    keys = {w: launch_key(make_slab_geom(deck, w).pad_geom,
                          PairCoef.of(make_slab_geom(deck, w).pad_geom,
                                      deck.pair, deck.dt), 0)
            for w in (SLAB_WORLD, 1)}
    m = make_obmd_metrics_fn(deck)(st_eq)
    census = 0.5 * (int(m.nbuf_left) + int(m.nbuf_right))
    o = deck.obmd
    cfg_ins = dataclasses.replace(deck, obmd=dataclasses.replace(
        o, nbuf=1.05 * census / o.alpha, usher=dataclasses.replace(
            o.usher, nattempt=0, etarget=SLAB_ETARGET))).finalize()
    cfg_t0 = dataclasses.replace(cfg_ins, pair=DPDParams.create(
        temp=0.0, cutoff=1.0, seed=deck.pair.seed, a0=209.6,
        gamma=4.5)).finalize()
    start = slots_of(deck, st_eq)
    arrays = convert.to_arrays(start)
    natoms0 = int(start.natoms)
    draws = replay_draws(cfg_ins, SLAB_CHECK_STEPS, SLAB_SEED)

    # (a)'s reference: the sweep engine on the same start and draws
    t0 = time.perf_counter()
    with KeepCounts():
        ref = convert.from_arrays(arrays, seed=SLAB_SEED, device=DEV)
        step = make_step(cfg_ins, ReplayDraws(draws))
        for _ in range(SLAB_CHECK_STEPS):
            ref = step(ref)
        sync()
    sweep_s = time.perf_counter() - t0
    ref = convert.to_arrays(ref)
    del step
    # L64: the same start widened to float64; (a')'s reference, the nlist
    # engine at float64 on the same replayed float64 draws
    deck64 = dataclasses.replace(deck, dtype="float64").finalize()
    ins64 = dataclasses.replace(cfg_ins, dtype="float64").finalize()
    start64 = slots_of(deck64, st_eq)
    require_float64(start64, "path L64 start")
    arrays64 = convert.to_arrays(start64)
    del start64
    draws64 = replay_draws(ins64, SLAB_CHECK_STEPS, SLAB_SEED)
    nl64 = dataclasses.replace(
        scenes.obmd_dpd_config(scale=SLAB_SCALE, dtype="float64",
                               force_path="nlist"),
        obmd=ins64.obmd).finalize()
    t0 = time.perf_counter()
    with KeepCounts():
        ref64 = rebuild_neighbors(nl64, convert.from_arrays(
            arrays64, seed=SLAB_SEED, device=DEV))
        step = make_step(nl64, ReplayDraws(draws64))
        for _ in range(SLAB_CHECK_STEPS):
            ref64 = step(ref64)
        sync()
    nlist64_s = time.perf_counter() - t0
    require_float64(ref64, "path L64 (a') the nlist engine")
    ref64 = convert.to_arrays(ref64)
    del step
    torch.cuda.empty_cache()
    runs = [
        dict(cfg=cfg_ins, arrays=arrays, seed=SLAB_SEED,
             steps=SLAB_CHECK_STEPS, draws=draws),
        dict(cfg=cfg_t0, arrays=arrays, seed=SLAB_SEED,
             steps=SLAB_KERNEL_STEPS, draws=draws),
        dict(cfg=cfg_t0, arrays=arrays, seed=SLAB_SEED,
             steps=SLAB_KERNEL_STEPS, draws=draws, force_impl="kernel"),
        dict(cfg=deck, arrays=arrays, seed=SLAB_SEED, warm=SLAB_WARM,
             steps=SLAB_PROD, force_impl="kernel", fields=True),
        dict(cfg=ins64, arrays=arrays64, seed=SLAB_SEED,
             steps=SLAB_CHECK_STEPS, draws=draws64),
        dict(cfg=deck64, arrays=arrays64, seed=SLAB_SEED, warm=SLAB_WARM,
             steps=L64_PROD, force_impl="kernel", fields=True)]
    # (e)'s reference: the nlist engine on OBMD_DPD at scale 1
    sa = scenes.obmd_dpd_scene(scale=1.0, seed=7, force_path="nlist",
                               device=DEV)
    n_max = sa.cfg.capacity.n_max // SLAB_WORLD * SLAB_WORLD
    sa = scenes.obmd_dpd_scene(scale=1.0, seed=7, force_path="nlist",
                               n_max=n_max, device=DEV)
    with KeepCounts():
        st = setup(sa.cfg, sa.state)
        a_arrays = convert.to_arrays(st)
        e_draws = replay_draws(sa.cfg, ATOM_STEPS, SLAB_SEED)
        step = make_step(sa.cfg, ReplayDraws(e_draws))
        for _ in range(ATOM_STEPS):
            st = step(st)
        sync()
    e_ref = convert.to_arrays(st)
    del st, step
    # the atom decomposition's run rides in the same spawn, after the
    # slab's; (d)'s in the one-rank spawn
    own_s = time.perf_counter() - t_path
    both, res1, spawn_s, d_spawn_s = yield (
        [(slab_runs, (runs,)), (atom_runs, ([dict(
            cfg=sa.cfg, arrays={k: v for k, v in a_arrays.items()
                                if k not in ("nlist", "xref")},
            seed=SLAB_SEED, steps=ATOM_STEPS, draws=e_draws)],))],
        [(slab_runs, ([dict(cfg=deck, arrays=arrays, seed=SLAB_SEED, warm=5,
                            steps=SLAB_NCCL_STEPS, force_impl="kernel",
                            fields=True),
                       dict(cfg=deck64, arrays=arrays64, seed=SLAB_SEED,
                            warm=5, steps=L64_NCCL_STEPS, force_impl="kernel",
                            fields=True)],))])
    t_path = time.perf_counter()
    res = [b[0] for b in both]
    res2 = [b[1] for b in both]
    r0 = res[0]
    # (a)
    got = r0[0]["state"]
    if int(got["ninserted"]) <= int(arrays["ninserted"]) \
            or int(got["ndeleted"]) <= int(arrays["ndeleted"]):
        fail("path L (a): the window inserted or deleted nothing")
    for g in (got, ref):
        if int(g["cell_overflow"]) != int(arrays["cell_overflow"]):
            fail(f"path L (a): cell overflow {int(g['cell_overflow'])}")
    diff_a = same_atoms(got, ref, 1e-4, "path L (a) gathered slab against "
                        "the sweep engine")
    log(f"path L (a): {SLAB_WORLD} gloo ranks, {SLAB_CHECK_STEPS} steps, "
        f"natoms {int(got['alive'].sum())}, ndeleted {int(got['ndeleted'])}"
        f", ninserted {int(got['ninserted'])}, positions by tag within "
        f"{diff_a:.3e} of the sweep engine; slab {r0[0]['seconds']:.2f} s, "
        f"sweep {sweep_s:.2f} s")
    # (b)
    for i in (1, 2):
        if int(r0[i]["state"]["cell_overflow"]) \
                != int(arrays["cell_overflow"]):
            fail("path L (b): cell overflow")
    diff_b = same_atoms(r0[2]["state"], r0[1]["state"], 1e-5,
                        "path L (b) kernel slab against the gathered slab")
    b_launch = rank_sum(res, 2, keys[SLAB_WORLD])
    if b_launch != SLAB_WORLD * SLAB_KERNEL_STEPS:
        fail(f"path L (b): {b_launch} kernel launches")
    log(f"path L (b): T 0, {SLAB_KERNEL_STEPS} steps, kernel against "
        f"gathered within {diff_b:.3e} by tag")
    # (c)
    prod = r0[3]
    fin, natoms_c, _ = check_slab_production(res, 3, arrays, "path L (c)")
    c_launch = rank_sum(res, 3, keys[SLAB_WORLD])
    if c_launch != SLAB_WORLD * (SLAB_WARM + SLAB_PROD):
        fail(f"path L (c): {c_launch} kernel launches")
    c_s = max(r[3]["seconds"] for r in res)
    c_ms = c_s / SLAB_PROD * 1e3
    geom4 = make_slab_geom(deck, SLAB_WORLD)
    key4, fig4 = check_slab_fields(deck, geom4.pad_geom, prod["fields"],
                                   "path L slab kernel, 4 ranks")
    log(f"path L (c): world {SLAB_WORLD}, gloo, {SLAB_PROD} steps in "
        f"{c_s:.2f} s: {c_ms:.3f} ms/step, "
        f"{SLAB_PROD / c_s * natoms_c / 1e6:.3f} Mparticle-steps/s, "
        f"{natoms_c} atoms, per-rank atoms {[r[3]['natoms'] for r in res]}, "
        f"ndeleted {int(fin['ndeleted'])}, ninserted "
        f"{int(fin['ninserted'])}, launches {c_launch}; the ranks' call "
        f"(paths L and M) took {spawn_s:.1f} s")
    # (d)
    one, one64 = res1[0][0]
    res1 = [r[0] for r in res1]
    if int(one["state"]["cell_overflow"]) != int(arrays["cell_overflow"]) \
            or one["outside"]:
        fail("path L (d): overflow or an atom outside the slab")
    d_launch = rank_sum(res1, 0, keys[1])
    if d_launch != 5 + SLAB_NCCL_STEPS:
        fail(f"path L (d): {d_launch} kernel launches")
    d_ms = one["seconds"] / SLAB_NCCL_STEPS * 1e3
    geom1 = make_slab_geom(deck, 1)
    key1, fig1 = check_slab_fields(deck, geom1.pad_geom, one["fields"],
                                   "path L slab kernel, 1 rank")
    with KeepCounts():
        cp = scenes.obmd_dpd_config(scale=SLAB_SCALE)
        st = setup(cp, convert.from_arrays(arrays, seed=SLAB_SEED,
                                           device=DEV))
        st = make_run(cp, 5)(st)
        sync()
        t0 = time.perf_counter()
        st = make_run(cp, SLAB_NCCL_STEPS)(st)
        sync()
        cell_ms = (time.perf_counter() - t0) / SLAB_NCCL_STEPS * 1e3
    del st
    log(f"path L (d): one NCCL rank {d_ms:.3f} ms/step over "
        f"{SLAB_NCCL_STEPS} steps ({int(one['state']['alive'].sum())} "
        f"atoms), the cellpad engine {cell_ms:.3f} ms/step over as many "
        f"from the same start; the ranks' call (paths L and M) took "
        f"{d_spawn_s:.1f} s")
    # (e)
    e_got = res2[0][0]["state"]
    diff_e = same_atoms(e_got, e_ref, 2e-3, "path L (e) atom decomposition "
                        "against the nlist engine",
                        counters=("ndeleted", "ninserted", "insert_fail"))
    if any(r[0]["launches"] for r in res2):
        fail(f"path L (e): kernel launches {[r[0]['launches'] for r in res2]}")
    log(f"path L (e): {SLAB_WORLD} gloo ranks (the slab's spawn), "
        f"{ATOM_STEPS} steps, {int(e_got['alive'].sum())} atoms, ndeleted "
        f"{int(e_got['ndeleted'])}, ninserted {int(e_got['ninserted'])}, "
        f"positions by tag within {diff_e:.3e} of the nlist engine; "
        f"{res2[0][0]['seconds']:.2f} s")
    # (a')
    got64 = r0[4]["state"]
    require_float64_arrays(got64, "path L64 (a') the gathered slab")
    if int(got64["ninserted"]) <= int(arrays64["ninserted"]) \
            or int(got64["ndeleted"]) <= int(arrays64["ndeleted"]):
        fail("path L64 (a'): the window inserted or deleted nothing")
    for g in (got64, ref64):
        if int(g["cell_overflow"]) != int(arrays64["cell_overflow"]):
            fail(f"path L64 (a'): cell overflow {int(g['cell_overflow'])}")
    ly = deck.box.lengths[1]
    diff_a64 = same_atoms(got64, ref64, L64_X_REL * ly,
                          "path L64 (a') gathered slab at float64 against "
                          "the nlist engine at float64")
    log(f"path L64 (a'): {SLAB_WORLD} gloo ranks, {SLAB_CHECK_STEPS} steps "
        f"at float64, natoms {int(got64['alive'].sum())}, ndeleted "
        f"{int(got64['ndeleted'])}, ninserted {int(got64['ninserted'])}, "
        f"positions by tag within {diff_a64:.3e} ({diff_a64 / ly:.3e} Ly) of "
        f"the nlist engine at float64; slab {r0[4]['seconds']:.2f} s, "
        f"nlist {nlist64_s:.2f} s")
    # (c')
    prod64 = r0[5]
    fin64, natoms_c64, _ = check_slab_production(res, 5, arrays64,
                                                 "path L64 (c')")
    require_float64_arrays(fin64, "path L64 (c')")
    c64_launch = rank_sum(res, 5, keys[SLAB_WORLD], "path L64")
    if c64_launch != SLAB_WORLD * (SLAB_WARM + L64_PROD):
        fail(f"path L64 (c'): {c64_launch} kernel launches")
    c64_s = max(r[5]["seconds"] for r in res)
    c64_ms = c64_s / L64_PROD * 1e3
    key64_4, fig64_4 = check_slab_fields(
        deck64, geom4.pad_geom, prod64["fields"],
        "path L64 slab kernel, 4 ranks, float32 fields of a float64 state")
    log(f"path L64 (c'): world {SLAB_WORLD}, gloo, float64, {L64_PROD} steps "
        f"in {c64_s:.2f} s: {c64_ms:.3f} ms/step (float32 (c) {c_ms:.3f}), "
        f"{L64_PROD / c64_s * natoms_c64 / 1e6:.3f} Mparticle-steps/s, "
        f"{natoms_c64} atoms, ndeleted {int(fin64['ndeleted'])}, ninserted "
        f"{int(fin64['ninserted'])}, launches {c64_launch}")
    # (d')
    if int(one64["state"]["cell_overflow"]) \
            != int(arrays64["cell_overflow"]) or one64["outside"]:
        fail("path L64 (d'): overflow or an atom outside the slab")
    require_float64_arrays(one64["state"], "path L64 (d')")
    d64_launch = rank_sum(res1, 1, keys[1], "path L64")
    if d64_launch != 5 + L64_NCCL_STEPS:
        fail(f"path L64 (d'): {d64_launch} kernel launches")
    d64_ms = one64["seconds"] / L64_NCCL_STEPS * 1e3
    key64_1, fig64_1 = check_slab_fields(
        deck64, geom1.pad_geom, one64["fields"],
        "path L64 slab kernel, 1 rank, float32 fields of a float64 state")
    log(f"path L64 (d'): one NCCL rank at float64 {d64_ms:.3f} ms/step over "
        f"{L64_NCCL_STEPS} steps ({int(one64['state']['alive'].sum())} "
        f"atoms; float32 (d) {d_ms:.3f}); path O logs the nlist engine's "
        f"beside it")
    path_s = own_s + time.perf_counter() - t_path
    log(f"path L: {path_s:.1f} s, the ranks' calls apart")
    path = dict(atoms_at_start=natoms0, atoms=natoms_c, world=SLAB_WORLD,
                backend="gloo", ms_per_step=c_ms,
                mparticle_steps_per_s=SLAB_PROD / c_s * natoms_c / 1e6,
                nccl_world1_ms_per_step=d_ms, cellpad_ms_per_step=cell_ms,
                check_a_max_diff=diff_a, check_b_max_diff=diff_b,
                atom_decomp_max_diff=diff_e, path_s=path_s,
                spawn_s=[spawn_s, d_spawn_s],
                float64=dict(
                    atoms=natoms_c64, ms_per_step=c64_ms,
                    mparticle_steps_per_s=L64_PROD / c64_s * natoms_c64
                    / 1e6, nccl_world1_ms_per_step=d64_ms,
                    check_a_max_diff=diff_a64,
                    check_a_max_diff_over_ly=diff_a64 / ly,
                    check_a_slab_s=r0[4]["seconds"], nlist_s=nlist64_s))
    replaces = ("obmd_tpu/forces/pallas_dpd.py:324 (make_pair_kernel's "
                "kernel, :858) on slab_decomp.py:450-461's pad geometry")
    kernels = [
        kernel_line("pair", f"dpd, the 4-rank slab's pad geometry, {key4}",
                    replaces, c_launch, fig4),
        kernel_line("pair", f"dpd, the 1-rank slab's pad geometry, {key1}",
                    replaces, d_launch, fig1),
        kernel_line("pair", f"dpd, the 4-rank slab's pad geometry, float32 "
                    f"fields of a float64 state, path L64, {key64_4}",
                    replaces, c64_launch, fig64_4),
        kernel_line("pair", f"dpd, the 1-rank slab's pad geometry, float32 "
                    f"fields of a float64 state, path L64, {key64_1}",
                    replaces, d64_launch, fig64_1)]
    return path, kernels


# path M: the slab decomposition's MOLECULE mode on path F's open star melt
# (obmd_tpu_torch/parallel/slab_decomp.py), four gloo ranks sharing the card
M_WORLD = 4
M_CHECK_STEPS = 10          # (a) the gathered slab against the cellpad engine
M_KERNEL_STEPS = 3          # (b) the kernel slab against the gathered at T 0
M_WARM, M_PROD = 10, 40     # (c) production through the kernel
M_NCCL_STEPS = 20           # (d) one NCCL rank beside the cellpad engine
M_SMALL_STEPS = 10          # (e) the small SHAKE and rigid water slabs
M64_PROD = 20               # (c') path M64's production through the kernel
M64_NCCL_STEPS = 10         # (d') its one NCCL rank
# (a) and (b) search with nattempt 0 at this etarget (most unmoved star
# trials pass: their median energy in the melt is 20.8, scenes.
# OPEN_STAR_ETARGET)
M_ETARGET = 60.0
M_SEED = 13
M_ROOM = 1.3                # a rank's slots: M_ROOM x the atoms / world
# (e)'s water (parallel/dryrun.mol_scenes' path 1c template)
M_WATER_DX = ((0.0, 0.2667, 0.0), (-0.6, -0.2333, 0.0), (0.6, -0.2333, 0.0))


def tag_molecules(arrays, sizes, label):
    """A slab state's molecules (partner columns as tags) are whole: every
    live atom's partner tags are live and each live molecule id has one of
    `sizes` atoms.  Returns the molecule count."""
    import numpy as np
    a = arrays["alive"]
    live = np.zeros(int(arrays["tag"].max()) + 2, bool)
    live[arrays["tag"][a]] = True
    for k in ("bond1", "bond2", "bond3", "bond4"):
        if k in arrays:
            p = arrays[k][a]
            p = p[p >= 0]
            if p.size and ((p >= live.size).any() or not live[p].all()):
                fail(f"{label}: a live atom's partner {k} is dead")
    mol = arrays["mol"][a]
    _, counts = np.unique(mol[mol != 0], return_counts=True)
    if not np.isin(counts, sizes).all():
        fail(f"{label}: molecules of {sorted(set(counts.tolist()))} atoms")
    return len(counts)


def template_error(cfg, arrays, dx):
    """The largest |distance - the template's| over every pair of atoms of
    each live molecule of a slab state, its atoms in tag order (the
    template's; minimum image on the periodic axes)."""
    import numpy as np
    dx = np.asarray(dx)
    a = arrays["alive"] & (arrays["mol"] != 0)
    order = np.lexsort((arrays["tag"][a], arrays["mol"][a]))
    x = arrays["x"][a][order].astype(np.float64)
    m = dx.shape[0]
    x = x.reshape(-1, m, 3)
    lengths = np.asarray(cfg.box.lengths)
    per = np.asarray(cfg.box.periodic)
    err = 0.0
    for i in range(m):
        for j in range(i + 1, m):
            d = x[:, i] - x[:, j]
            d = np.where(per, d - lengths * np.round(d / lengths), d)
            d0 = np.linalg.norm(dx[i] - dx[j])
            err = max(err, float(np.abs(np.linalg.norm(d, axis=1)
                                        - d0).max()))
    return err


def small_water_slabs(world):
    """(e)'s scenes at the dry run's size (parallel/dryrun.mol_scenes'
    path 1c): the SHAKE water (closed, nlist setup) and the same waters as
    rigid bodies of the tree template (O-H twice) under `near` insertion of
    that template (cellpad setup), each (slab config, the CPU's start
    arrays, the CPU's single-device step, draws for the slab)."""
    import dataclasses as dc
    import numpy as np
    from obmd_tpu_torch import convert
    from obmd_tpu_torch.config import MolTemplate, ObmdParams
    from obmd_tpu_torch.geometry import RegionBlock
    from obmd_tpu_torch.integrate import make_step, setup
    from obmd_tpu_torch.parallel.dryrun import mol_scenes
    from obmd_tpu_torch.parallel.ranks import ReplayDraws
    from obmd_tpu_torch.state import init_state
    _, (scfg, water) = mol_scenes(world)
    shake_st = setup(scfg, init_state(scfg, device="cpu", **water))
    lx, lyz = scfg.box.hi[0], scfg.box.hi[1]
    tpl = MolTemplate(dx=M_WATER_DX, types=(0, 1, 1),
                      q=(0.0, 0.0, 0.0), bonds=((0, 1), (0, 2)))
    r1 = RegionBlock((0.0, 0.0, 0.0), (2.5, lyz, lyz))
    r2 = RegionBlock((lx - 2.5, 0.0, 0.0), (lx, lyz, lyz))
    rcfg = dc.replace(scfg, shake=None, force_path="cellpad", obmd=ObmdParams(
        ntype=0, nfreq=1, seed=11, pxx=1.0, alpha=0.5, tau=0.01, nbuf=60.0,
        region1=r1, region2=r2, region5=r1, region6=r2, buffer_size=2.5,
        near=0.45, mol=tpl, mol_len=3, insert_kmax=4, rigid=True)).finalize()
    n = water["x"].shape[0] // 3
    tree = np.concatenate([np.asarray(tpl.bonds) + 3 * k + 1
                           for k in range(n)])
    draws = replay_draws(rcfg, M_SMALL_STEPS + 1, M_SEED)
    rigid_st = setup(rcfg, init_state(rcfg, device="cpu",
                                      **dict(water, bonds=tree)),
                     ReplayDraws(draws[:1]))

    def strip(st):
        return {k: v for k, v in convert.to_arrays(st).items()
                if k not in ("nlist", "xref")}
    return (("SHAKE water", scfg, strip(shake_st), make_step(scfg), None,
             shake_st),
            ("rigid water", rcfg, strip(rigid_st),
             make_step(rcfg, ReplayDraws(draws[1:])), draws[1:], rigid_st))


def run_slab_mol(star_end):
    """Phase 43: path M, the slab decomposition's MOLECULE mode on the card
    (obmd_tpu_torch/parallel/slab_decomp.py, the ranks started by
    parallel.comm.Launch with the kernels built beforehand).  From path F's
    ended production state (`star_end`: config, arrays, buffer census in
    molecules): the open star melt under shear, ~100,000 beads, harmonic
    bonds, angles and impropers on the branched template, MOL-mode USHER,
    at full width on M_WORLD slabs of M_ROOM x the atoms / world slots:
      (a) M_WORLD gloo ranks, the gathered slab step against the port's
          cellpad engine in this process, M_CHECK_STEPS steps at the
          insertion phase's nbuf (1.05 x census / alpha, cap 24) on the
          same replayed draws (nattempt 0 at M_ETARGET): natoms, ndeleted
          and ninserted (> 0, a multiple of 5) equal, the tag sets equal,
          positions by tag within 1e-4, molecules whole;
      (b) at temperature 0 the kernel slab step against the gathered one,
          M_KERNEL_STEPS steps each from the same start: positions by tag
          within 1e-5, the kernel launched once a step on each rank;
      (c) production at the deck's nbuf and temperature (USHER at its
          nattempt 40, the state's own draws): M_WARM steps, then M_PROD
          timed; no overflow, every live atom inside its rank's slab, tags
          unique, molecules whole, every rank drew the same numbers, the
          pair kernel launched once a step on each rank under the slab's
          4-channel key and no other kernel; that launch on rank 0's last
          filed rows against its plain version (check_slab_fields);
      (d) one NCCL rank, the same production for M_NCCL_STEPS steps, beside
          the cellpad engine's ms/step over as many steps from the same
          start;
      (e) the small SHAKE water and rigid water (tree template) slabs on the
          card against the same scenes on the port's single-device engine
          on the CPU, M_SMALL_STEPS steps (small_water_slabs): SHAKE x by
          tag within 1e-4, v within 1e-3, constraint error <= 1e-5 (the
          slab's cuts rebalanced every step); rigid bodies by tag within
          RIGID_GEOMETRY and at the template within it; then the port's
          dry run (parallel/dryrun.py, all four paths) on the same M_WORLD
          gloo ranks, after the runs.
    Path M64, the same start widened to float64 exactly (widened_arrays),
    on the same ranks (no single-device engine inserts molecules at
    float64, engine_cellpad.FLOAT64_MOL):
      (b') at temperature 0 the kernel slab at float64 (float32 kernel
           fields from the float64 state) against the gathered slab at
           float64, M_KERNEL_STEPS steps each on the same replayed float64
           draws: positions by tag within 1e-5, the kernel launched once a
           step on each rank;
      (c') production through the kernel at float64: M_WARM steps, then
           M64_PROD timed, with (c)'s checks (molecules whole, insertions
           and deletions in whole stars), every float array float64, the
           launch on rank 0's filed rows against its plain version;
      (d') the same on the one NCCL rank for M64_NCCL_STEPS steps.
    Launch counts of the main path are the ranks' own over (c) and (c').
    A generator, as run_slab: path L's ranks run its rank tasks too."""
    import numpy as np
    import torch
    from obmd_tpu_torch import convert, scenes
    from obmd_tpu_torch.forces.pair_kernel import PairCoef, launch_key
    from obmd_tpu_torch.integrate import (make_run, make_step,
                                          rebuild_neighbors, setup)
    from obmd_tpu_torch.observe import rigid_error
    from obmd_tpu_torch.parallel.dryrun import dry_inputs, dry_line, dry_rank
    from obmd_tpu_torch.parallel.ranks import ReplayDraws, slab_runs
    from obmd_tpu_torch.parallel.slab_decomp import make_slab_geom
    from obmd_tpu_torch.shake import constraint_error
    t_path = time.perf_counter()
    deck, arrays, census = star_end
    natoms0 = int(arrays["alive"].sum())
    o = deck.obmd
    cfg_ins = dataclasses.replace(
        scenes.with_cap(deck, scenes.STAR_WARM_CAP),
        obmd=dataclasses.replace(o, nbuf=1.05 * census / o.alpha,
                                 usher=dataclasses.replace(
                                     o.usher, nattempt=0,
                                     etarget=M_ETARGET))).finalize()
    cfg_t0 = dataclasses.replace(cfg_ins, pair=dataclasses.replace(
        cfg_ins.pair, temp=0.0)).finalize()
    geom_kw = {w: dict(n_loc=int(M_ROOM * natoms0 / w)) for w in (M_WORLD, 1)}
    geoms = {w: make_slab_geom(deck, w, **geom_kw[w]) for w in geom_kw}

    def key_of(cfg, g):
        return launch_key(g.pad_geom, PairCoef.of(g.pad_geom, cfg.pair,
                                                  cfg.dt), 4)
    keys = {w: key_of(deck, g) for w, g in geoms.items()}
    draws = replay_draws(cfg_ins, M_CHECK_STEPS, M_SEED)
    deck64 = dataclasses.replace(deck, dtype="float64").finalize()
    t0_64 = dataclasses.replace(cfg_t0, dtype="float64").finalize()
    arrays64 = widened_arrays(arrays)
    draws64 = replay_draws(t0_64, M_KERNEL_STEPS, M_SEED)

    # (a)'s reference: the cellpad engine on the same start and draws
    t0 = time.perf_counter()
    with KeepCounts():
        ref = rebuild_neighbors(cfg_ins, convert.from_arrays(
            arrays, seed=M_SEED, device=DEV))
        step = make_step(cfg_ins, ReplayDraws(draws))
        for _ in range(M_CHECK_STEPS):
            ref = step(ref)
        sync()
    cell_s = time.perf_counter() - t0
    ref = convert.to_arrays(ref)
    del step
    small = small_water_slabs(M_WORLD)
    torch.cuda.empty_cache()
    g4 = geom_kw[M_WORLD]
    runs = [
        dict(cfg=cfg_ins, arrays=arrays, seed=M_SEED, steps=M_CHECK_STEPS,
             draws=draws, geom=g4),
        dict(cfg=cfg_t0, arrays=arrays, seed=M_SEED, steps=M_KERNEL_STEPS,
             draws=draws, geom=g4),
        dict(cfg=cfg_t0, arrays=arrays, seed=M_SEED, steps=M_KERNEL_STEPS,
             draws=draws, geom=g4, force_impl="kernel"),
        dict(cfg=deck, arrays=arrays, seed=M_SEED, warm=M_WARM,
             steps=M_PROD, force_impl="kernel", fields=True, geom=g4)]
    for _, cfg, start, _, sdraws, _ in small:
        runs.append(dict(cfg=cfg, arrays=start, seed=M_SEED,
                         steps=M_SMALL_STEPS, draws=sdraws,
                         balance_every=0 if cfg.rigid else 1,
                         geom={} if cfg.rigid else dict(grow=1.5)))
    m64 = len(runs)
    runs += [
        dict(cfg=t0_64, arrays=arrays64, seed=M_SEED, steps=M_KERNEL_STEPS,
             draws=draws64, geom=g4),
        dict(cfg=t0_64, arrays=arrays64, seed=M_SEED, steps=M_KERNEL_STEPS,
             draws=draws64, geom=g4, force_impl="kernel"),
        dict(cfg=deck64, arrays=arrays64, seed=M_SEED, warm=M_WARM,
             steps=M64_PROD, force_impl="kernel", fields=True, geom=g4)]
    # the dry run's four paths ride in the same spawn, after the runs;
    # (d)'s in the one-rank spawn
    t0 = time.perf_counter()
    dry_args = dry_inputs(M_WORLD, DEV)
    dry_in_s = time.perf_counter() - t0
    own_s = time.perf_counter() - t_path
    both, res1, spawn_s, d_spawn_s = yield (
        [(slab_runs, (runs,)), (dry_rank, dry_args)],
        [(slab_runs, ([dict(cfg=deck, arrays=arrays, seed=M_SEED, warm=5,
                            steps=M_NCCL_STEPS, force_impl="kernel",
                            fields=True, geom=geom_kw[1]),
                       dict(cfg=deck64, arrays=arrays64, seed=M_SEED, warm=5,
                            steps=M64_NCCL_STEPS, force_impl="kernel",
                            fields=True, geom=geom_kw[1])],))])
    t_path = time.perf_counter()
    res = [b[0] for b in both]
    dry = dry_line(M_WORLD, both[0][1])
    log(dry)
    if not dry.startswith(f"dryrun_multichip({M_WORLD}): ok"):
        fail(f"path M (e): the dry run printed {dry}")
    log("path M, rank 0's seconds a run (set-up, steps, after): "
        + ", ".join(f"{r['setup_s']:.1f}/{r['steps_s']:.1f}/"
                    f"{r['after_s']:.1f}" for r in res[0])
        + f"; the dry run's inputs {dry_in_s:.1f} s")
    r0 = res[0]
    # (a)
    got = r0[0]["state"]
    for k in ("ninserted", "ndeleted"):
        d = int(got[k]) - int(arrays[k])
        if d <= 0 or d % 5:
            fail(f"path M (a): {k} grew by {d}")
    for g in (got, ref):
        if int(g["cell_overflow"]) != int(arrays["cell_overflow"]):
            fail(f"path M (a): cell overflow {int(g['cell_overflow'])}")
    diff_a = same_atoms(got, ref, 1e-4, "path M (a) gathered slab against "
                        "the cellpad engine")
    mols_a = tag_molecules(got, (5,), "path M (a)")
    log(f"path M (a): {M_WORLD} gloo ranks, {M_CHECK_STEPS} steps, natoms "
        f"{int(got['alive'].sum())} ({mols_a} stars, all whole), ndeleted "
        f"{int(got['ndeleted'])}, ninserted {int(got['ninserted'])}, "
        f"positions by tag within {diff_a:.3e} of the cellpad engine; slab "
        f"{r0[0]['seconds']:.2f} s, cellpad {cell_s:.2f} s")
    # (b)
    for i in (1, 2):
        if int(r0[i]["state"]["cell_overflow"]) \
                != int(arrays["cell_overflow"]):
            fail("path M (b): cell overflow")
    diff_b = same_atoms(r0[2]["state"], r0[1]["state"], 1e-5,
                        "path M (b) kernel slab against the gathered slab")
    b_launch = rank_sum(res, 2, key_of(cfg_t0, make_slab_geom(
        cfg_t0, M_WORLD, **geom_kw[M_WORLD])), "path M")
    if b_launch != M_WORLD * M_KERNEL_STEPS:
        fail(f"path M (b): {b_launch} kernel launches")
    log(f"path M (b): T 0, {M_KERNEL_STEPS} steps, kernel against gathered "
        f"within {diff_b:.3e} by tag")
    # (c)
    prod = r0[3]
    fin, natoms_c, mols_c = check_slab_production(res, 3, arrays,
                                                  "path M (c)", (5,))
    c_launch = rank_sum(res, 3, keys[M_WORLD], "path M")
    if c_launch != M_WORLD * (M_WARM + M_PROD):
        fail(f"path M (c): {c_launch} kernel launches")
    c_s = max(r[3]["seconds"] for r in res)
    c_ms = c_s / M_PROD * 1e3
    key4, fig4 = check_slab_fields(deck, geoms[M_WORLD].pad_geom,
                                   prod["fields"],
                                   "path M slab kernel, 4 ranks")
    log(f"path M (c): world {M_WORLD}, gloo, {M_PROD} steps in {c_s:.2f} s: "
        f"{c_ms:.3f} ms/step, {M_PROD / c_s * natoms_c / 1e6:.3f} "
        f"Mparticle-steps/s, {natoms_c} beads ({mols_c} stars, all whole), "
        f"per-rank beads {[r[3]['natoms'] for r in res]}, ndeleted "
        f"{int(fin['ndeleted'])}, ninserted {int(fin['ninserted'])}, "
        f"launches {c_launch}; the ranks' call (paths L and M) took "
        f"{spawn_s:.1f} s")
    # (e), the slabs on the card
    small_out = {}
    for i, (label, cfg, start, cpu_step, _, cpu_st) in enumerate(small, 4):
        st = cpu_st
        for _ in range(M_SMALL_STEPS):
            st = cpu_step(st)
        want = convert.to_arrays(st)
        got_e = r0[i]["state"]
        if any(r[i]["outside"] for r in res):
            fail(f"path M (e) {label}: an atom outside its slab")
        x_tol = 1e-4 if cfg.shake is not None else RIGID_GEOMETRY
        dx = same_atoms(got_e, want, x_tol, f"path M (e) {label}",
                        counters=("ndeleted", "ninserted", "cell_overflow"))
        if cfg.shake is not None:
            v1, v2 = by_tag(dict(got_e, x=got_e["v"])), by_tag(
                dict(want, x=want["v"]))
            dv = max(float(np.abs(v1[t] - v2[t]).max()) for t in v1)
            if not dv <= 1e-3:
                fail(f"path M (e) {label}: velocities by tag differ by {dv}")
            err = template_error(cfg, got_e, M_WATER_DX)
            if not err <= 1e-5:
                fail(f"path M (e) {label}: constraint error {err}")
            small_out[label] = dict(max_dx=dx, max_dv=dv,
                                    constraint_error=err,
                                    cpu_constraint_error=float(
                                        constraint_error(cfg, st)))
        else:
            err = template_error(cfg, got_e, M_WATER_DX)
            if not err <= RIGID_GEOMETRY:
                fail(f"path M (e) {label}: bodies {err} off the template")
            small_out[label] = dict(
                max_dx=dx, rigid_error=err,
                cpu_rigid_error=float(rigid_error(cfg, st)),
                bodies=tag_molecules(got_e, (3,), label),
                inserted=int(got_e["ninserted"]) - int(start["ninserted"]))
        log(f"path M (e) {label}: {M_SMALL_STEPS} steps on the card's "
            f"{M_WORLD} slabs against the CPU's single-device step: "
            f"{small_out[label]}")
    # (d)
    one, one64 = res1[0][0]
    res1 = [r[0] for r in res1]
    if int(one["state"]["cell_overflow"]) != int(arrays["cell_overflow"]) \
            or one["outside"]:
        fail("path M (d): overflow or an atom outside the slab")
    tag_molecules(one["state"], (5,), "path M (d)")
    d_launch = rank_sum(res1, 0, keys[1], "path M")
    if d_launch != 5 + M_NCCL_STEPS:
        fail(f"path M (d): {d_launch} kernel launches")
    d_ms = one["seconds"] / M_NCCL_STEPS * 1e3
    key1, fig1 = check_slab_fields(deck, geoms[1].pad_geom, one["fields"],
                                   "path M slab kernel, 1 rank")
    with KeepCounts():
        st = setup(deck, convert.from_arrays(arrays, seed=M_SEED,
                                             device=DEV))
        st = make_run(deck, 5)(st)
        sync()
        t0 = time.perf_counter()
        st = make_run(deck, M_NCCL_STEPS)(st)
        sync()
        cell_ms = (time.perf_counter() - t0) / M_NCCL_STEPS * 1e3
    del st
    log(f"path M (d): one NCCL rank {d_ms:.3f} ms/step over {M_NCCL_STEPS} "
        f"steps ({int(one['state']['alive'].sum())} beads), the cellpad "
        f"engine {cell_ms:.3f} ms/step over as many from the same start; "
        f"the ranks' call (paths L and M) took {d_spawn_s:.1f} s")
    # (b')
    for i in (m64, m64 + 1):
        require_float64_arrays(r0[i]["state"], "path M64 (b')")
        if int(r0[i]["state"]["cell_overflow"]) \
                != int(arrays64["cell_overflow"]):
            fail("path M64 (b'): cell overflow")
    diff_b64 = same_atoms(r0[m64 + 1]["state"], r0[m64]["state"], 1e-5,
                          "path M64 (b') kernel slab at float64 against "
                          "the gathered slab at float64")
    b64_launch = rank_sum(res, m64 + 1, key_of(t0_64, make_slab_geom(
        t0_64, M_WORLD, **geom_kw[M_WORLD])), "path M64")
    if b64_launch != M_WORLD * M_KERNEL_STEPS:
        fail(f"path M64 (b'): {b64_launch} kernel launches")
    log(f"path M64 (b'): T 0, float64, {M_KERNEL_STEPS} steps, kernel "
        f"against gathered within {diff_b64:.3e} by tag")
    # (c')
    prod64 = r0[m64 + 2]
    fin64, natoms_c64, mols_c64 = check_slab_production(
        res, m64 + 2, arrays64, "path M64 (c')", (5,))
    require_float64_arrays(fin64, "path M64 (c')")
    for k in ("ninserted", "ndeleted"):
        d = int(fin64[k]) - int(arrays64[k])
        if d < 0 or d % 5:
            fail(f"path M64 (c'): {k} grew by {d}")
    c64_launch = rank_sum(res, m64 + 2, keys[M_WORLD], "path M64")
    if c64_launch != M_WORLD * (M_WARM + M64_PROD):
        fail(f"path M64 (c'): {c64_launch} kernel launches")
    c64_s = max(r[m64 + 2]["seconds"] for r in res)
    c64_ms = c64_s / M64_PROD * 1e3
    key64_4, fig64_4 = check_slab_fields(
        deck64, geoms[M_WORLD].pad_geom, prod64["fields"],
        "path M64 slab kernel, 4 ranks, float32 fields of a float64 state")
    log(f"path M64 (c'): world {M_WORLD}, gloo, float64, {M64_PROD} steps "
        f"in {c64_s:.2f} s: {c64_ms:.3f} ms/step (float32 (c) "
        f"{c_ms:.3f}), {M64_PROD / c64_s * natoms_c64 / 1e6:.3f} "
        f"Mparticle-steps/s, {natoms_c64} beads ({mols_c64} stars, all "
        f"whole), ndeleted {int(fin64['ndeleted'])}, ninserted "
        f"{int(fin64['ninserted'])}, launches {c64_launch}")
    # (d')
    if int(one64["state"]["cell_overflow"]) \
            != int(arrays64["cell_overflow"]) or one64["outside"]:
        fail("path M64 (d'): overflow or an atom outside the slab")
    require_float64_arrays(one64["state"], "path M64 (d')")
    tag_molecules(one64["state"], (5,), "path M64 (d')")
    d64_launch = rank_sum(res1, 1, keys[1], "path M64")
    if d64_launch != 5 + M64_NCCL_STEPS:
        fail(f"path M64 (d'): {d64_launch} kernel launches")
    d64_ms = one64["seconds"] / M64_NCCL_STEPS * 1e3
    key64_1, fig64_1 = check_slab_fields(
        deck64, geoms[1].pad_geom, one64["fields"],
        "path M64 slab kernel, 1 rank, float32 fields of a float64 state")
    log(f"path M64 (d'): one NCCL rank at float64 {d64_ms:.3f} ms/step over "
        f"{M64_NCCL_STEPS} steps ({int(one64['state']['alive'].sum())} "
        f"beads; float32 (d) {d_ms:.3f})")
    path_s = own_s + time.perf_counter() - t_path
    log(f"path M: {path_s:.1f} s, the ranks' calls apart")
    path = dict(beads_at_start=natoms0, beads=natoms_c, stars=mols_c,
                world=M_WORLD, backend="gloo", ms_per_step=c_ms,
                mparticle_steps_per_s=M_PROD / c_s * natoms_c / 1e6,
                nccl_world1_ms_per_step=d_ms, cellpad_ms_per_step=cell_ms,
                check_a_max_diff=diff_a, check_b_max_diff=diff_b,
                small=small_out, dryrun=dry, path_s=path_s,
                spawn_s=[spawn_s, d_spawn_s],
                float64=dict(
                    beads=natoms_c64, stars=mols_c64, ms_per_step=c64_ms,
                    mparticle_steps_per_s=M64_PROD / c64_s * natoms_c64
                    / 1e6, nccl_world1_ms_per_step=d64_ms,
                    check_b_max_diff=diff_b64))
    replaces = ("obmd_tpu/forces/pallas_dpd.py:575 (make_pair_kernel's "
                "kernel_bigtile, :858) on slab_decomp.py:450-461's pad "
                "geometry with 4 exclusion channels")
    kernels = [
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, the "
                    f"4-rank slab's pad geometry, path M, {key4}", replaces,
                    c_launch, fig4),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, the "
                    f"1-rank slab's pad geometry, path M, {key1}", replaces,
                    d_launch, fig1),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, the "
                    f"4-rank slab's pad geometry, float32 fields of a "
                    f"float64 state, path M64, {key64_4}", replaces,
                    c64_launch, fig64_4),
        kernel_line("pair", f"dpd, 2 types, 4-channel exclusion, the "
                    f"1-rank slab's pad geometry, float32 fields of a "
                    f"float64 state, path M64, {key64_1}", replaces,
                    d64_launch, fig64_1)]
    return path, kernels


def run_multi_rank(cfg24, st_eq, star_end):
    """Phases 42-43, paths L and M (run_slab, run_slab_mol): four gloo
    ranks and one NCCL rank boot (parallel.comm.Launch) while each path
    prepares its inputs and yields its rank tasks; both paths' four-rank
    tasks run on the gloo ranks (ranks.rank_tasks, path L's first), their
    one-rank tasks on the NCCL rank; then each path checks its own
    results.  Returns each path's (figures, kernel lines) and its seconds,
    the ranks' calls apart, and the calls' seconds."""
    from obmd_tpu_torch.parallel.comm import Launch
    from obmd_tpu_torch.parallel.ranks import rank_clock, rank_tasks
    assert SLAB_WORLD == M_WORLD
    # the ranks boot while the paths prepare their inputs
    launches = [Launch(SLAB_WORLD, "gloo", DEV, RANK_TIMEOUT_S),
                Launch(1, "nccl", DEV, RANK_TIMEOUT_S)]
    paths, asks, own = [], [], []
    for make in (lambda: run_slab(cfg24, st_eq),
                 lambda: run_slab_mol(star_end)):
        t0 = time.perf_counter()
        gen = make()
        asks.append(next(gen))
        own.append(time.perf_counter() - t0)
        paths.append(gen)
    clock = (rank_clock, ())

    def timed_spawn(which):
        """Both paths' tasks on one launch, each path's after a clock task,
        a last clock after them: (each rank's results by path, seconds,
        the last rank's first task, each path's and the return's
        seconds)."""
        tasks = [t for a in asks for t in [clock, *a[which]]] + [clock]
        t_wall, t0 = time.time(), time.perf_counter()
        got = launches[which].run(rank_tasks, tasks)
        secs = time.perf_counter() - t0
        t_end = t_wall + secs
        by_path, i = [], 0
        for a in asks:
            n = len(a[which])
            by_path.append([r[i + 1:i + 1 + n] for r in got])
            i += n + 1
        clocks = [[r[j] for j in range(len(r)) if tasks[j] is clock]
                  for r in got]
        start = max(c[0] for c in clocks) - t_wall
        parts = [max(c[k + 1] for c in clocks) - max(c[k] for c in clocks)
                 for k in range(len(asks))]
        return by_path, secs, (start, parts, t_end - max(c[-1]
                                                         for c in clocks))
    four, spawn_s, f_t = timed_spawn(0)
    one, d_spawn_s, o_t = timed_spawn(1)
    for label, secs, (start, parts, back) in (
            ("four-rank gloo", spawn_s, f_t), ("one-rank NCCL", d_spawn_s,
                                               o_t)):
        log(f"paths L and M: the {label} ranks' call took {secs:.1f} s: "
            f"the last rank began {start:.1f} s in, path L's tasks "
            f"{parts[0]:.1f} s, path M's {parts[1]:.1f} s, the results "
            f"were back {back:.1f} s after the last task")
    out = []
    for k, (gen, t_own) in enumerate(zip(paths, own)):
        t0 = time.perf_counter()
        try:
            gen.send((four[k], one[k], spawn_s, d_spawn_s))
        except StopIteration as done:
            out.append((done.value, t_own + time.perf_counter() - t0))
        else:
            fail("a multi-rank path yielded twice")
    return out, spawn_s + d_spawn_s


def queue_side_jobs():
    """Start the side process and queue, in the order the paths need them,
    the CPU runs that need no card: the small paths whose start is built on
    the device they run on.  (run_star queues the star melt's small path,
    whose start is warmed on the card, then the rigid golden's two runs.)"""
    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.observe import ill_conditioned_impropers
    side_start()
    side_queue_small("OBMD_DPD", small_dpd)
    side_queue_small("open LJ", small_obmd_lj)
    side_queue_small("open charged", small_ljrf)
    for law in scenes.MOL_LAWS:
        side_queue_small(f"molecule-mode {law}", small_mol(law),
                         ill_conditioned_impropers)
    for kind in ("cellpad", "nlist", "census"):
        side_queue_small(f"keywords {kind}", small_keywords(kind),
                         runner="step" if kind == "nlist" else "run")
    for kind in ("water", "molfrac", "deposit", "local"):
        side_queue_small(f"molecule keywords {kind}",
                         small_mol_keywords(kind),
                         runner="step" if kind == "deposit" else "run")
    side_queue_small("rigid water", small_mol_keywords("rigid-water"))


def run_smoke():
    """Phases 2-43b; returns the paths' figures and the kernel figures."""
    from obmd_tpu_torch import _build
    from concurrent.futures import ThreadPoolExecutor
    t_all = time.perf_counter()
    queue_side_jobs()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(_build.build_all)
        warm_profiler()
        built.result()
    build_s = time.perf_counter() - t0
    for kern in _build.KERNELS.values():
        log(f"{kern.name} ({kern.source}): build {kern.build_seconds} s\n"
            f"{kern.ptxas_info}")
    for lib in _build.HOST_LIBRARIES.values():
        log(f"host library {lib.name} ({lib.source}): build "
            f"{lib.build_seconds} s")
    # each path's whole wall time, checks and profile included: the
    # smoke's time budget
    wall_s = {}
    t0 = time.perf_counter()
    obmd_path, obmd_kernels, obmd_prod = run_obmd()
    wall_s["obmd_dpd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lj_path, lj_kernels = run_lj()
    wall_s["lj_melt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    olj_path, olj_kernels, olj_end = run_obmd_lj()
    wall_s["obmd_lj"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain_path, chain_kernels = run_chain()
    wall_s["chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rf_path, rf_kernels, rf_end = run_ljrf()
    wall_s["obmd_ljrf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gauss_path, gauss_kernels = run_gaussian(*obmd_prod)
    wall_s["obmd_dpd_gaussian"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tstat_path, tstat_kernels = run_tstat()
    wall_s["dpd_tstat_ramp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    near_path, near_kernels = run_near(*obmd_prod[:2])
    wall_s["obmd_dpd_near"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    box_path, box_kernels = run_near_box()
    wall_s["near_box"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    closed_path, closed_kernels = run_closed_box()
    wall_s["closed_dpd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    closed64_path, closed64_kernels = run_closed_box("float64")
    wall_s["closed_dpd_float64"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    film, film_kernels = run_film()
    wall_s["dpd_film_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    star_path, star_kernels = run_star()
    wall_s["star_melt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    open_path, open_kernels, star_end = run_open_star(
        dict(dpd=obmd_prod[:2], lj=olj_end, ljrf=rf_end))
    wall_s["open_star"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ext_path, ext_kernels = run_dpdext(*obmd_prod[:2])
    wall_s["obmd_dpdext"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kw_path, kw_kernels = run_keywords(*obmd_prod[:2])
    wall_s["obmd_dpd_keywords"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    excl4_path, excl4_kernels = run_excl4_small()
    wall_s["excl4_small_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    water_path, water_kernels, water_warm = run_water()
    wall_s["open_water"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deck_path, deck_kernels = run_decks(*obmd_prod[:2],
                                        obmd_path["ms_per_step"])
    wall_s["decks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rigid_path, rigid_kernels, rigid_end = run_rigid(
        water_warm, water_path["ms_per_step"])
    del water_warm
    wall_s["open_rigid_water"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k64_path, k64_kernels = run_rigid_float64(rigid_end)
    del rigid_end
    wall_s["open_rigid_water_float64"] = time.perf_counter() - t0
    ((slab_out, wall_s["multi_rank"]), (mol_out,
     wall_s["multi_rank_molecules"])), wall_s["multi_rank_spawns"] = \
        run_multi_rank(*obmd_prod[:2], star_end)
    slab_path, slab_kernels = slab_out
    mol_path, mol_kernels = mol_out
    del star_end
    t0 = time.perf_counter()
    f64_path, f64_kernels = run_float64(*obmd_prod[:2], ext_path,
                                        slab_path["float64"])
    wall_s["obmd_dpd_float64"] = time.perf_counter() - t0
    wall_s["total"] = time.perf_counter() - t_all
    if Side.jobs:
        fail(f"side process runs no check took: {sorted(Side.jobs)}")
    log(f"the smoke's paths took {wall_s['total']:.1f} s, the build "
        f"included")
    return dict(path=dict(build_s=build_s, wall_s=wall_s, obmd_dpd=obmd_path,
                          lj_melt=lj_path, obmd_lj=olj_path,
                          chain=chain_path, obmd_ljrf=rf_path,
                          obmd_dpd_gaussian=gauss_path,
                          dpd_tstat_ramp=tstat_path, obmd_dpd_near=near_path,
                          near_box=box_path, closed_dpd=closed_path,
                          closed_dpd_float64=closed64_path,
                          dpd_film=film,
                          star_melt=star_path, open_star=open_path,
                          obmd_dpdext=ext_path,
                          obmd_dpd_keywords=kw_path,
                          excl4_small_rows=excl4_path,
                          open_water=water_path,
                          open_rigid_water=rigid_path,
                          open_rigid_water_float64=k64_path, decks=deck_path,
                          multi_rank=slab_path,
                          multi_rank_molecules=mol_path,
                          obmd_dpd_float64=f64_path),
                kernels=obmd_kernels + lj_kernels + olj_kernels
                + chain_kernels + rf_kernels + gauss_kernels + tstat_kernels
                + near_kernels + box_kernels + closed_kernels
                + closed64_kernels + film_kernels
                + star_kernels
                + open_kernels + ext_kernels + kw_kernels + excl4_kernels
                + water_kernels + deck_kernels + rigid_kernels + k64_kernels
                + slab_kernels + mol_kernels + f64_kernels)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        import obmd_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"obmd_tpu_torch is not importable here ({e}); run from the "
             "repository root")
    # the path has no matrix product; state the float32 rule explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed rc={smi.returncode}: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    try:
        result = run_smoke()
    finally:
        side_stop()
    print(json.dumps(result["path"]))
    print(json.dumps({"kernels": result["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
