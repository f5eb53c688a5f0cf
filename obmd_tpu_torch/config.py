"""Scene configuration for the OBMD_DPD main path.

Own copy of the ported part of `obmd_tpu/config.py`: `eval_param`,
`DPDParams`, `DPDTstatParams`, `DPDExtParams`, `LJCutParams`,
`LJCutRFParams`,
`UsherParams`, `MolTemplate`, `ObmdParams` (with the molecule-mode fields),
`TemplateStacks` and `template_stacks`, `LangevinParams`, `BondFENEParams`,
`BondHarmonicParams`, `AngleHarmonicParams`, `ImproperHarmonicParams`,
`DihedralHarmonicParams`, `ShakeParams` and the table functions
`shake_table_from_templates`, `derive_center_angle_table` and
`derive_center_improper_table`, `Capacity`
and `SceneConfig.finalize`, with the same field names and defaults so a
test can hold the two packages' configs field by field.  Every law takes
per-type-pair tables (`_sym`).  Under the fix's `rigid` keyword
`SceneConfig.finalize` refuses a template whose bonds close a cycle
(`bond_graph_cyclic`): the rigid integrator's message passing sums a body
exactly only on a tree (rigid.py), where the JAX package accepts it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np

from .geometry import Box, RegionBlock

# A boundary-law parameter: a constant or a function of simulation time.
Param = Union[float, Callable]


def eval_param(p: Param, t):
    """Resolve a Param at simulation time t (a 0-dim tensor)."""
    return p(t) if callable(p) else p


def _sym(table, ntypes, name):
    """Validate/symmetrize an (ntypes, ntypes) coefficient table."""
    arr = np.asarray(table, dtype=np.float64)
    if arr.shape == ():
        arr = np.full((ntypes, ntypes), float(arr))
    if arr.shape != (ntypes, ntypes):
        raise ValueError(f"{name} must be scalar or ({ntypes},{ntypes}), got {arr.shape}")
    if not np.allclose(arr, arr.T):
        raise ValueError(f"{name} table must be symmetric")
    return tuple(tuple(float(v) for v in row) for row in arr)


@dataclasses.dataclass(frozen=True)
class DPDParams:
    """`pair_style dpd T rc seed` + per-type-pair coeffs (pair_dpd.cpp:128-137):
    F = (a0*wd - gamma*wd^2*(rhat . dv) + sigma*wd*xi/sqrt(dt)) * rhat,
    wd = 1 - r/rc, sigma = sqrt(2 kB T gamma)."""

    temp: float
    cutoff: float
    seed: int
    ntypes: int = 1
    a0: Tuple[Tuple[float, ...], ...] = ()
    gamma: Tuple[Tuple[float, ...], ...] = ()
    cut: Tuple[Tuple[float, ...], ...] = ()
    gaussian_noise: bool = False

    @staticmethod
    def create(temp, cutoff, seed, a0, gamma, cut=None, ntypes=1, gaussian_noise=False):
        cut = cutoff if cut is None else cut
        return DPDParams(
            temp=float(temp), cutoff=float(cutoff), seed=int(seed), ntypes=ntypes,
            a0=_sym(a0, ntypes, "a0"), gamma=_sym(gamma, ntypes, "gamma"),
            cut=_sym(cut, ntypes, "cut"), gaussian_noise=gaussian_noise)

    @property
    def sigma(self) -> Tuple[Tuple[float, ...], ...]:
        g = np.asarray(self.gamma)
        return tuple(tuple(float(v) for v in row)
                     for row in np.sqrt(2.0 * self.temp * g))

    @property
    def max_cut(self) -> float:
        return float(np.max(np.asarray(self.cut))) if self.cut else self.cutoff


@dataclasses.dataclass(frozen=True)
class DPDTstatParams:
    """`pair_style dpd/tstat T_start T_stop rc seed` + `pair_coeff gamma
    [cut]` (pair_dpd_tstat.cpp): DPD's drag and noise with no conservative
    term.  With t_stop set and different from t_start, T ramps linearly
    from t_start to t_stop over the step window `ramp` = (begin, end)
    (:52-60); the noise amplitude then scales by sqrt(T(step) / t_start)
    (`forces.pairs.sig_scale_of`), since `sigma` is taken at t_start."""

    temp: float
    cutoff: float
    seed: int
    ntypes: int = 1
    gamma: Tuple[Tuple[float, ...], ...] = ()
    cut: Tuple[Tuple[float, ...], ...] = ()
    gaussian_noise: bool = False
    t_stop: Optional[float] = None          # None or == temp: constant T
    ramp: Optional[Tuple[int, int]] = None  # (begin_step, end_step)

    @staticmethod
    def create(t_start, cutoff, seed, gamma, t_stop=None, cut=None,
               ntypes=1, gaussian_noise=False, ramp=None):
        if (t_stop is not None and float(t_stop) != float(t_start)
                and float(t_start) <= 0.0):
            raise ValueError("dpd/tstat ramp needs t_start > 0 (the noise "
                             "scale is relative to t_start)")
        cut = cutoff if cut is None else cut
        return DPDTstatParams(
            temp=float(t_start), cutoff=float(cutoff), seed=int(seed),
            ntypes=ntypes, gamma=_sym(gamma, ntypes, "gamma"),
            cut=_sym(cut, ntypes, "cut"), gaussian_noise=gaussian_noise,
            t_stop=None if t_stop is None else float(t_stop),
            ramp=None if ramp is None else (int(ramp[0]), int(ramp[1])))

    @property
    def is_ramp(self) -> bool:
        return self.t_stop is not None and self.t_stop != self.temp

    @property
    def sigma(self) -> Tuple[Tuple[float, ...], ...]:
        g = np.asarray(self.gamma)
        return tuple(tuple(float(v) for v in row)
                     for row in np.sqrt(2.0 * self.temp * g))

    @property
    def max_cut(self) -> float:
        return float(np.max(np.asarray(self.cut))) if self.cut else self.cutoff


@dataclasses.dataclass(frozen=True)
class DPDExtParams:
    """`pair_style dpd/ext T rc seed` (DPD-BASIC/pair_dpd_ext.cpp:66-203),
    or with `tstat_only` dpd/ext/tstat, which drops the conservative term:

      F = [a0*wd - gamma*wdPar^2 (rhat.dv)] rhat + sigma*wdPar*xi/sqrt(dt) rhat
          - gammaT*wdPerp^2 P.dv + sigmaT*wdPerp P.XI/sqrt(dt)
    with P = I - rhat rhat^T, wdPar = wd^ws, wdPerp = wd^wsT, XI a 3-vector
    of unit noises, sigma{,T} = sqrt(2 kB T gamma{,T}).  Coefficients per
    type pair: a0 gamma gammaT ws wsT [cut] (:275-310)."""

    temp: float
    cutoff: float
    seed: int
    ntypes: int = 1
    a0: Tuple[Tuple[float, ...], ...] = ()
    gamma: Tuple[Tuple[float, ...], ...] = ()
    gammaT: Tuple[Tuple[float, ...], ...] = ()
    ws: Tuple[Tuple[float, ...], ...] = ()
    wsT: Tuple[Tuple[float, ...], ...] = ()
    cut: Tuple[Tuple[float, ...], ...] = ()
    gaussian_noise: bool = False
    tstat_only: bool = False

    @staticmethod
    def create(temp, cutoff, seed, a0, gamma, gammaT, ws=1.0, wsT=1.0,
               cut=None, ntypes=1, gaussian_noise=False, tstat_only=False):
        cut = cutoff if cut is None else cut
        return DPDExtParams(
            temp=float(temp), cutoff=float(cutoff), seed=int(seed),
            ntypes=ntypes, a0=_sym(a0, ntypes, "a0"),
            gamma=_sym(gamma, ntypes, "gamma"),
            gammaT=_sym(gammaT, ntypes, "gammaT"),
            ws=_sym(ws, ntypes, "ws"), wsT=_sym(wsT, ntypes, "wsT"),
            cut=_sym(cut, ntypes, "cut"), gaussian_noise=gaussian_noise,
            tstat_only=tstat_only)

    @property
    def sigma(self) -> Tuple[Tuple[float, ...], ...]:
        g = np.asarray(self.gamma)
        return tuple(tuple(float(v) for v in row)
                     for row in np.sqrt(2.0 * self.temp * g))

    @property
    def sigmaT(self) -> Tuple[Tuple[float, ...], ...]:
        g = np.asarray(self.gammaT)
        return tuple(tuple(float(v) for v in row)
                     for row in np.sqrt(2.0 * self.temp * g))

    @property
    def max_cut(self) -> float:
        return float(np.max(np.asarray(self.cut))) if self.cut else self.cutoff


@dataclasses.dataclass(frozen=True)
class LJCutParams:
    """`pair_style lj/cut rc` + eps/sigma per type pair (12-6 LJ, energy
    shifted by the cutoff offset when shift=True)."""

    cutoff: float
    ntypes: int = 1
    epsilon: Tuple[Tuple[float, ...], ...] = ()
    sigma: Tuple[Tuple[float, ...], ...] = ()
    cut: Tuple[Tuple[float, ...], ...] = ()
    shift: bool = False

    @staticmethod
    def create(cutoff, epsilon, sigma, cut=None, ntypes=1, shift=False):
        cut = cutoff if cut is None else cut
        return LJCutParams(cutoff=float(cutoff), ntypes=ntypes,
                           epsilon=_sym(epsilon, ntypes, "epsilon"),
                           sigma=_sym(sigma, ntypes, "sigma"),
                           cut=_sym(cut, ntypes, "cut"), shift=shift)

    @property
    def max_cut(self) -> float:
        return float(np.max(np.asarray(self.cut))) if self.cut else self.cutoff


@dataclasses.dataclass(frozen=True)
class LJCutRFParams:
    """`pair_style lj/cut/rf rc_lj [rc_rf]`: 12-6 LJ plus reaction-field
    Coulomb (pair_lj_cut_rf.cpp:118-131 force, :163-171 energy):

      U_rf(r) = C q_i q_j [ 1/r (1 + (eps_rf-1)/(2 eps_rf+1) (r/rc)^3)
                            - 1/rc * 3 eps_rf/(2 eps_rf+1) ]
    with C = qqrd2e (1.0 in LJ units).
    """

    cut_lj: float
    cut_coul: float
    ntypes: int = 1
    epsilon: Tuple[Tuple[float, ...], ...] = ()
    sigma: Tuple[Tuple[float, ...], ...] = ()
    cut: Tuple[Tuple[float, ...], ...] = ()        # per-pair LJ cutoff
    eps_rf: Tuple[Tuple[float, ...], ...] = ()     # dielectric of the RF continuum
    qqrd2e: float = 1.0
    shift: bool = False

    @staticmethod
    def create(cut_lj, epsilon, sigma, eps_rf, cut_coul=None, cut=None,
               ntypes=1, qqrd2e=1.0, shift=False):
        cut_coul = cut_lj if cut_coul is None else cut_coul
        cut = cut_lj if cut is None else cut
        return LJCutRFParams(cut_lj=float(cut_lj), cut_coul=float(cut_coul),
                             ntypes=ntypes,
                             epsilon=_sym(epsilon, ntypes, "epsilon"),
                             sigma=_sym(sigma, ntypes, "sigma"),
                             cut=_sym(cut, ntypes, "cut"),
                             eps_rf=_sym(eps_rf, ntypes, "eps_rf"),
                             qqrd2e=float(qqrd2e), shift=shift)

    @property
    def max_cut(self) -> float:
        mc = float(np.max(np.asarray(self.cut))) if self.cut else self.cut_lj
        return max(mc, self.cut_coul)


PairParams = Union[DPDParams, DPDTstatParams, DPDExtParams, LJCutParams,
                   LJCutRFParams]


@dataclasses.dataclass(frozen=True)
class UsherParams:
    """`usher etarget ds0 dtheta0 uovlp dsolvp eps nattempt`
    (fix_obmd_merged.cpp:2025-2038; algorithm at :1518-1616)."""

    etarget: float
    ds0: float = 1.0
    dtheta0: float = 0.02
    uovlp: float = 1.0e4
    dsovlp: float = 1.5
    eps: float = 1.0
    nattempt: int = 40


@dataclasses.dataclass(frozen=True)
class MolTemplate:
    """A molecule template for molecule-mode insertion (the fix's `mol
    template mol_len` keyword, fix_obmd_merged.cpp:2039-2054; the file
    read by io.molecule.read_molecule).  dx: each atom's displacement from
    the insertion anchor, the template's geometric center; bonds, angles,
    dihedrals and impropers with 0-based atom indices (the leading type
    column kept for the last three)."""

    dx: Tuple[Tuple[float, float, float], ...]
    types: Tuple[int, ...] = ()
    q: Tuple[float, ...] = ()
    bonds: Tuple[Tuple[int, int], ...] = ()
    angles: Tuple[Tuple[int, int, int, int], ...] = ()
    dihedrals: Tuple[Tuple[int, int, int, int, int], ...] = ()
    impropers: Tuple[Tuple[int, int, int, int, int], ...] = ()

    @property
    def natoms(self) -> int:
        return len(self.dx)

    @staticmethod
    def from_file(path: str) -> "MolTemplate":
        """The template of a LAMMPS molecule file (ids made 0-based)."""
        from .io.molecule import read_molecule
        m = read_molecule(path)

        def rows(a, width):
            if a is None:
                return ()
            return tuple((int(r[0]),) + tuple(int(v) - 1 for v in r[1:width])
                         for r in a)
        return MolTemplate(
            dx=tuple(tuple(float(v) for v in row) for row in m.dx),
            types=tuple(int(t) for t in m.types),
            q=tuple(float(v) for v in (m.q if m.q is not None
                                       else np.zeros(m.natoms))),
            bonds=tuple(r[1:] for r in rows(m.bonds, 3)),
            angles=rows(m.angles, 4), dihedrals=rows(m.dihedrals, 5),
            impropers=rows(m.impropers, 5))


def bond_graph_cyclic(natoms: int, bonds) -> bool:
    """Whether a template's bonds ((i, j) 0-based pairs) close a cycle:
    union-find over the atoms."""
    root = list(range(natoms))

    def find(i):
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i
    for i, j in bonds:
        a, b = find(int(i)), find(int(j))
        if a == b:
            return True
        root[a] = b
    return False


@dataclasses.dataclass(frozen=True)
class ObmdParams:
    """`fix ID group obmd ntype nfreq seed pxx pxy pxz dpxx freq alpha tau
    nbuf [keywords]`, ATOM mode or, with `mol`, MOLECULE mode.  region1/2:
    buffers, region3/4: shear sub-regions, region5/6: insertion
    sub-regions."""

    ntype: int
    nfreq: int
    seed: int
    pxx: Param
    pxy: Param = 0.0
    pxz: Param = 0.0
    dpxx: Param = 0.0
    freq: Param = 0.0
    alpha: Param = 0.7
    tau: Param = 0.005
    nbuf: Param = 0.0

    region1: Optional[RegionBlock] = None
    region2: Optional[RegionBlock] = None
    region3: Optional[RegionBlock] = None
    region4: Optional[RegionBlock] = None
    region5: Optional[RegionBlock] = None
    region6: Optional[RegionBlock] = None

    group_types: Optional[Tuple[int, ...]] = None
    buffer_size: float = 0.0   # default 0.3*Lx applied in SceneConfig.finalize
    g_fac: float = 0.25
    maxattempt: int = 1
    usher: Optional[UsherParams] = None
    near: Optional[float] = None
    charged: bool = False
    mol_len: int = 1
    mol: Optional[MolTemplate] = None
    # every template of a multi-template insertion (mol is mols[0]) and
    # their selection probabilities (ref onemols/molfrac, :2039-2054)
    mols: Tuple[MolTemplate, ...] = ()
    molfrac: Optional[Tuple[float, ...]] = None
    insert_kmax: int = 8
    orient: Optional[Tuple[float, float, float]] = None
    rigid: bool = False
    shake: bool = False
    # fix deposit's candidate keywords (ref :880, :930-932, :947-985):
    # `gaussian xmid ymid zmid sigma` draws candidates normally around one
    # point (those outside the insertion region are invalid); `rate r`
    # shifts candidate z by r * sim_time; `global lo hi` puts it lo..hi
    # above the highest alive atom, `local lo hi delta` above the highest
    # alive atom within lateral distance delta of the candidate
    gaussian: Optional[Tuple[float, float, float, float]] = None
    deposit_global: Optional[Tuple[float, float]] = None
    deposit_local: Optional[Tuple[float, float, float]] = None
    rate: Optional[float] = None
    id_policy: str = "next"
    vx: Optional[Tuple[float, float]] = None
    vy: Optional[Tuple[float, float]] = None
    vz: Optional[Tuple[float, float]] = None
    target: Optional[Tuple[float, float, float]] = None

    @property
    def templates(self) -> Tuple[MolTemplate, ...]:
        """All insertion templates (one for the single-`mol` case)."""
        if self.mols:
            return self.mols
        return (self.mol,) if self.mol is not None else ()

    @property
    def mol_natoms_max(self) -> int:
        return max((t.natoms for t in self.templates), default=0)

    def __post_init__(self):
        if (self.usher is None) == (self.near is None):
            raise ValueError("exactly one of `usher` / `near` must be given "
                             "(fix_obmd_merged.cpp:2105,2163)")
        if self.charged and self.mol is None:
            raise ValueError("`charged 1` requires MOLECULE-mode insertion "
                             "(fix_obmd_merged.cpp:2108-2112)")
        if self.mols:
            if self.mol is not self.mols[0]:
                raise ValueError("`mols` given: `mol` must be mols[0]")
            if self.molfrac is not None:
                if len(self.molfrac) != len(self.mols):
                    raise ValueError("molfrac needs one fraction per "
                                     "template (ref :2045-2052)")
                s = float(sum(self.molfrac))
                if not 0.999 <= s <= 1.001:
                    raise ValueError(f"molfrac must sum to 1 (got {s})")
        elif self.molfrac is not None:
            raise ValueError("molfrac without multiple templates")
        for flag, where in (("rigid", "475-500"), ("shake", "1163-1168")):
            if getattr(self, flag) and self.mol is None:
                raise ValueError(f"`{flag}` requires MOLECULE-mode insertion "
                                 f"(fix_obmd_merged.cpp:{where})")
        if self.shake and self.rigid:
            raise ValueError("`rigid` and `shake` are mutually exclusive "
                             "(a molecule is handed to one fix, not both)")
        for name in ("region1", "region2", "region5", "region6"):
            if getattr(self, name) is None:
                raise ValueError(
                    f"fix obmd: `{name}` is required "
                    "(fix_obmd_merged.cpp init() :421-438)")
        if self.deposit_global is not None and self.deposit_local is not None:
            raise ValueError("global and local are mutually exclusive "
                             "(fix_obmd_merged.cpp:2088-2095)")
        if self.region3 is None or self.region4 is None:
            for name in ("pxy", "pxz"):
                v = getattr(self, name)
                if callable(v) or float(v) != 0.0:
                    raise ValueError(
                        "fix obmd: shear stress needs region3/region4 "
                        "(fix_obmd_merged.cpp:1452-1516)")


@dataclasses.dataclass(frozen=True)
class LangevinParams:
    """`fix langevin T T damp seed` (fix_langevin.cpp semantics):
    f += -(m/damp) v + sqrt(24 kB T m / (damp dt)) * uniform(-0.5, 0.5),
    with counter-based per-(atom, axis, step) deviates."""

    temp: float
    damp: float
    seed: int = 904297


@dataclasses.dataclass(frozen=True)
class BondFENEParams:
    """`bond_style fene` (bench/in.chain: bond_coeff 1 30.0 1.5 1.0 1.0):
    U = -0.5 K R0^2 ln(1-(r/R0)^2) + WCA(eps, sigma).  `special_bonds fene`
    semantics are implied: 1-2 pairs are excluded from the pair style."""

    k: float = 30.0
    r0: float = 1.5
    epsilon: float = 1.0
    sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class BondHarmonicParams:
    """`bond_style harmonic` (bond_harmonic.cpp): E = K (r - r0)^2,
    fbond = -2 K (r - r0) / r.  1-2 pairs are excluded from the pair style
    (the kernel's partner-tag exclusion); 1-3/1-4 pairs keep full pair
    interactions (`special_bonds lj/coul 0 1 1` semantics)."""

    k: float = 100.0
    r0: float = 1.0


BondParams = Union[BondFENEParams, BondHarmonicParams]


@dataclasses.dataclass(frozen=True)
class AngleHarmonicParams:
    """`angle_style harmonic` (angle_harmonic.cpp): E = K (theta -
    theta0)^2 per angle, theta0 in degrees.

    Center-atom storage (no angle array in the fixed-capacity state): an
    alive atom of a type with k > 0 is the center of one angle between
    each pair of its bond partners (two partners on a chain, up to six
    pairs on a branched center).  derive_center_angle_table builds the
    table from a data file's Angles section and refuses what the storage
    cannot hold."""

    k: Tuple[float, ...]        # per CENTER atom type; 0 = bends no angle
    theta0: Tuple[float, ...]   # degrees, per center atom type


@dataclasses.dataclass(frozen=True)
class ImproperHarmonicParams:
    """`improper_style harmonic` (improper_harmonic.cpp): E = K (chi -
    chi0)^2 per improper quadruple (i1, i2, i3, i4), chi0 in degrees, chi
    the dihedral-like angle over (x1-x2, x3-x2, x4-x3).

    Center-atom storage: the slots of (i1, i3, i4) live in State.impr on
    the center i2, and the coefficients are keyed by the center's type (0
    = no improper).  The center must be bonded to all three ends, and
    carries at most one improper."""

    k: Tuple[float, ...]      # per CENTER atom type
    chi0: Tuple[float, ...]   # degrees, per center atom type


@dataclasses.dataclass(frozen=True)
class DihedralHarmonicParams:
    """`dihedral_style harmonic` (dihedral_harmonic.cpp): E = K [1 + d
    cos(n phi)] per dihedral, d = +-1, n >= 1.

    Center-bond storage: every bonded pair (j, k) whose atoms both have two
    bond partners spans one dihedral i-j-k-l, i and l the other partners:
    the quadruples of a linear chain, with one coefficient set."""

    k: float
    d: int = 1
    n: int = 1

    def __post_init__(self):
        if self.d not in (1, -1):
            raise ValueError("dihedral harmonic: d must be +1 or -1")
        if self.n < 1:
            raise ValueError("dihedral harmonic: n must be >= 1")


@dataclasses.dataclass(frozen=True)
class ShakeParams:
    """SHAKE/RATTLE distance constraints (RIGID/fix_shake.cpp; reached
    through fix obmd's `shake` keyword, fix_obmd_merged.cpp:1163-1168).
    d0 [ntypes, ntypes]: the target distance of a bonded pair by its
    endpoint types (0: that pair is not constrained), built from the
    insertion template's own geometry by shake_table_from_templates."""

    d0: Tuple[Tuple[float, ...], ...]
    iters: int = 30          # Jacobi position sweeps per step
    vel_iters: int = 10      # RATTLE velocity sweeps per kick

    def __post_init__(self):
        a = np.asarray(self.d0, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("shake d0 must be a square [ntypes, ntypes]")
        if not np.allclose(a, a.T):
            raise ValueError("shake d0 must be symmetric")


def shake_table_from_templates(templates, ntypes: int,
                               **kw) -> ShakeParams:
    """The constraint table of the templates' bonded pairs: each bond (a,
    b) holds |x_a - x_b| at the template's own distance, keyed by the
    endpoint types (types as the template gives them).  Two different
    distances on one type pair raise ValueError."""
    d0 = np.zeros((ntypes, ntypes), dtype=np.float64)
    for t in templates:
        dx = np.asarray(t.dx, dtype=np.float64)
        types = list(t.types) if t.types else [0] * t.natoms
        for a, b in t.bonds:
            d = float(np.linalg.norm(dx[a] - dx[b]))
            ta, tb = types[a], types[b]
            for i, j in ((ta, tb), (tb, ta)):
                if d0[i, j] > 0 and abs(d0[i, j] - d) > 1e-10:
                    raise ValueError(
                        f"shake: type pair ({i},{j}) carries two different "
                        f"template distances ({d0[i, j]} vs {d}); give the "
                        "atoms distinct types")
                d0[i, j] = d
    return ShakeParams(d0=tuple(tuple(float(v) for v in row) for row in d0),
                       **kw)


@dataclasses.dataclass(frozen=True)
class TemplateStacks:
    """Numpy stacks of all insertion templates, padded to the largest
    natoms m (pad rows are masked by `amask`)."""

    dx: np.ndarray       # [T, m, 3]
    amask: np.ndarray    # [T, m] bool
    types: np.ndarray    # [T, m] 0-based engine types (ntype added)
    q: np.ndarray        # [T, m]
    rep: np.ndarray      # [T, m] rep_atom flags
    natoms: np.ndarray   # [T]
    pidx: np.ndarray     # [T, m, 4] intra-template partner indices (-1)
    iidx: np.ndarray     # [T, m, 3] the (i1, i3, i4) indices of the
    #                      improper stored on its center (-1)
    frac: np.ndarray     # [T] selection probabilities

    @property
    def branched(self) -> bool:
        """Some template atom has more than two bond partners."""
        return bool((self.pidx[:, :, 2] >= 0).any())

    @property
    def has_impropers(self) -> bool:
        return bool((self.iidx >= 0).any())


def template_stacks(obmd) -> TemplateStacks:
    """The stacks of obmd.templates: each bond (a, b) puts b in a's first
    free partner column, then a in b's; each improper goes on its center,
    which must be bonded to its three ends and center at most one."""
    tpls = obmd.templates
    t_n, m = len(tpls), obmd.mol_natoms_max
    dx = np.zeros((t_n, m, 3))
    am = np.zeros((t_n, m), bool)
    ty = np.zeros((t_n, m), np.int64)
    q = np.zeros((t_n, m))
    rep = np.zeros((t_n, m), np.int64)
    nat = np.zeros((t_n,), np.int64)
    pidx = np.full((t_n, m, 4), -1, np.int64)
    iidx = np.full((t_n, m, 3), -1, np.int64)
    for t, tpl in enumerate(tpls):
        mt = tpl.natoms
        nat[t] = mt
        dx[t, :mt] = np.asarray(tpl.dx)
        am[t, :mt] = True
        ty[t, :mt] = np.asarray(tpl.types) + int(obmd.ntype)
        if len(tpl.q):
            q[t, :mt] = np.asarray(tpl.q)
        for a, b in tpl.bonds:
            for me, other in ((a, b), (b, a)):
                free = np.flatnonzero(pidx[t, me] < 0)
                if not len(free):
                    raise ValueError("template atom in >4 bonds")
                pidx[t, me, free[0]] = other
        for _it, i1, i2, i3, i4 in tpl.impropers:
            partners = {int(p) for p in pidx[t, i2] if p >= 0}
            if not {int(i1), int(i3), int(i4)} <= partners:
                raise ValueError(
                    f"template improper ({i1},{i2},{i3},{i4}): center {i2} "
                    "is not bonded to all three ends (only the out-of-plane "
                    "convention is stored per center)")
            if iidx[t, i2, 0] >= 0:
                raise ValueError(
                    f"template atom {i2} is the center of two impropers")
            iidx[t, i2] = (i1, i3, i4)
    frac = (np.asarray(obmd.molfrac, np.float32) if obmd.molfrac is not None
            else np.full((t_n,), 1.0 / t_n, np.float32))
    return TemplateStacks(dx=dx, amask=am, types=ty, q=q, rep=rep,
                          natoms=nat, pidx=pidx, iidx=iidx, frac=frac)


def _center_coeff(k, x0, ct, coeff, what):
    """Set center type ct's (K, x0) once; two different sets raise."""
    kk, th = float(coeff[0]), float(coeff[1])
    if k[ct] not in (0.0, kk) or (k[ct] != 0.0 and x0[ct] != th):
        raise ValueError(
            f"center atom type {ct + 1} would carry two different {what} "
            "coefficient sets — unsupported by the center-atom storage")
    k[ct], x0[ct] = kk, th


def derive_center_improper_table(ntypes: int, impropers, atom_types,
                                 coeffs) -> ImproperHarmonicParams:
    """The per-center-type improper table of an improper list (a data
    file's Impropers section): impropers [(improper_type, i1, i2, i3, i4)]
    with i2 the center, atom_types {id: 0-based type}, coeffs
    {improper_type: (K, chi0 in degrees)}.  Two coefficient sets on one
    center type raise ValueError."""
    k = [0.0] * ntypes
    x0 = [0.0] * ntypes
    for itype, _i1, i2, _i3, _i4 in impropers:
        if int(itype) not in coeffs:
            raise ValueError(f"no improper_coeff for improper type {itype}")
        _center_coeff(k, x0, int(atom_types[int(i2)]), coeffs[int(itype)],
                      "improper")
    return ImproperHarmonicParams(k=tuple(k), chi0=tuple(x0))


def derive_center_angle_table(ntypes: int, angles, atom_types, bonds,
                              coeffs) -> AngleHarmonicParams:
    """The per-center-type angle table of an angle list (a data file's
    Angles section): angles [(angle_type, a1, a2, a3)] with a2 the center,
    atom_types {id: 0-based type}, bonds [(i, j)] id pairs, coeffs
    {angle_type: (K, theta0 in degrees)}.

    Raises ValueError where the storage would differ from the list: an
    angle whose arms are not bonds, two coefficient sets on one center
    type, an atom in more than four bonds, and a center of a covered type
    that declares some but not all of its partner pairs (the step bends
    every pair of such a center's partners)."""
    bond_set = set()
    deg: dict = {}
    for i, j in bonds:
        i, j = int(i), int(j)
        bond_set.update(((i, j), (j, i)))
        deg[i] = deg.get(i, 0) + 1
        deg[j] = deg.get(j, 0) + 1
    k = [0.0] * ntypes
    t0 = [0.0] * ntypes
    centers: dict = {}
    for atype, a1, a2, a3 in angles:
        a1, a2, a3 = int(a1), int(a2), int(a3)
        if (a1, a2) not in bond_set or (a2, a3) not in bond_set:
            raise ValueError(
                f"angle ({a1},{a2},{a3}): arms must be bonds for the "
                "center-atom angle storage")
        if int(atype) not in coeffs:
            raise ValueError(f"no angle_coeff for angle type {atype}")
        _center_coeff(k, t0, int(atom_types[a2]), coeffs[int(atype)],
                      "angle")
        centers.setdefault(a2, set()).add(frozenset((a1, a3)))
    for a, d in deg.items():
        if d > 4:
            raise ValueError("topology limit: <= 4 bonds/atom")
        if d >= 2 and k[int(atom_types[a])] > 0:
            want = d * (d - 1) // 2
            got = len(centers.get(a, ()))
            if got != want:
                raise ValueError(
                    f"atom {a} has {d} bonds and a covered center type but "
                    f"declares {got} of its {want} partner-pair angles — "
                    "the center-atom storage bends EVERY pair of a covered "
                    "center's partners, so all (or none) must be declared")
    return AngleHarmonicParams(k=tuple(k), theta0=tuple(t0))


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Static shapes: particle slots, filing capacity per cell, and for the
    nlist and sweep engines the Verlet row capacity K, the movers an
    incremental table update takes and the buffer subsets' rows (0: n_max
    // 2)."""

    n_max: int
    cell_capacity: int = 16
    max_neighbors: int = 48
    movers_max: int = 1024
    insert_region_max: int = 0

    def __post_init__(self):
        if self.n_max <= 0 or self.cell_capacity <= 0:
            raise ValueError("capacities must be positive")


FORCE_PATHS = ("cellpad", "nlist", "sweep")
# the dtypes a scene's state may take, as the JAX package's SceneConfig.dtype
# (which runs float64 with x64 enabled; engine_cellpad.FLOAT64_MOL and
# io.script.FLOAT64_DECK name what the port refuses at float64, and why)
DTYPES = ("float32", "float64")


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Box, masses, pair style, dt, the OBMD stage, the bond, angle,
    dihedral and improper styles, the rigid-body flag (rigid.py), the
    SHAKE/RATTLE constraints, the Langevin thermostat and
    static capacities.  `branched_topology` (more than two bonds on some
    atom) gives the state four partner columns (and with `improper` the
    impr column) and the pair kernel four exclusion channels; set it for a
    branched data file."""

    box: Box
    masses: Tuple[float, ...]
    pair: PairParams
    dt: float
    capacity: Capacity
    obmd: Optional[ObmdParams] = None
    bond: Optional[BondParams] = None
    angle: Optional[AngleHarmonicParams] = None
    dihedral: Optional[DihedralHarmonicParams] = None
    improper: Optional[ImproperHarmonicParams] = None
    # fix rigid: every mol != 0 atom a rigid body (fix obmd's `rigid`)
    rigid: bool = False
    # fix shake: distance constraints over the bond columns (fix obmd's
    # `shake`, where finalize derives the table from the templates)
    shake: Optional[ShakeParams] = None
    langevin: Optional[LangevinParams] = None
    skin: float = 0.3
    # "cellpad" (the padded layout and the pair kernel), "nlist" (the
    # persistent cell table and [N, K] Verlet list, neighbors.py) or
    # "sweep" (a fresh cell table and the pair sweep every step)
    force_path: str = "cellpad"
    rebuild_every: int = 0
    dtype: str = "float32"
    branched_topology: bool = False

    @property
    def ntypes(self) -> int:
        return len(self.masses)

    def finalize(self) -> "SceneConfig":
        """Apply the buffersize default 0.3*Lx (fix_obmd_merged.cpp:1912),
        set `rigid` from the fix's keyword, set branched_topology when an
        insertion template is branched, derive the SHAKE table from the
        templates under the fix's `shake`, and refuse rigid with shake, a
        table of another type count (obmd_tpu/config.py:868-893) and, where
        the JAX package does not, rigid with a template whose bonds close a
        cycle, and a dtype outside DTYPES."""
        out = self
        if out.force_path not in FORCE_PATHS:
            raise ValueError(f"force_path must be one of {FORCE_PATHS}, not "
                             f"{out.force_path!r}")
        if out.dtype not in DTYPES:
            raise NotImplementedError(f"dtype must be one of {DTYPES}, not "
                                      f"{out.dtype!r}")
        if out.obmd is not None and out.obmd.buffer_size == 0.0:
            lx = out.box.lengths[0]
            obmd = dataclasses.replace(out.obmd, buffer_size=0.3 * lx)
            out = dataclasses.replace(out, obmd=obmd)
        if out.obmd is not None and out.obmd.rigid and not out.rigid:
            out = dataclasses.replace(out, rigid=True)
        if (out.obmd is not None and out.obmd.mol is not None
                and not out.branched_topology
                and template_stacks(out.obmd).branched):
            out = dataclasses.replace(out, branched_topology=True)
        if out.obmd is not None and out.obmd.shake and out.shake is None:
            out = dataclasses.replace(out, shake=shake_table_from_templates(
                out.obmd.templates, out.ntypes))
        if out.shake is not None and out.rigid:
            raise ValueError("rigid and shake are mutually exclusive")
        if out.rigid and out.obmd is not None:
            for k, t in enumerate(out.obmd.templates):
                if bond_graph_cyclic(t.natoms, t.bonds):
                    raise ValueError(
                        f"`rigid`: template {k}'s bond graph has a cycle; "
                        f"the rigid integrator sums a body by message "
                        f"passing over its bonds, exact only on a tree "
                        f"(bond a water O-H twice, not H-H as well)")
        if out.shake is not None and len(out.shake.d0) != out.ntypes:
            raise ValueError(
                f"shake d0 table is {len(out.shake.d0)} types, scene has "
                f"{out.ntypes}")
        return out
