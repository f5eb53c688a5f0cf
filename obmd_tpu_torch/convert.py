"""Conversion between the JAX package's state and the port's, and of its
pair laws.

The JAX side is handed over as a dict of numpy arrays (so this module needs
neither JAX nor the JAX package): the `State` fields x, v, f, type, tag,
q, alive, mol, lambdaF, cms_mol, vcms_mol, rep_atom, bond1, bond2, step,
sim_time, maxtag, cell_overflow, and
on a branched topology bond3, bond4 and impr; the `ObmdScalars` fields;
and the `PadAux` fields xref, rebuilds, overflow, skin_trips, tag3d and
occ, or the `neighbors.NeighborState` fields table, cell_id, nlist,
ncount, xref, tombstone, force_rebuild, rebuilds and overflow.  A pair
law, a bond, angle, dihedral or improper style, the SHAKE table and the
fix's parameters cross by their class name and fields (`pair_params`,
`bonded_params`, `shake_params`, `obmd_params`: every keyword, `mols` /
`molfrac`, `charged`, `orient`, `shake` and the molecule-mode keywords
included), and a whole scene configuration through them
(`scene_config`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cellpad import PadAux
from .config import (AngleHarmonicParams, BondFENEParams, BondHarmonicParams,
                     Capacity, DihedralHarmonicParams, DPDExtParams,
                     DPDParams, DPDTstatParams, ImproperHarmonicParams,
                     LangevinParams, LJCutParams, LJCutRFParams, MolTemplate,
                     ObmdParams, SceneConfig, ShakeParams, UsherParams)
from .geometry import Box, RegionBlock
from .neighbors import NeighborState
from .state import ObmdScalars, State, make_generator, resolve_device

STATE_FIELDS = ("x", "v", "f", "type", "tag", "q", "alive", "mol",
                "lambdaF", "cms_mol", "vcms_mol", "rep_atom", "bond1",
                "bond2", "step", "sim_time", "maxtag", "cell_overflow")
OBMD_FIELDS = ("momentum_force_left", "momentum_force_right",
               "shear_force_left", "shear_force_right", "ndeleted",
               "ninserted", "insert_fail", "usher_iters")
AUX_FIELDS = ("xref", "rebuilds", "overflow", "skin_trips", "tag3d", "occ")
NBR_FIELDS = ("table", "cell_id", "nlist", "ncount", "xref", "tombstone",
              "force_rebuild", "rebuilds", "overflow")
_NBR_INT = ("table", "cell_id", "nlist", "ncount", "rebuilds", "overflow")
# the branched topology's columns, present only on a state that has them
BRANCHED_FIELDS = ("bond3", "bond4", "impr")


def from_arrays(d: dict, seed: int = 0, device="cuda") -> State:
    """Port State from the JAX state's arrays: with `nlist` in `d` a
    NeighborState, else with `xref` a PadAux.  The generator is seeded
    from `seed` (a JAX key has no torch counterpart); bond3, bond4 and
    impr are taken where `d` has them."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(d[name], copy=True)).to(dev)

    aux = None
    if "nlist" in d:
        aux = NeighborState(**{k: t(k).to(torch.int32) if k in _NBR_INT
                               else t(k) for k in NBR_FIELDS})
    elif "xref" in d:
        aux = PadAux(**{k: t(k) for k in AUX_FIELDS})
    return State(
        x=t("x"), v=t("v"), f=t("f"), type=t("type").to(torch.int32),
        tag=t("tag").to(torch.int32), q=t("q"),
        alive=t("alive").to(torch.bool),
        mol=t("mol").to(torch.int32), lambdaF=t("lambdaF"),
        cms_mol=t("cms_mol"), vcms_mol=t("vcms_mol"),
        rep_atom=t("rep_atom").to(torch.int32),
        bond1=t("bond1").to(torch.int32),
        bond2=t("bond2").to(torch.int32),
        step=int(d["step"]), sim_time=t("sim_time"),
        maxtag=t("maxtag").to(torch.int32), gen=make_generator(seed, dev),
        obmd=ObmdScalars(**{k: t(k) for k in OBMD_FIELDS}),
        cell_overflow=t("cell_overflow").to(torch.int32), nbrs=aux,
        **{k: t(k).to(torch.int32) for k in BRANCHED_FIELDS
           if d.get(k) is not None})


def to_arrays(state: State) -> dict:
    """The same dict of numpy arrays from a port State."""
    def n(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    out = {k: n(getattr(state, k)) for k in STATE_FIELDS}
    out.update({k: n(getattr(state.obmd, k)) for k in OBMD_FIELDS})
    out.update({k: n(getattr(state, k)) for k in BRANCHED_FIELDS
                if getattr(state, k) is not None})
    if isinstance(state.nbrs, PadAux):
        out.update({k: n(getattr(state.nbrs, k)) for k in AUX_FIELDS})
    elif isinstance(state.nbrs, NeighborState):
        out.update({k: n(getattr(state.nbrs, k)) for k in NBR_FIELDS})
    return out


_PAIR_LAWS = {c.__name__: c for c in (DPDParams, DPDTstatParams, DPDExtParams,
                                      LJCutParams, LJCutRFParams)}


def pair_params(law):
    """The port's pair law of another package's law object of the same
    class name, field by field (the noise flag and a dpd/tstat ramp
    included)."""
    cls = _PAIR_LAWS.get(type(law).__name__)
    if cls is None:
        raise NotImplementedError(
            f"pair law {type(law).__name__} is not ported")
    return cls(**{f.name: getattr(law, f.name)
                  for f in dataclasses.fields(cls)})


_BONDED_STYLES = {c.__name__: c for c in (
    BondFENEParams, BondHarmonicParams, AngleHarmonicParams,
    DihedralHarmonicParams, ImproperHarmonicParams)}


def bonded_params(style):
    """The port's bond, angle, dihedral or improper style of another
    package's style object of the same class name, field by field (None
    stays None)."""
    if style is None:
        return None
    cls = _BONDED_STYLES.get(type(style).__name__)
    if cls is None:
        raise NotImplementedError(
            f"bonded style {type(style).__name__} is not ported")
    return cls(**{f.name: getattr(style, f.name)
                  for f in dataclasses.fields(cls)})


def shake_params(shake):
    """The port's SHAKE table (d0, iters, vel_iters) of another package's
    ShakeParams (None stays None)."""
    if shake is None:
        return None
    return ShakeParams(**{f.name: getattr(shake, f.name)
                          for f in dataclasses.fields(ShakeParams)})


_OBMD_PARTS = {c.__name__: c for c in (ObmdParams, UsherParams, MolTemplate,
                                       RegionBlock)}


def obmd_params(obmd):
    """The port's fix parameters (`ObmdParams`, its regions, USHER
    parameters and templates) of another package's object of the same
    class names, field by field: every keyword the port knows crosses, the
    deposit keywords (gaussian, global, local, rate), the inserted-velocity
    keywords and `id` included (None stays None)."""
    if obmd is None:
        return None
    if isinstance(obmd, (tuple, list)):
        return type(obmd)(obmd_params(v) for v in obmd)
    cls = _OBMD_PARTS.get(type(obmd).__name__)
    if cls is None or not dataclasses.is_dataclass(obmd):
        return obmd
    fields = {f.name: obmd_params(getattr(obmd, f.name))
              for f in dataclasses.fields(cls)}
    if cls is ObmdParams and fields["mols"]:
        fields["mol"] = fields["mols"][0]   # ObmdParams checks it by identity
    return cls(**fields)


def _same(cls, obj):
    """cls built from obj's fields of the same names (None stays None)."""
    if obj is None:
        return None
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def scene_config(cfg) -> SceneConfig:
    """The port's SceneConfig of another package's, field by field: the
    box, capacities and thermostat by their fields, the pair law, the
    bonded styles, the SHAKE table and the fix's parameters through the
    converters above; fields the port has no counterpart for are not
    read."""
    conv = dict(box=lambda b: _same(Box, b),
                capacity=lambda c: _same(Capacity, c),
                langevin=lambda t: _same(LangevinParams, t),
                pair=pair_params, obmd=obmd_params, shake=shake_params,
                bond=bonded_params, angle=bonded_params,
                dihedral=bonded_params, improper=bonded_params)
    return SceneConfig(**{
        f.name: conv.get(f.name, lambda v: v)(getattr(cfg, f.name))
        for f in dataclasses.fields(SceneConfig)})
