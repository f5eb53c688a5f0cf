"""Binary checkpoint and restart: `write_restart` / `read_restart`.

The port's counterpart of the JAX package's checkpoint (write_restart.cpp
/ read_restart.cpp, but complete: the reference's fix obmd checkpoints
nothing, SURVEY.md §5).  One .npz holds every tensor of the `State` and
its `ObmdScalars` by field name, the step counter, the candidate
generator's state (`torch.Generator.get_state()`; without it a resumed run
draws other candidates) and the pickled `SceneConfig`.  The layout
(`State.nbrs`) is derived data and is not saved: resume through
`integrate.rebuild_neighbors`, or `integrate.setup`.

A configuration whose parameters are closures (a time-dependent `v_`
parameter of a deck) cannot be pickled: saving it raises ValueError.
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from ..config import SceneConfig
from ..state import ObmdScalars, State, make_generator, resolve_device

# State fields that are not tensors saved under their own names
_NOT_TENSORS = ("step", "gen", "obmd", "nbrs")


def _tensor_fields(obj) -> list:
    return [f.name for f in dataclasses.fields(obj)
            if f.name not in _NOT_TENSORS]


def save_checkpoint(path: str, cfg: SceneConfig, state: State):
    try:
        cfg_bytes = pickle.dumps(cfg)
    except Exception as e:  # closures in time-dependent parameters
        raise ValueError(
            "SceneConfig contains unpicklable callable parameters; use "
            "module-level functions for v_-style parameters to checkpoint"
        ) from e
    arrays = {}
    for name in _tensor_fields(state):
        t = getattr(state, name)
        if t is not None:
            arrays[f"state_{name}"] = t.detach().cpu().numpy()
    for name in _tensor_fields(state.obmd):
        arrays[f"obmd_{name}"] = getattr(state.obmd, name).detach().cpu().numpy()
    arrays["step"] = np.asarray(state.step, dtype=np.int64)
    arrays["gen_state"] = state.gen.get_state().numpy()
    arrays["cfg"] = np.frombuffer(cfg_bytes, dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_checkpoint(path: str, cfg: SceneConfig | None = None,
                    device="cuda"):
    """Returns (cfg, state) on `device`, the state without a layout.  Pass
    cfg to override the stored one."""
    dev = resolve_device(device)
    with np.load(path) as z:
        stored = pickle.loads(z["cfg"].tobytes())
        cfg = cfg or stored

        def t(key):
            return torch.from_numpy(z[key].copy()).to(dev)
        kw = {name: t(f"state_{name}")
              for name in _tensor_fields(State)
              if f"state_{name}" in z.files}
        obmd = ObmdScalars(**{name: t(f"obmd_{name}")
                              for name in _tensor_fields(ObmdScalars)})
        gen = make_generator(0, dev)
        gen.set_state(torch.from_numpy(z["gen_state"].copy()))
        step = int(z["step"])
    return cfg, State(step=step, gen=gen, obmd=obmd, nbrs=None, **kw)
