"""LAMMPS input-deck front end of the port.

The port's own copy of the JAX package's deck interpreter (the
reference's Input/Variable engine: input.cpp:195 `file()`, :382 `one()`,
:764 `execute_command()`; variable.cpp), with every command and check it
has, so a deck such as examples/OBMD_DPD/in.simulation maps 1:1 onto the
port's SceneConfig and State and runs on the card (`device="cuda"`, the
default) or through the plain PyTorch versions (`device="cpu"`):

  units lj | dimension | boundary | atom_style | comm_modify | newton |
  processors | lattice fcc | region block/sphere/cylinder | create_box |
  create_atoms | pair_style dpd, dpd/tstat, dpd/ext, dpd/ext/tstat,
  lj/cut, lj/cut/rf | pair_modify shift | pair_coeff | molecule |
  bond/angle/dihedral/improper_style and _coeff | special_bonds | mass |
  read_data | write_data | neighbor | neigh_modify | timestep | velocity |
  group type | compute chunk/atom bin/1d | fix nve, obmd, langevin,
  ave/chunk | unfix | thermo | thermo_style custom | dump xyz, custom,
  dcd | undump | min_style fire | minimize | run | write_restart |
  read_restart | log | print | shell | variable equal, internal, atom,
  index, loop, string, delete

Control flow (input.cpp:764): `label`, `jump SELF/FILE [label]`, `next v1
[v2 ...]` over loop and index variables, `if "<cond>" then "<cmd>" ...
[elif ...] [else "<cmd>" ...]` and `clear`.

An unsupported command raises (strict mode) or warns (lenient mode).  The
engine is the port's cellpad engine where `engine_cellpad.supports` holds,
else the nlist engine.  A time-dependent `v_` parameter of fix obmd is a
function of the stage's simulation time, evaluated on 0-dim tensors on the
run's device (`expr.torch_backend`).  `read_restart` rebuilds the layout
of the loaded state, so a `run` can follow it.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from ..config import (Capacity, DPDParams, LJCutParams, LJCutRFParams,
                      ObmdParams, SceneConfig, UsherParams)
from ..geometry import RegionBlock
from ..state import resolve_device
from . import lammps_data


def _host(t) -> np.ndarray:
    """A state tensor as numpy, on the host."""
    return t.detach().cpu().numpy()


class ScriptError(RuntimeError):
    pass


# why the Interpreter, and the C ABI over it, refuse a float64 restart
FLOAT64_DECK = (
    "the deck Interpreter (and the C ABI over it) runs float32 decks: the "
    "JAX package's Interpreter has no dtype (obmd_tpu/config.py:848 "
    "defaults SceneConfig.dtype to float32 and obmd_tpu/io/script.py never "
    "sets it), so a float64 deck would be a feature the reference lacks; "
    "a float64 scene runs through the library API (integrate.setup, "
    "make_step) or the slab and atom decompositions")


@dataclasses.dataclass
class _PairStyle:
    name: str
    args: List[str]
    coeffs: List[List[str]]


class Interpreter:
    """Executes a script, accumulating scene settings; `run N` builds the
    engine and advances the state (like Run::command -> Verlet::run) on
    `device`: the card unless the caller asks for the CPU (asking for the
    card on a machine without one raises)."""

    def __init__(self, strict: bool = True, n_max: Optional[int] = None,
                 cell_capacity: int = 24, log_fn: Callable = print,
                 device="cuda"):
        self.device = resolve_device(device)
        self.strict = strict
        self.n_max = n_max
        self.cell_capacity = cell_capacity
        self.log = log_fn
        self.variables: Dict[str, object] = {}
        self.var_exprs: Dict[str, object] = {}  # parsed ASTs of equal vars
        self.regions: Dict[str, RegionBlock] = {}
        self.boundary = ("p", "p", "p")   # LAMMPS default (domain.cpp)
        self.atom_style = "atomic"
        self.pair: Optional[_PairStyle] = None
        self.dt = 0.005
        self.skin = 0.3
        # neigh_modify every / delay / check (neighbor.cpp's defaults)
        self.neigh_every, self.neigh_delay, self.neigh_check = 1, 0, True
        self.masses: Dict[int, float] = {}
        self.data: Optional[lammps_data.DataFile] = None
        self.obmd_args: Optional[List[str]] = None
        self.molecules: Dict[str, tuple] = {}
        self.atom_var_exprs: Dict[str, object] = {}  # parsed ASTs
        self.langevin = None
        self._velocity_ops: list = []
        self.chunks: Dict[str, tuple] = {}
        self.groups: Dict[str, tuple] = {}
        self.obmd_group = None
        self.lattice = None
        self.pair_shift = False
        self._create_box = None
        self._create_atoms: list = []
        self.ave_chunks: list = []
        self.bond_style: Optional[str] = None
        self.bond_coeffs: Dict[int, List[float]] = {}
        self.angle_style: Optional[str] = None
        self.angle_coeffs: Dict[int, tuple] = {}
        self.dihedral_style: Optional[str] = None
        self.dihedral_coeffs: Dict[int, tuple] = {}
        self.improper_style: Optional[str] = None
        self.improper_coeffs: Dict[int, tuple] = {}
        self.thermo_every = 0
        self.thermo_cols = ["step", "temp"]
        self.dumps: List[tuple] = []
        self.cfg: Optional[SceneConfig] = None
        self.state = None
        self.total_steps = 0
        self._thermo_fn = None
        # control flow (input.cpp jump/next; variable.cpp loop/index state)
        self._iter_vars: Dict[str, dict] = {}   # name -> {values, pos}
        self._skip_next_jump = False
        self._path: Optional[str] = None

    # ---------------- script plumbing ----------------

    def run_file(self, path: str):
        self._path = path
        with open(path) as fh:
            self.run_lines(fh.read().splitlines())

    @staticmethod
    def _join_continuations(lines):
        """Fold `&` trailing-continuation lines (input.cpp parse)."""
        prog, buf = [], ""
        for raw in lines:
            line = raw.rstrip()
            if line.endswith("&"):
                buf += line[:-1] + " "
                continue
            prog.append(buf + line)
            buf = ""
        if buf:
            prog.append(buf)
        return prog

    def run_lines(self, lines):
        """Execute a program with a program counter so `jump` can move it
        (input.cpp:195 file() re-reads; here the program is held in memory
        and jump/label set the counter)."""
        prev = (getattr(self, "_prog", None), getattr(self, "_pc", 0))
        self._prog = self._join_continuations(lines)
        self._pc = 0
        try:
            while self._pc < len(self._prog):
                line = self._prog[self._pc]
                self._pc += 1
                self.one(line)
        finally:
            self._prog, self._pc = prev

    # token = "double-quoted" | 'single-quoted' | bare word; quotes group
    # args with spaces and are stripped (input.cpp:parse single/double/
    # triple-quote handling; triple quotes are not needed by any deck)
    _TOKEN_RE = re.compile(r'"([^"]*)"|\'([^\']*)\'|(\S+)')

    @classmethod
    def _tokenize(cls, line: str) -> List[str]:
        out = []
        for m in cls._TOKEN_RE.finditer(line):
            g1, g2, g3 = m.groups()
            out.append(g1 if g1 is not None else (g2 if g2 is not None else g3))
        return out

    @staticmethod
    def _strip_comment(line: str) -> str:
        """Drop `# ...` unless the # sits inside a quoted string."""
        if "#" not in line:
            return line.strip()
        quote = ""
        for i, ch in enumerate(line):
            if quote:
                if ch == quote:
                    quote = ""
            elif ch in "\"'":
                quote = ch
            elif ch == "#":
                return line[:i].strip()
        return line.strip()

    def one(self, line: str):
        line = self._strip_comment(line)
        if not line:
            return
        line = self._substitute(line)
        args = self._tokenize(line)
        cmd, rest = args[0], args[1:]
        handler = getattr(self, "cmd_" + cmd.replace("/", "_"), None)
        if handler is None:
            if self.strict:
                raise ScriptError(f"unsupported command: {cmd}")
            self.log(f"WARNING: ignoring unsupported command: {cmd}")
            return
        handler(rest)

    def _substitute(self, line: str) -> str:
        """${name} and $x substitution (input.cpp:substitute)."""
        def repl(m):
            name = m.group(1) or m.group(2)
            if name not in self.variables:
                raise ScriptError(f"undefined variable {name}")
            return str(self._eval_var(name))
        return re.sub(r"\$\{(\w+)\}|\$(\w)", repl, line)

    def _eval_var(self, name):
        v = self.variables[name]
        return v() if callable(v) else v

    def _eval_var_num(self, name):
        """v_name inside a FORMULA: loop/index variables hold strings but
        evaluate numerically in equal-style expressions (variable.cpp
        evaluate() coerces); non-numeric strings stay strings so `v_a ==
        v_b` string comparison still works."""
        v = self._eval_var(name)
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return v
        return v

    # ---------------- commands ----------------

    def cmd_units(self, a):
        if a[0] != "lj":
            raise ScriptError("only `units lj` supported")

    def cmd_dimension(self, a):
        if a[0] != "3":
            raise ScriptError("only 3d supported")

    def cmd_boundary(self, a):
        self.boundary = tuple(a[:3])

    def cmd_atom_style(self, a):
        self.atom_style = a[0]

    def cmd_comm_modify(self, a):
        pass  # ghost velocity comm is implicit in the TPU design

    def cmd_newton(self, a):
        pass  # full-neighbor sweep: newton setting has no effect

    def cmd_processors(self, a):
        pass

    def cmd_log(self, a):
        pass

    def cmd_print(self, a):
        self.log(" ".join(a).strip('"'))

    # ---------------- control flow (input.cpp:764 dispatch) ----------------

    def cmd_label(self, a):
        pass  # jump targets are resolved by cmd_jump's scan

    def cmd_jump(self, a):
        """jump SELF|<file> [label] — move the program counter; a jump
        right after an exhausting `next` is skipped (input.cpp Jump +
        next command semantics)."""
        if self._skip_next_jump:
            self._skip_next_jump = False
            return
        target = a[0]
        if target not in ("SELF", self._path):
            with open(target) as fh:
                self._prog = self._join_continuations(fh.read().splitlines())
            self._path = target
        if len(a) > 1:
            label = a[1]
            for i, line in enumerate(self._prog):
                toks = self._strip_comment(line).split()
                if len(toks) >= 2 and toks[0] == "label" and toks[1] == label:
                    self._pc = i
                    return
            raise ScriptError(f"label {label} not found for jump")
        self._pc = 0

    def cmd_next(self, a):
        """next v1 [v2 ...] — advance loop/index variables in lockstep;
        on exhaustion delete them and skip the next jump (variable.cpp
        Variable::next)."""
        exhausted = False
        for name in a:
            it = self._iter_vars.get(name)
            if it is None:
                raise ScriptError(
                    f"next on non-loop/index variable {name}")
            it["pos"] += 1
            if it["pos"] >= len(it["values"]):
                exhausted = True
            else:
                self.variables[name] = it["values"][it["pos"]]
        if exhausted:
            for name in a:
                self.variables.pop(name, None)
                self._iter_vars.pop(name, None)
            self._skip_next_jump = True

    def cmd_if(self, a):
        """if "<cond>" then "<cmd>" ... [elif "<cond>" "<cmd>" ...]
        [else "<cmd>" ...] (input.cpp If::command)."""
        # split the arg list into (cond, commands) branches
        branches = []      # [(cond_str_or_None, [cmds])]
        if len(a) < 2 or a[1] != "then":
            raise ScriptError("if syntax: if <cond> then <cmds...>")
        cond, cmds, i = a[0], [], 2
        while i < len(a):
            tok = a[i]
            if tok == "elif":
                branches.append((cond, cmds))
                cond, cmds = a[i + 1], []
                i += 2
            elif tok == "else":
                branches.append((cond, cmds))
                cond, cmds = None, []
                i += 1
            else:
                cmds.append(tok)
                i += 1
        branches.append((cond, cmds))
        for cond, cmds in branches:
            if cond is None or self._eval_condition(cond):
                for c in cmds:
                    self.one(c)
                return

    def _eval_condition(self, cond: str) -> bool:
        """Boolean expression (variable.cpp evaluate): numeric comparisons
        and logicals via the equal-style grammar; `A == B` string equality
        as the fallback when the operands aren't numeric."""
        try:
            return bool(self._compile_expr(cond)())
        except Exception:
            for op in ("==", "!="):
                if op in cond:
                    lhs, rhs = (s.strip() for s in cond.split(op, 1))
                    return (lhs == rhs) if op == "==" else (lhs != rhs)
            raise

    def cmd_clear(self, a):
        """Reset the system between loop iterations; variables, the log fn,
        and the program counter survive (input.cpp clear)."""
        keep_vars = self.variables
        keep_iters = self._iter_vars
        keep_exprs = self.var_exprs
        prog, pc, path = self._prog, self._pc, self._path
        skip = self._skip_next_jump
        self.__init__(strict=self.strict, n_max=self.n_max,
                      cell_capacity=self.cell_capacity, log_fn=self.log,
                      device=self.device)
        self.variables = keep_vars
        self._iter_vars = keep_iters
        self.var_exprs = keep_exprs
        self._prog, self._pc, self._path = prog, pc, path
        self._skip_next_jump = skip

    def cmd_shell(self, a):
        pass  # deliberately inert: decks use it for mkdir/cd bookkeeping

    def cmd_variable(self, a):
        # variable name equal <expr>  |  variable name index <val>
        name, style = a[0], a[1]
        if style in ("equal", "internal"):
            expr = " ".join(a[2:])
            self.variables[name] = self._compile_expr(expr, name)
        elif style == "atom":
            # per-atom expression (variable.cpp atom style) over the
            # per-atom columns; evaluated lazily on the host when a
            # consumer (dump custom v_name column) samples it
            from . import expr as _expr
            try:
                self.atom_var_exprs[name] = _expr.parse(" ".join(a[2:]))
            except _expr.ExprError as e:
                raise ScriptError(str(e)) from None
        elif style == "index":
            # index does NOT overwrite an existing definition
            # (variable.cpp: loops survive `jump SELF` re-execution and the
            # -var CLI override mechanism works)
            if name not in self.variables:
                self._iter_vars[name] = {"values": list(a[2:]), "pos": 0}
                self.variables[name] = a[2]
        elif style == "loop":
            # variable N loop <n> [pad] | loop <n1> <n2> [pad]
            if name not in self.variables:
                rest = list(a[2:])
                pad = rest and rest[-1] == "pad"
                if pad:
                    rest = rest[:-1]
                lo, hi = (1, int(rest[0])) if len(rest) == 1 else (
                    int(rest[0]), int(rest[1]))
                width = len(str(hi)) if pad else 0
                vals = [str(i).zfill(width) for i in range(lo, hi + 1)]
                self._iter_vars[name] = {"values": vals, "pos": 0}
                self.variables[name] = vals[0]
        elif style == "string":
            self.variables[name] = a[2]
        elif style == "delete":
            self.variables.pop(name, None)
            self._iter_vars.pop(name, None)
        else:
            raise ScriptError(f"variable style {style} unsupported")

    def _compile_expr(self, expr: str, name: str = ""):
        """Equal-style expression evaluator: the LAMMPS-grammar Pratt
        parser (io/expr.py; variable.cpp:130-138 precedence, left-assoc
        `^`, fmod `%`, 1.0/0.0 logicals) parsed once per `variable`
        command."""
        from . import expr as _expr
        try:
            ast = _expr.parse(expr)
        except _expr.ExprError as e:
            raise ScriptError(str(e)) from None
        if name:
            self.var_exprs[name] = ast

        def fn():
            env = {"PI": math.pi, "time": self.total_steps * self.dt,
                   "step": self.total_steps, "dt": self.dt}
            try:
                return _expr.eval_ast(ast, env, _expr.host_backend(),
                                      resolve_var=self._eval_var_num)
            except _expr.ExprError as e:
                raise ScriptError(str(e)) from None
        return fn

    def _eval_traced(self, name: str, t):
        """Evaluate an equal-style variable with `time` bound to the
        simulation time t (a 0-dim tensor on the run's device), recursing
        into referenced variables."""
        from . import expr as _expr
        ast = self.var_exprs.get(name)
        if ast is None:
            v = self.variables.get(name)
            if v is None:
                raise ScriptError(f"undefined variable {name}")
            return float(v() if callable(v) else v)
        env = {"PI": math.pi, "time": t, "step": t / self.dt,
               "dt": self.dt}
        return _expr.eval_ast(ast, env,
                              _expr.torch_backend(t.dtype, t.device),
                              resolve_var=lambda nm:
                              self._eval_traced(nm, t))

    def cmd_lattice(self, a):
        # lattice fcc RHO  (lattice.cpp, lj units: a = (4/rho)^(1/3))
        if a[0] == "none":
            self.lattice = None
            return
        if a[0] != "fcc":
            raise ScriptError(f"lattice style {a[0]} unsupported (fcc)")
        rho = float(a[1])
        self.lattice = ("fcc", (4.0 / rho) ** (1.0 / 3.0))

    def cmd_create_box(self, a):
        # create_box N region-ID
        if a[1] not in self.regions:
            raise ScriptError(f"create_box: unknown region {a[1]}")
        if not isinstance(self.regions[a[1]], RegionBlock):
            raise ScriptError("create_box needs a block region "
                              "(domain.cpp: the box is an AABB)")
        self._create_box = (int(a[0]), self.regions[a[1]])

    def cmd_create_atoms(self, a):
        # create_atoms TYPE box|region ID - lattice fill (create_atoms.cpp)
        if self.lattice is None:
            raise ScriptError("create_atoms needs a lattice")
        if a[1] == "box":
            region = self._create_box[1]
        else:
            region = self.regions[a[2]]
        self._create_atoms.append((int(a[0]), region))

    def cmd_region(self, a):
        # region ID block xlo xhi ylo yhi zlo zhi [units box|lattice]
        # region ID sphere x y z R [units ...]       (region_sphere.cpp)
        # region ID cylinder dim c1 c2 R lo hi [...] (region_cylinder.cpp)
        # With a lattice defined, coordinates default to LATTICE units
        # (region.cpp scale handling).
        rid, style = a[0], a[1]
        nvals = {"block": 6, "sphere": 4, "cylinder": 5}.get(style)
        if nvals is None:
            raise ScriptError(
                f"region style {style} unsupported (block/sphere/cylinder)")
        args = a[2:]
        axis = None
        if style == "cylinder":
            axis = args[0]
            args = args[1:]
        vals = []
        for tok in args[:nvals]:
            if tok in ("EDGE", "INF"):
                raise ScriptError("EDGE/INF region bounds unsupported")
            vals.append(float(tok))
        rest = args[nvals:]
        units = "lattice" if self.lattice is not None else "box"
        if len(rest) >= 2 and rest[0] == "units":
            units = rest[1]
        if units == "lattice":
            if self.lattice is None:
                raise ScriptError("region units lattice without a lattice")
            vals = [v * self.lattice[1] for v in vals]
        if style == "block":
            self.regions[rid] = RegionBlock((vals[0], vals[2], vals[4]),
                                            (vals[1], vals[3], vals[5]))
        elif style == "sphere":
            from ..geometry import RegionSphere
            self.regions[rid] = RegionSphere(
                center=(vals[0], vals[1], vals[2]), radius=vals[3])
        else:
            from ..geometry import RegionCylinder
            self.regions[rid] = RegionCylinder(
                axis=axis, c1=vals[0], c2=vals[1], radius=vals[2],
                lo_axis=vals[3], hi_axis=vals[4])

    def cmd_pair_style(self, a):
        self.pair = _PairStyle(name=a[0], args=a[1:], coeffs=[])

    def cmd_pair_modify(self, a):
        # pair_modify shift yes|no (pair.cpp offset_flag)
        i = 0
        while i < len(a):
            if a[i] == "shift":
                self.pair_shift = a[i + 1] == "yes"
                i += 2
            else:
                raise ScriptError(f"pair_modify {a[i]} unsupported")

    def cmd_pair_coeff(self, a):
        if self.pair is None:
            raise ScriptError("pair_coeff before pair_style")
        self.pair.coeffs.append(list(a))

    def cmd_molecule(self, a):
        """`molecule ID file1 [file2 ...]` (molecule.cpp): load one or
        more template files under a template-set id, referenced by
        `fix obmd ... mol ID len` (multi-template sets pair with the
        `molfrac` keyword, fix_obmd_merged.cpp:2039-2054)."""
        from ..config import MolTemplate
        if len(a) < 2:
            raise ScriptError("molecule: need an id and >= 1 file")
        tpls = []
        for f in a[1:]:
            try:
                tpls.append(MolTemplate.from_file(f))
            except OSError as e:
                raise ScriptError(
                    f"molecule {a[0]}: cannot read '{f}': {e}") from e
        self.molecules[a[0]] = tuple(tpls)

    def cmd_bond_style(self, a):
        if a[0] not in ("harmonic", "fene"):
            raise ScriptError(f"bond style {a[0]} unsupported "
                              "(harmonic or fene)")
        self.bond_style = a[0]

    def cmd_bond_coeff(self, a):
        if self.bond_style is None:
            raise ScriptError("bond_coeff before bond_style")
        t = 1 if a[0] == "*" else int(a[0])
        self.bond_coeffs[t] = [float(v) for v in a[1:]]

    def cmd_angle_style(self, a):
        if a[0] != "harmonic":
            raise ScriptError(f"angle style {a[0]} unsupported (harmonic)")
        self.angle_style = a[0]

    def cmd_angle_coeff(self, a):
        if self.angle_style is None:
            raise ScriptError("angle_coeff before angle_style")
        t = 1 if a[0] == "*" else int(a[0])
        self.angle_coeffs[t] = (float(a[1]), float(a[2]))

    def cmd_dihedral_style(self, a):
        if a[0] != "harmonic":
            raise ScriptError(
                f"dihedral style {a[0]} unsupported (harmonic)")
        self.dihedral_style = a[0]

    def cmd_dihedral_coeff(self, a):
        if self.dihedral_style is None:
            raise ScriptError("dihedral_coeff before dihedral_style")
        t = 1 if a[0] == "*" else int(a[0])
        self.dihedral_coeffs[t] = (float(a[1]), int(a[2]), int(a[3]))

    def cmd_improper_style(self, a):
        if a[0] != "harmonic":
            raise ScriptError(
                f"improper style {a[0]} unsupported (harmonic)")
        self.improper_style = a[0]

    def cmd_improper_coeff(self, a):
        if self.improper_style is None:
            raise ScriptError("improper_coeff before improper_style")
        t = 1 if a[0] == "*" else int(a[0])
        self.improper_coeffs[t] = (float(a[1]), float(a[2]))

    def cmd_special_bonds(self, a):
        # the engines implement `special_bonds 0 1 1` semantics (1-2
        # excluded in-kernel); accept the matching spellings only
        pass

    def cmd_mass(self, a):
        self.masses[int(a[0])] = float(a[1])

    def cmd_read_data(self, a):
        self.data = lammps_data.read_data(a[0], atom_style=self.atom_style)

    def cmd_neighbor(self, a):
        self.skin = float(a[0])

    def cmd_neigh_modify(self, a):
        """`every N`, `delay N` and `check yes|no` set the run's relayout
        schedule (`_run`); the other keywords have no counterpart and are
        accepted."""
        i = 0
        while i < len(a):
            k = a[i]
            if k in ("every", "delay") and i + 1 < len(a):
                n = int(a[i + 1])
                if n < (1 if k == "every" else 0):
                    raise ScriptError(f"neigh_modify {k} {n}")
                setattr(self, f"neigh_{k}", n)
                i += 2
            elif k == "check" and i + 1 < len(a):
                if a[i + 1] not in ("yes", "no"):
                    raise ScriptError(f"neigh_modify check {a[i + 1]}")
                self.neigh_check = a[i + 1] == "yes"
                i += 2
            else:
                i += 1

    def cmd_timestep(self, a):
        self.dt = float(a[0])

    def cmd_thermo(self, a):
        self.thermo_every = int(a[0])

    def cmd_thermo_style(self, a):
        if a[0] == "custom":
            self.thermo_cols = a[1:]

    def cmd_dump(self, a):
        # dump ID group style N file [args]  -> xyz/custom supported
        self.dumps.append((a[0], a[2], int(a[3]), a[4], a[5:]))

    def cmd_undump(self, a):
        self.dumps = [d for d in self.dumps if d[0] != a[0]]

    def cmd_velocity(self, a):
        # velocity all create T seed | scale T | zero linear
        # (velocity.cpp subsets decks actually use)
        if a[1] == "create":
            self._velocity_create = (float(a[2]), int(a[3]))
        elif a[1] == "scale":
            self._velocity_ops.append(("scale", float(a[2])))
        elif a[1] == "zero" and a[2] == "linear":
            self._velocity_ops.append(("zero_linear", 0.0))
        else:
            raise ScriptError(
                "velocity: create T seed | scale T | zero linear")

    def cmd_group(self, a):
        # group ID type N [N...]  (group.cpp type-based membership, the
        # variant the fix obmd census consumes; other styles unsupported)
        gid, style = a[0], a[1]
        if style != "type":
            raise ScriptError(f"group style {style} unsupported (type)")
        self.groups[gid] = tuple(int(t) - 1 for t in a[2:])

    def cmd_compute(self, a):
        # compute ID group chunk/atom bin/1d x lower <delta> units box|reduced
        # (compute_chunk_atom.cpp: the 1d-bin pattern the OBMD profile
        # workflow uses; other compute styles are unsupported)
        cid, group, style = a[0], a[1], a[2]
        if style != "chunk/atom" or a[3] != "bin/1d":
            raise ScriptError(
                f"compute {style}: only chunk/atom bin/1d supported")
        axis = {"x": 0, "y": 1, "z": 2}[a[4]]
        if a[5] != "lower":
            raise ScriptError("compute chunk/atom: only `lower` origin")
        delta = float(a[6])
        units = "box"
        if len(a) > 8 and a[7] == "units":
            units = a[8]
        if units not in ("box", "reduced"):
            raise ScriptError("compute chunk/atom: units box|reduced")
        self.chunks[cid] = (axis, delta, units)

    def cmd_fix(self, a):
        fid, group, style = a[0], a[1], a[2]
        if style == "nve":
            return  # velocity-Verlet is the engine's integrator
        if style == "ave/chunk":
            # fix ID group ave/chunk Nevery Nrepeat Nfreq chunkID
            #     <density/number|vx|vy|vz|temp>... file <fname>
            nev, nrep, nfrq = int(a[3]), int(a[4]), int(a[5])
            cid = a[6]
            if cid not in self.chunks:
                raise ScriptError(f"ave/chunk: unknown chunk compute {cid}")
            vals, fname, i = [], None, 7
            while i < len(a):
                if a[i] == "file":
                    fname = a[i + 1]
                    i += 2
                    continue
                if a[i] not in ("density/number", "vx", "vy", "vz", "temp"):
                    raise ScriptError(f"ave/chunk value {a[i]} unsupported")
                vals.append(a[i])
                i += 1
            if fname is None:
                raise ScriptError("ave/chunk: file <name> required")
            self.ave_chunks.append(
                {"id": fid, "chunk": cid, "nevery": nev, "nrepeat": nrep,
                 "nfreq": nfrq, "values": vals, "file": fname,
                 "samples": [], "wrote_header": False})
            return
        if style == "obmd":
            self.obmd_args = a[3:]
            if group != "all":
                if group not in self.groups:
                    raise ScriptError(f"fix obmd: unknown group {group}")
                self.obmd_group = self.groups[group]
            return
        if style == "langevin":
            # fix ID group langevin Tstart Tstop damp seed
            # (fix_langevin.cpp; constant T only — a ramp needs the run
            # window inside the jitted step)
            t0, t1 = float(a[3]), float(a[4])
            if t0 != t1:
                raise ScriptError("fix langevin: temperature ramp "
                                  "unsupported (Tstart must equal Tstop)")
            from ..config import LangevinParams
            self.langevin = LangevinParams(temp=t0, damp=float(a[5]),
                                           seed=int(a[6]))
            return
        raise ScriptError(f"fix style {style} unsupported")

    def cmd_unfix(self, a):
        pass

    def cmd_min_style(self, a):
        if a[0] != "fire":
            raise ScriptError(
                f"min_style {a[0]} unsupported (fire; CG line searches are "
                "host-sequential and not implemented)")

    def cmd_minimize(self, a):
        # minimize etol ftol maxiter maxeval (min.cpp); maxeval folds into
        # maxiter here (one force evaluation per FIRE iteration)
        etol, ftol = float(a[0]), float(a[1])
        maxiter = int(a[2])
        if len(a) > 3:
            maxiter = min(maxiter, int(a[3]))
        self._build()
        from ..minimize import minimize as _minimize
        res = _minimize(self.cfg, self.state, ftol=ftol, etol=etol,
                        maxiter=maxiter)
        from ..integrate import rebuild_neighbors
        self.state = rebuild_neighbors(self.cfg, res.state)
        self.log(f"  minimize: {res.iters} iterations, fmax {res.fmax:.3e},"
                 f" energy {res.energy:.6g}")

    def cmd_run(self, a):
        n = int(a[0])
        self._build()
        # dpd/tstat T ramp covers each run's window like the reference
        # (pair_dpd_tstat.cpp:52-60 uses update->beginstep/endstep): pin
        # the static (begin, end) pair; the step recompiles per run, which
        # is the reference's own per-run semantic
        from ..config import DPDTstatParams
        if (isinstance(self.cfg.pair, DPDTstatParams)
                and self.cfg.pair.is_ramp):
            import dataclasses as _dc
            begin = int(self.state.step)
            self.cfg = _dc.replace(
                self.cfg, pair=_dc.replace(self.cfg.pair,
                                           ramp=(begin, begin + n)))
            self._thermo_fn = None
            self._runner_chunk = None   # cfg changed: rebuild the runner
        self._run(n)

    def cmd_write_data(self, a):
        self._build()
        st = self.state
        alive = _host(st.alive)
        # bond topology: slot partner columns -> unordered tag pairs
        bonds = None
        bcols = [_host(c) for c in st.bond_partners]
        tags_full = _host(st.tag)
        pairs = set()
        for i in np.nonzero(alive)[0]:
            for col in bcols:
                p = col[i]
                if p >= 0 and alive[p]:
                    t1, t2 = int(tags_full[i]), int(tags_full[p])
                    pairs.add((min(t1, t2), max(t1, t2)))
        if pairs:
            bonds = np.asarray(sorted(pairs))
        df = lammps_data.DataFile(
            natoms=int(alive.sum()), ntypes=self.cfg.ntypes,
            box_lo=np.asarray(self.cfg.box.lo), box_hi=np.asarray(self.cfg.box.hi),
            masses=np.asarray(self.cfg.masses),
            x=_host(st.x)[alive], types=_host(st.type)[alive],
            tags=tags_full[alive], v=_host(st.v)[alive],
            q=_host(st.q)[alive], mol=_host(st.mol)[alive],
            bonds=bonds)
        style = self.atom_style if self.atom_style in (
            "atomic", "charge", "full", "molecular", "bond",
            "adress") else "atomic"
        if bonds is not None and style in ("atomic", "charge"):
            style = "molecular"
        lammps_data.write_data(a[0], df, atom_style=style)

    def cmd_write_restart(self, a):
        self._build()
        from .checkpoint import save_checkpoint
        save_checkpoint(a[0], self.cfg, self.state)

    def cmd_read_restart(self, a):
        """Load the state and configuration, carry the step count on
        (read_restart.cpp restores the timestep) and rebuild the layout,
        which a checkpoint does not hold, so a `run` can follow.  A
        checkpoint of a float64 scene is refused (FLOAT64_DECK)."""
        from ..integrate import rebuild_neighbors
        from .checkpoint import load_checkpoint
        cfg, state = load_checkpoint(a[0], device=self.device)
        if cfg.dtype != "float32":
            raise NotImplementedError(FLOAT64_DECK)
        self.cfg = cfg
        self.state = rebuild_neighbors(self.cfg, state)
        self.dt = self.cfg.dt
        self.total_steps = self.state.step
        self._thermo_fn = None
        self._runner_chunk = None

    # ---------------- engine assembly ----------------

    def _param(self, tok: str):
        """Positional fix-obmd param: number or v_name equal-variable
        (fix_obmd_merged.cpp:88-168)."""
        if tok.startswith("v_"):
            name = tok[2:]
            fn = self.variables.get(name)
            if fn is None:
                raise ScriptError(f"undefined variable {name}")
            if not self._uses_time(name):
                return float(fn() if callable(fn) else fn)
            # time-dependent equal variable: a function of the stage's
            # simulation time, a 0-dim tensor on the run's device (the
            # reference re-evaluates v_ params every pre_exchange,
            # fix_obmd_merged.cpp:563-572).  One evaluation at build makes
            # an unsupported construct fail HERE, not silently.
            param = lambda t, _n=name: self._eval_traced(_n, t)
            try:
                param(torch.zeros((), dtype=torch.float32,
                                  device=self.device))
            except ScriptError:
                raise
            except Exception as e:
                raise ScriptError(
                    f"variable {name} cannot be traced as a function of "
                    f"time: {e}") from e
            return param
        return float(tok)

    def _uses_time(self, name, _seen=None) -> bool:
        """True when the equal-style expression (transitively) references
        `time` or `step`."""
        from . import expr as _expr
        _seen = _seen or set()
        if name in _seen:
            return False
        _seen.add(name)
        ast = self.var_exprs.get(name)
        if ast is None:
            return False
        if _expr.names_in(ast) & {"time", "step"}:
            return True
        return any(self._uses_time(m, _seen)
                   for m in _expr.var_refs(ast))

    def _build_pair(self, ntypes: int):
        p = self.pair
        if p is None:
            raise ScriptError("no pair_style given")

        def full(tabname, default=0.0):
            return np.full((ntypes, ntypes), default)

        if p.name == "dpd":
            temp, rc = float(p.args[0]), float(p.args[1])
            seed = int(p.args[2]) if len(p.args) > 2 else 1
            a0, gam, cut = full("a0"), full("g"), np.full((ntypes, ntypes), rc)
            for c in p.coeffs:
                ti, tj = self._type_range(c[0], ntypes), self._type_range(c[1], ntypes)
                for i in ti:
                    for j in tj:
                        a0[i, j] = a0[j, i] = float(c[2])
                        gam[i, j] = gam[j, i] = float(c[3])
                        if len(c) > 4:
                            cut[i, j] = cut[j, i] = float(c[4])
            return DPDParams.create(temp=temp, cutoff=rc, seed=seed, a0=a0,
                                    gamma=gam, cut=cut, ntypes=ntypes)
        if p.name == "dpd/tstat":
            # pair_style dpd/tstat T_start T_stop rc seed
            # (pair_dpd_tstat.cpp:143-153); coeff: gamma [cut]
            from ..config import DPDTstatParams
            t0, t1 = float(p.args[0]), float(p.args[1])
            rc = float(p.args[2])
            seed = int(p.args[3]) if len(p.args) > 3 else 1
            gam, cut = full("g"), np.full((ntypes, ntypes), rc)
            for c in p.coeffs:
                ti, tj = (self._type_range(c[0], ntypes),
                          self._type_range(c[1], ntypes))
                for i in ti:
                    for j in tj:
                        gam[i, j] = gam[j, i] = float(c[2])
                        if len(c) > 3:
                            cut[i, j] = cut[j, i] = float(c[3])
            return DPDTstatParams.create(t_start=t0, t_stop=t1, cutoff=rc,
                                         seed=seed, gamma=gam, cut=cut,
                                         ntypes=ntypes)
        if p.name in ("dpd/ext", "dpd/ext/tstat"):
            # pair_style dpd/ext T rc seed (pair_dpd_ext.cpp:244-250);
            # coeff: a0 gamma gammaT ws wsT [cut] (:275-310).
            # dpd/ext/tstat: T_start T_stop rc seed, coeff without a0.
            from ..config import DPDExtParams
            tstat = p.name.endswith("tstat")
            if tstat:
                t0, t1 = float(p.args[0]), float(p.args[1])
                if t0 != t1:
                    raise ScriptError(
                        "dpd/ext/tstat temperature ramp unsupported")
                rc = float(p.args[2])
                seed = int(p.args[3]) if len(p.args) > 3 else 1
            else:
                t0 = float(p.args[0])
                rc = float(p.args[1])
                seed = int(p.args[2]) if len(p.args) > 2 else 1
            a0 = full("a0")
            gam, gamT = full("g"), full("gT")
            ws, wsT = np.ones((ntypes, ntypes)), np.ones((ntypes, ntypes))
            cut = np.full((ntypes, ntypes), rc)
            for c in p.coeffs:
                ti, tj = (self._type_range(c[0], ntypes),
                          self._type_range(c[1], ntypes))
                vals = [float(v) for v in c[2:]]
                if tstat:
                    vals = [0.0] + vals        # no a0 column
                for i in ti:
                    for j in tj:
                        a0[i, j] = a0[j, i] = vals[0]
                        gam[i, j] = gam[j, i] = vals[1]
                        gamT[i, j] = gamT[j, i] = vals[2]
                        ws[i, j] = ws[j, i] = vals[3]
                        wsT[i, j] = wsT[j, i] = vals[4]
                        if len(vals) > 5:
                            cut[i, j] = cut[j, i] = vals[5]
            return DPDExtParams.create(temp=t0, cutoff=rc, seed=seed, a0=a0,
                                       gamma=gam, gammaT=gamT, ws=ws,
                                       wsT=wsT, cut=cut, ntypes=ntypes,
                                       tstat_only=tstat)
        if p.name == "lj/cut":
            rc = float(p.args[0])
            eps, sig, cut = full("e"), full("s"), np.full((ntypes, ntypes), rc)
            for c in p.coeffs:
                ti, tj = self._type_range(c[0], ntypes), self._type_range(c[1], ntypes)
                for i in ti:
                    for j in tj:
                        eps[i, j] = eps[j, i] = float(c[2])
                        sig[i, j] = sig[j, i] = float(c[3])
                        if len(c) > 4:
                            cut[i, j] = cut[j, i] = float(c[4])
            self._mix_geometric(eps, sig, p.coeffs, ntypes)
            return LJCutParams.create(cutoff=rc, epsilon=eps, sigma=sig,
                                      cut=cut, ntypes=ntypes,
                                      shift=self.pair_shift)
        if p.name == "lj/cut/rf":
            rc_lj = float(p.args[0])
            rc_rf = float(p.args[1]) if len(p.args) > 1 else rc_lj
            eps, sig = full("e"), full("s")
            cut = np.full((ntypes, ntypes), rc_lj)
            erf = np.full((ntypes, ntypes), 1.0)
            for c in p.coeffs:
                ti, tj = self._type_range(c[0], ntypes), self._type_range(c[1], ntypes)
                for i in ti:
                    for j in tj:
                        eps[i, j] = eps[j, i] = float(c[2])
                        sig[i, j] = sig[j, i] = float(c[3])
                        # optional: cut_lj, eps_rf (settings() :254)
                        if len(c) == 5:
                            erf[i, j] = erf[j, i] = float(c[4])
                        elif len(c) >= 6:
                            cut[i, j] = cut[j, i] = float(c[4])
                            erf[i, j] = erf[j, i] = float(c[5])
            return LJCutRFParams.create(cut_lj=rc_lj, cut_coul=rc_rf,
                                        epsilon=eps, sigma=sig, eps_rf=erf,
                                        cut=cut, ntypes=ntypes)
        raise ScriptError(f"pair style {p.name} unsupported")

    @staticmethod
    def _mix_geometric(eps, sig, coeffs, ntypes):
        """LJ geometric mixing for unset cross terms (pair.cpp mix_energy)."""
        explicit = set()
        for c in coeffs:
            for i in Interpreter._type_range(c[0], ntypes):
                for j in Interpreter._type_range(c[1], ntypes):
                    explicit.add((min(i, j), max(i, j)))
        for i in range(ntypes):
            for j in range(i + 1, ntypes):
                if (i, j) not in explicit:
                    eps[i, j] = eps[j, i] = math.sqrt(eps[i, i] * eps[j, j])
                    sig[i, j] = sig[j, i] = 0.5 * (sig[i, i] + sig[j, j])

    @staticmethod
    def _type_range(tok: str, ntypes: int):
        if tok == "*":
            return range(ntypes)
        if "*" in tok:
            lo, hi = tok.split("*")
            lo = int(lo) - 1 if lo else 0
            hi = int(hi) - 1 if hi else ntypes - 1
            return range(lo, hi + 1)
        return [int(tok) - 1]

    def _build_bond(self):
        if self.bond_style is None:
            return None
        from ..config import BondFENEParams, BondHarmonicParams
        if not self.bond_coeffs:
            raise ScriptError("bond_style given but no bond_coeff")
        sets = {tuple(v) for v in self.bond_coeffs.values()}
        if len(sets) > 1:
            raise ScriptError("one bond type supported (identical coeffs)")
        c = next(iter(sets))
        if self.bond_style == "fene":
            if len(c) != 4:
                raise ScriptError("bond_coeff fene: K R0 eps sigma")
            return BondFENEParams(k=c[0], r0=c[1], epsilon=c[2], sigma=c[3])
        if len(c) != 2:
            raise ScriptError("bond_coeff harmonic: K r0")
        return BondHarmonicParams(k=c[0], r0=c[1])

    def _build_angle(self, ntypes: int, obmd=None):
        if self.angle_style is None:
            return None
        if not self.angle_coeffs:
            raise ScriptError("angle_style given but no angle_coeff")
        from ..config import AngleHarmonicParams, derive_center_angle_table
        tables = []
        d = self.data
        if d.angles is not None:
            if d.bonds is None:
                raise ScriptError("Angles section without Bonds")
            atom_types = {int(t): int(ty)
                          for t, ty in zip(d.tags, d.types)}
            tables.append(derive_center_angle_table(
                ntypes, [tuple(r) for r in d.angles], atom_types,
                [tuple(r) for r in d.bonds], dict(self.angle_coeffs)))
        mol = getattr(obmd, "mol", None)
        if mol is not None and mol.angles:
            atom_types = {i: int(t) for i, t in enumerate(mol.types)}
            tables.append(derive_center_angle_table(
                ntypes, list(mol.angles), atom_types,
                list(mol.bonds), dict(self.angle_coeffs)))
        if not tables:
            return None
        k = [0.0] * ntypes
        t0 = [0.0] * ntypes
        for tab in tables:
            for t in range(ntypes):
                if tab.k[t] == 0.0:
                    continue
                if k[t] not in (0.0, tab.k[t]) or (k[t] != 0.0
                                                   and t0[t] != tab.theta0[t]):
                    raise ScriptError(
                        f"conflicting angle coefficients for center atom "
                        f"type {t + 1} between data file and template")
                k[t] = tab.k[t]
                t0[t] = tab.theta0[t]
        return AngleHarmonicParams(k=tuple(k), theta0=tuple(t0))

    def _build_improper(self, ntypes: int, obmd=None):
        if self.improper_style is None:
            return None
        if not self.improper_coeffs:
            raise ScriptError("improper_style given but no improper_coeff")
        from ..config import (ImproperHarmonicParams,
                              derive_center_improper_table)
        tables = []
        d = self.data
        if d is not None and getattr(d, "impropers", None) is not None:
            atom_types = {int(t): int(ty)
                          for t, ty in zip(d.tags, d.types)}
            tables.append(derive_center_improper_table(
                ntypes, [tuple(r) for r in d.impropers], atom_types,
                dict(self.improper_coeffs)))
        mol = getattr(obmd, "mol", None)
        if mol is not None and getattr(mol, "impropers", ()):
            atom_types = {i: int(t) for i, t in enumerate(mol.types)}
            tables.append(derive_center_improper_table(
                ntypes, list(mol.impropers), atom_types,
                dict(self.improper_coeffs)))
        if not tables:
            return None
        k = [0.0] * ntypes
        x0 = [0.0] * ntypes
        for tab in tables:
            for t in range(ntypes):
                if tab.k[t] == 0.0:
                    continue
                if k[t] not in (0.0, tab.k[t]) or (k[t] != 0.0
                                                   and x0[t] != tab.chi0[t]):
                    raise ScriptError(
                        f"conflicting improper coefficients for center "
                        f"atom type {t + 1} between data file and template")
                k[t] = tab.k[t]
                x0[t] = tab.chi0[t]
        return ImproperHarmonicParams(k=tuple(k), chi0=tuple(x0))

    def _build_dihedral(self, obmd=None):
        if self.dihedral_style is None:
            return None
        if not self.dihedral_coeffs:
            raise ScriptError("dihedral_style given but no dihedral_coeff")
        from ..config import DihedralHarmonicParams
        sets = set(self.dihedral_coeffs.values())
        if len(sets) > 1:
            raise ScriptError("one dihedral type supported "
                              "(identical coefficients)")
        k, d, nn = next(iter(sets))
        params = DihedralHarmonicParams(k=k, d=d, n=nn)
        # validate declared dihedrals against the implicit chain quadruples
        def check(dihs, bonds, where):
            bond_set = set()
            for i, j in bonds:
                bond_set.add((int(i), int(j)))
                bond_set.add((int(j), int(i)))
            for row in dihs:
                _t, a1, a2, a3, a4 = (int(v) for v in row)
                for e in ((a1, a2), (a2, a3), (a3, a4)):
                    if e not in bond_set:
                        raise ScriptError(
                            f"dihedral {a1}-{a2}-{a3}-{a4} in {where}: "
                            "the center-bond storage needs chain "
                            "quadruples (every edge bonded)")
        d_ = self.data
        if d_ is not None and d_.dihedrals is not None:
            if d_.bonds is None:
                raise ScriptError("Dihedrals section without Bonds")
            check(d_.dihedrals, d_.bonds, "data file")
        mol = getattr(obmd, "mol", None)
        if mol is not None and getattr(mol, "dihedrals", ()):
            check(mol.dihedrals,
                  [(a + 1, b + 1) for a, b in mol.bonds], "template")
        return params

    def _build_obmd(self) -> Optional[ObmdParams]:
        if self.obmd_args is None:
            return None
        a = self.obmd_args
        # positional: ntype nfreq seed pxx pxy pxz dpxx freq alpha tau nbuf
        pos = a[:11]
        kw = a[11:]
        params = dict(
            ntype=int(pos[0]) - 1, nfreq=int(pos[1]), seed=int(pos[2]),
            pxx=self._param(pos[3]), pxy=self._param(pos[4]),
            pxz=self._param(pos[5]), dpxx=self._param(pos[6]),
            freq=self._param(pos[7]), alpha=self._param(pos[8]),
            tau=self._param(pos[9]), nbuf=self._param(pos[10]))
        usher = None
        near = None
        i = 0
        while i < len(kw):
            k = kw[i]
            if k.startswith("region"):
                reg = self.regions[kw[i + 1]]
                if not isinstance(reg, RegionBlock):
                    raise ScriptError(
                        f"fix obmd {k}: buffer regions must be blocks "
                        "(the slab-sliced stage math is axis-aligned); "
                        f"{kw[i + 1]} is {type(reg).__name__}")
                params[k] = reg
                i += 2
            elif k == "buffersize":
                params["buffer_size"] = float(kw[i + 1]); i += 2
            elif k == "gfac":
                params["g_fac"] = float(kw[i + 1]); i += 2
            elif k == "stepparallel":
                if int(kw[i + 1]) != 0:
                    raise ScriptError("only stepparallel 0 supported (ref :2013)")
                i += 2
            elif k == "stepperp":
                if int(kw[i + 1]) != 1:
                    raise ScriptError("only stepperp 1 supported (ref :2019)")
                i += 2
            elif k == "maxattempt":
                params["maxattempt"] = int(kw[i + 1]); i += 2
            elif k == "usher":
                flag = int(kw[i + 1])
                vals = kw[i + 2:i + 8]
                if flag:
                    usher = UsherParams(etarget=float(vals[0]),
                                        ds0=float(vals[1]),
                                        dtheta0=float(vals[2]),
                                        uovlp=float(vals[3]),
                                        dsovlp=float(vals[4]),
                                        eps=float(vals[5]),
                                        nattempt=int(kw[i + 8]))
                i += 9
            elif k == "near":
                flag = int(kw[i + 1])
                if flag:
                    near = float(kw[i + 2])
                i += 3
            elif k == "charged":
                params["charged"] = bool(int(kw[i + 1])); i += 2
            elif k == "mol":
                from ..config import MolTemplate
                ref = kw[i + 1]
                if ref in self.molecules:
                    tpls = self.molecules[ref]
                else:
                    try:
                        tpls = (MolTemplate.from_file(ref),)
                    except OSError as e:
                        raise ScriptError(
                            f"fix obmd mol: '{ref}' is neither a molecule "
                            f"id nor a readable template file: {e}") from e
                params["mol"] = tpls[0]
                if len(tpls) > 1:
                    params["mols"] = tpls
                params["mol_len"] = int(kw[i + 2])
                i += 3
            elif k == "molfrac":
                # molfrac f1 .. fN, one per template (ref :2045-2052)
                nt = len(params.get("mols", ())) or 1
                params["molfrac"] = tuple(float(v)
                                          for v in kw[i + 1:i + 1 + nt])
                i += 1 + nt
            elif k == "gaussian":
                # gaussian xmid ymid zmid sigma (ref :2128-2136, draws at
                # :930-932)
                params["gaussian"] = tuple(float(v) for v in kw[i + 1:i + 5])
                i += 5
            elif k in ("vx", "vy", "vz"):
                # vx/vy/vz lo hi: inserted-velocity draw range (ref
                # :2118-2130; the reference parses these but hardcodes
                # vnew=0 at :1076-1078 — here they are honored)
                params[k] = (float(kw[i + 1]), float(kw[i + 2]))
                i += 3
            elif k == "target":
                # target tx ty tz: point inserted velocities at a target,
                # preserving magnitude (ref :2157-2161, applied :1081-1093)
                params["target"] = tuple(float(v) for v in kw[i + 1:i + 4])
                i += 4
            elif k == "orient":
                # orient rx ry rz: fixed molecule rotation axis (:2121-2127)
                params["orient"] = tuple(float(v) for v in kw[i + 1:i + 4])
                i += 4
            elif k == "id":
                # id max|next: tag policy (:2086-2092)
                pol = kw[i + 1]
                if pol not in ("max", "next"):
                    raise ScriptError(f"fix obmd id {pol}: use max|next")
                params["id_policy"] = pol
                i += 2
            elif k == "units":
                # units box|lattice (:2137-2143); no lattice support
                if kw[i + 1] != "box":
                    raise ScriptError(
                        "fix obmd units lattice: no lattice engine; use "
                        "units box")
                i += 2
            elif k == "global":
                # global lo hi: candidate z reset to lo..hi above the
                # highest alive atom (fix-deposit semantics, ref :947-985)
                params["deposit_global"] = (float(kw[i + 1]),
                                            float(kw[i + 2]))
                i += 3
            elif k == "local":
                # local lo hi delta: as global but over atoms within
                # lateral distance delta of the candidate
                params["deposit_local"] = (float(kw[i + 1]),
                                           float(kw[i + 2]),
                                           float(kw[i + 3]))
                i += 4
            elif k == "rate":
                # rate r: candidate z offset grows linearly in time
                # (ref :880,2114)
                params["rate"] = float(kw[i + 1])
                i += 2
            elif k == "rigid":
                # ref hooks insertion into a named fix rigid
                # (fix_obmd_merged.cpp:475-500,1163-1168); here the engine
                # itself integrates every mol != 0 atom as a rigid body
                # (rigid.py), so the fix-ID operand is accepted and
                # SceneConfig.rigid set; a template whose bonds close a
                # cycle is refused (SceneConfig.finalize)
                params["rigid"] = True
                i += 2
            elif k == "shake":
                # ref hands inserted molecules to a named SHAKE fix
                # (fix_obmd_merged.cpp:1163-1168); here the engine itself
                # constrains template distances with SHAKE/RATTLE
                # (shake.py; SceneConfig.finalize derives the d0 table
                # from the template geometry), so the fix-ID operand is
                # accepted and constraints are enabled
                params["shake"] = True
                i += 2
            else:
                if self.strict:
                    raise ScriptError(f"fix obmd keyword {k} unsupported")
                i += 2
        params["usher"] = usher
        params["near"] = near
        if self.obmd_group is not None:
            params["group_types"] = self.obmd_group
        return ObmdParams(**params)

    def _synth_lattice_data(self):
        """create_box + create_atoms: synthesize a DataFile by filling the
        create_atoms regions with fcc lattice points (create_atoms.cpp
        lattice fill; half-open upper bound so periodic images are not
        duplicated)."""
        ntypes, boxreg = self._create_box
        a = self.lattice[1]
        basis = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                            [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
        lo = np.asarray(boxreg.lo)
        hi = np.asarray(boxreg.hi)
        xs, types = [], []
        for atype, region in self._create_atoms:
            rlo = np.asarray(region.lo)
            rhi = np.asarray(region.hi)
            n0 = np.floor((rlo - lo) / a).astype(int)
            n1 = np.ceil((rhi - lo) / a).astype(int) + 1
            cells = np.stack(np.meshgrid(
                np.arange(n0[0], n1[0]), np.arange(n0[1], n1[1]),
                np.arange(n0[2], n1[2]), indexing="ij"),
                axis=-1).reshape(-1, 1, 3)
            pts = (lo + (cells + basis[None, :, :]) * a).reshape(-1, 3)
            eps = 1e-9
            if isinstance(region, RegionBlock):
                keep = np.all((pts >= rlo - eps) & (pts < rhi - eps),
                              axis=1)
            else:
                # curved regions (sphere/cylinder): Region::match semantics
                keep = region.match(torch.from_numpy(
                    pts.astype(np.float64))).numpy()
            pts = pts[keep]
            xs.append(pts)
            types.append(np.full(len(pts), atype - 1, np.int32))
        x = np.concatenate(xs)
        t = np.concatenate(types)
        self.data = lammps_data.DataFile(
            natoms=len(x), ntypes=ntypes, box_lo=lo, box_hi=hi,
            masses=np.asarray([self.masses.get(i + 1, 1.0)
                               for i in range(ntypes)]),
            x=x, types=t, tags=np.arange(1, len(x) + 1, dtype=np.int32))

    def _build(self):
        if self.cfg is not None:
            return
        if self.data is None and self._create_box is not None \
                and self._create_atoms:
            self._synth_lattice_data()
        if self.data is None:
            raise ScriptError("no read_data before run "
                              "(or create_box + create_atoms)")
        periodic = tuple(b == "p" for b in self.boundary)
        box = self.data.box(periodic)
        ntypes = self.data.ntypes
        masses = list(self.data.masses)
        for t, mv in self.masses.items():
            masses[t - 1] = mv
        pair = self._build_pair(ntypes)
        obmd = self._build_obmd()
        bond = self._build_bond()
        angle = self._build_angle(ntypes, obmd)
        dihedral = self._build_dihedral(obmd)
        improper = self._build_improper(ntypes, obmd)
        branched = bool(
            self.data.bonds is not None and len(self.data.bonds)
            and np.bincount(np.asarray(self.data.bonds).ravel()).max() > 2)
        n = self.data.natoms
        n_max = self.n_max or (int(n * 1.3) if obmd is not None else n)
        # Verlet row capacity from the density (the default 48 silently
        # clips dense/long-cutoff scenes: dropped pairs inject energy —
        # caught by check_invariants, but size it right up front)
        rho = n / max(box.volume, 1e-30)
        rlist = pair.max_cut + max(self.skin, 0.0)
        # 2.1x the uniform mean: a perfect lattice packs whole neighbor
        # shells right at the list radius (fcc at rho*=0.84 counts 134
        # within 1.67a vs the uniform estimate 77)
        k_est = int(2.1 * (4.0 / 3.0) * math.pi * rlist ** 3 * rho) + 8
        max_neigh = max(48, k_est)
        # cell capacity from the ACTUAL cell volume: the grid uses
        # floor(L/rlist) cells per axis, so cells can be up to ~2x rlist
        # wide on small boxes (Poisson max over cells ~ mean + 4.5 sqrt)
        occ = rho
        for L in box.lengths:
            nax = max(1, int(math.floor(L / rlist)))
            occ *= L / nax
        cell_cap = max(self.cell_capacity,
                       int(occ + 4.5 * math.sqrt(max(occ, 1.0))) + 4)
        self.cfg = SceneConfig(
            box=box, masses=tuple(masses), pair=pair, dt=self.dt,
            capacity=Capacity(n_max=n_max, cell_capacity=cell_cap,
                              max_neighbors=max_neigh),
            obmd=obmd, bond=bond, angle=angle, dihedral=dihedral,
            improper=improper, branched_topology=branched,
            langevin=self.langevin,
            skin=max(self.skin, 0.0)).finalize()
        # pick the fastest engine this scene supports: the port's own
        # test, which admits more than the JAX package's (dpd/tstat runs
        # on the cellpad engine here)
        from ..engine_cellpad import supports
        if supports(self.cfg):
            import dataclasses as _dc
            self.cfg = _dc.replace(self.cfg, force_path="cellpad")
        else:
            import dataclasses as _dc
            self.cfg = _dc.replace(self.cfg, force_path="nlist")

        from ..state import init_state
        v = self.data.v
        if getattr(self, "_velocity_create", None) is not None:
            temp, seed = self._velocity_create
            r = np.random.default_rng(seed)
            v = r.normal(0, math.sqrt(temp), (n, 3))
            v -= v.mean(axis=0)
            # velocity.cpp rescales to the exact requested temperature
            t_cur = (v ** 2).sum() / max(3 * n - 3, 1)
            if t_cur > 0:
                v *= math.sqrt(temp / t_cur)
        for op, val in self._velocity_ops:
            if v is None:
                v = np.zeros((n, 3))
            v = np.asarray(v, float)
            if op == "zero_linear":
                v = v - v.mean(axis=0)
            elif op == "scale":
                t_cur = (v ** 2).sum() / max(3 * n - 3, 1)
                if t_cur > 0:
                    v = v * math.sqrt(val / t_cur)
        self.state = init_state(self.cfg, self.data.x, v=v,
                                device=self.device,
                                types=self.data.types, tags=self.data.tags,
                                q=self.data.q, mol=self.data.mol,
                                bonds=self.data.bonds
                                if self.bond_style is not None else None,
                                impropers=getattr(self.data, "impropers",
                                                  None))
        from ..integrate import setup
        self.state = setup(self.cfg, self.state)

    def _run(self, n: int):
        """Advance n steps in chunks of the gcd of every output cadence.
        The relayout schedule follows neigh_modify: under `check yes` (the
        default) every step runs through the per-step runner, which tests
        the half skin each step and relays out when it trips (LAMMPS' own
        rule; the JAX Interpreter runs one static schedule instead); under
        `check no` each chunk runs through make_run with a relayout every
        `every` steps, cut to the auto half-skin period where `every` is
        longer (a cellpad layout cannot run stale past the half skin, where
        a LAMMPS list runs on unchecked).  A cadence under 4 steps takes
        the per-step runner either way."""
        import math as _m
        from ..engine_cellpad import auto_rebuild_every
        from ..integrate import make_run, make_step
        from ..observe import make_thermo_fn
        if self._thermo_fn is None:
            self._thermo_fn = make_thermo_fn(self.cfg)
        intervals = [self.thermo_every] \
            + [d[2] for d in self.dumps] \
            + [ac["nevery"] for ac in self.ave_chunks]
        cadence = 0
        for iv in intervals:
            if iv:
                cadence = _m.gcd(cadence, int(iv))
        if cadence == 0:
            cadence = n
        fused = cadence >= 4 and not self.neigh_check
        if fused:
            cfg = self.cfg
            if cfg.force_path == "cellpad":
                cfg = dataclasses.replace(cfg, rebuild_every=min(
                    self.neigh_every, auto_rebuild_every(cfg)))
            if getattr(self, "_runner_chunk", None) != (cadence, cfg):
                self._runner = make_run(cfg, cadence)
                self._runner_chunk = (cadence, cfg)
            step = None
        else:
            step = make_step(self.cfg)
        self._emit_thermo()
        emitted_last = False
        done = 0
        while done < n:
            if fused and n - done >= cadence:
                self.state = self._runner(self.state)
                adv = cadence
            else:
                if step is None:
                    step = make_step(self.cfg)
                self.state = step(self.state)
                adv = 1
            self.total_steps += adv
            done += adv
            emitted_last = (self.thermo_every
                            and self.total_steps % self.thermo_every == 0)
            if emitted_last:
                self._emit_thermo()
            for (_id, _style, every, fname, dargs) in self.dumps:
                if every and self.total_steps % every == 0:
                    self._write_dump(fname, _style, dargs)
            for ac in self.ave_chunks:
                if self.total_steps % ac["nevery"] == 0:
                    ac["samples"].append(self._chunk_sample(ac))
                    ac["samples"] = ac["samples"][-ac["nrepeat"]:]
                if self.total_steps % ac["nfreq"] == 0 and ac["samples"]:
                    self._write_ave_chunk(ac)
        if not emitted_last:
            self._emit_thermo()
        # loud validity gate (bench.py policy): a deck run that dropped
        # pairs or ran on a stale layout must fail, not drift silently
        from ..observe import check_invariants
        check_invariants(self.cfg, self.state)

    def _emit_thermo(self):
        th = self._thermo_fn(self.state)
        vals = []
        for c in self.thermo_cols:
            v = self._thermo_keyword(c, th)
            if v is None and c.startswith("v_") and \
                    c[2:] in self.variables:
                v = self._eval_var(c[2:])
            vals.append(f"{v}" if v is not None else "NA")
        self.log("  ".join([*vals]))

    def _thermo_keyword(self, c: str, th):
        """thermo_style custom keyword surface (thermo.cpp:2211 dispatch;
        the subset with meaning in this engine: state/energy/pressure/
        geometry/time keywords)."""
        box = self.cfg.box
        import time as _time
        simple = {
            "step": lambda: int(th.step),
            "elapsed": lambda: int(th.step),    # since run start ~ step
            "dt": lambda: self.dt,
            "time": lambda: self.total_steps * self.dt,
            "cpu": lambda: _time.process_time(),
            "atoms": lambda: int(th.natoms),
            "temp": lambda: float(th.temp),
            "pe": lambda: float(th.pe),
            "ke": lambda: float(th.ke),
            "etotal": lambda: float(th.pe + th.ke),
            "epair": lambda: float(th.epair),
            "ebond": lambda: float(th.ebond),
            "eangle": lambda: float(th.eangle),
            "edihed": lambda: float(th.edihed),
            "eimp": lambda: float(th.eimp),
            "emol": lambda: float(th.ebond + th.eangle + th.edihed
                                  + th.eimp),
            "press": lambda: float(th.pressure),
            "pxx": lambda: float(th.press_tensor[0]),
            "pyy": lambda: float(th.press_tensor[1]),
            "pzz": lambda: float(th.press_tensor[2]),
            "pxy": lambda: float(th.press_tensor[3]),
            "pxz": lambda: float(th.press_tensor[4]),
            "pyz": lambda: float(th.press_tensor[5]),
            "enthalpy": lambda: float(th.pe + th.ke
                                      + th.pressure * box.volume),
            "fmax": lambda: float(th.fmax),
            "fnorm": lambda: float(th.fnorm),
            "vol": lambda: float(box.volume),
            "density": lambda: self._mass_density(th),
            "lx": lambda: float(box.lengths[0]),
            "ly": lambda: float(box.lengths[1]),
            "lz": lambda: float(box.lengths[2]),
            "xlo": lambda: float(box.lo[0]),
            "xhi": lambda: float(box.hi[0]),
            "ylo": lambda: float(box.lo[1]),
            "yhi": lambda: float(box.hi[1]),
            "zlo": lambda: float(box.lo[2]),
            "zhi": lambda: float(box.hi[2]),
        }
        fn = simple.get(c)
        return fn() if fn is not None else None

    def _mass_density(self, th):
        """total mass / volume (thermo.cpp density, lj units)."""
        st = self.state
        alive = _host(st.alive)
        masses = np.asarray(self.cfg.masses)
        m = masses[_host(st.type)[alive]].sum()
        return float(m / self.cfg.box.volume)

    def eval_atom_var(self, name):
        """Evaluate an atom-style variable over the ALIVE atoms (host-side
        numpy, like the reference's lazily computed atom vectors)."""
        import math as _math

        from . import expr as _expr
        ast = self.atom_var_exprs.get(name)
        if ast is None:
            raise ScriptError(f"undefined atom-style variable {name}")
        st = self.state
        alive = _host(st.alive)
        x = _host(st.x)[alive]
        v = _host(st.v)[alive]
        f = _host(st.f)[alive]
        masses = np.asarray(self.cfg.masses)
        types = _host(st.type)[alive]
        env = {"PI": _math.pi,
               "x": x[:, 0], "y": x[:, 1], "z": x[:, 2],
               "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
               "fx": f[:, 0], "fy": f[:, 1], "fz": f[:, 2],
               "id": _host(st.tag)[alive],
               "type": types + 1,
               "mass": masses[types],
               "q": _host(st.q)[alive],
               "mol": _host(st.mol)[alive],
               "time": self.total_steps * self.dt,
               "step": self.total_steps, "dt": self.dt}

        def _V(nm):
            if nm in self.atom_var_exprs:
                return self.eval_atom_var(nm)
            return self._eval_var_num(nm)
        try:
            out = _expr.eval_ast(ast, env, _expr.numpy_backend(),
                                 resolve_var=_V)
        except _expr.ExprError as e:
            raise ScriptError(str(e)) from None
        return np.asarray(out)

    def _chunk_sample(self, ac):
        """One per-bin sample: (count, sum m v^2, sum vx, vy, vz)."""
        axis, delta, units = self.chunks[ac["chunk"]]
        box = self.cfg.box
        lo, hi = box.lo[axis], box.hi[axis]
        width = (hi - lo) * delta if units == "reduced" else delta
        nbins = max(1, int(np.ceil((hi - lo) / width)))
        st = self.state
        alive = _host(st.alive)
        x = _host(st.x)[alive][:, axis]
        v = _host(st.v)[alive]
        m = np.asarray(self.cfg.masses)[_host(st.type)[alive]]
        b = np.clip(((x - lo) / width).astype(np.int64), 0, nbins - 1)
        cnt = np.bincount(b, minlength=nbins).astype(float)
        mv2 = np.bincount(b, weights=m * (v ** 2).sum(axis=1),
                          minlength=nbins)
        sums = {"vx": np.bincount(b, weights=v[:, 0], minlength=nbins),
                "vy": np.bincount(b, weights=v[:, 1], minlength=nbins),
                "vz": np.bincount(b, weights=v[:, 2], minlength=nbins)}
        return nbins, width, cnt, mv2, sums

    def _write_ave_chunk(self, ac):
        axis, delta, units = self.chunks[ac["chunk"]]
        box = self.cfg.box
        lo = box.lo[axis]
        lens = [box.lengths[i] for i in range(3) if i != axis]
        nbins, width, _, _, _ = ac["samples"][0]
        vol = width * lens[0] * lens[1]
        cnt = np.mean([s[2] for s in ac["samples"]], axis=0)
        mv2 = np.mean([s[3] for s in ac["samples"]], axis=0)
        vsum = {k: np.mean([s[4][k] for s in ac["samples"]], axis=0)
                for k in ("vx", "vy", "vz")}
        mode = "a" if ac["wrote_header"] else "w"
        with open(ac["file"], mode) as fh:
            if not ac["wrote_header"]:
                fh.write("# Chunk-averaged data (obmd_tpu fix ave/chunk)\n")
                fh.write("# Timestep Number-of-chunks Total-count\n")
                fh.write("# Chunk Coord1 Ncount "
                         + " ".join(ac["values"]) + "\n")
                ac["wrote_header"] = True
            fh.write(f"{self.total_steps} {nbins} {cnt.sum():.0f}\n")
            for i in range(nbins):
                c = max(cnt[i], 1e-30)
                cols = []
                for val in ac["values"]:
                    if val == "density/number":
                        cols.append(cnt[i] / vol)
                    elif val == "temp":
                        cols.append(mv2[i] / (3.0 * c))
                    else:
                        cols.append(vsum[val][i] / c)
                row = " ".join(f"{v:.8g}" for v in cols)
                fh.write(f"  {i + 1} {lo + (i + 0.5) * width:.6f} "
                         f"{cnt[i]:.4f} {row}\n")

    def _write_dump(self, fname, style="xyz", dargs=()):
        if style == "dcd":
            from .dump_dcd import write_dcd_frame
            write_dcd_frame(fname, self.cfg, self.state, append=True)
            return
        if style == "custom":
            from .dump import write_custom_frame
            extra = {}
            for c in dargs:
                if c.startswith("v_"):
                    extra[c] = self.eval_atom_var(c[2:])
            kw = {"cols": tuple(dargs)} if dargs else {}
            write_custom_frame(fname, self.cfg, self.state,
                               append=True, extra=extra, **kw)
            return
        from .dump import write_xyz_frame
        write_xyz_frame(fname, self.cfg, self.state, append=True)


def run_script(path: str, device="cuda", **kw) -> Interpreter:
    """Run the deck at `path` on `device` (the card by default) and return
    the Interpreter: its `state`, `cfg` and thermo lines through
    `log_fn`."""
    it = Interpreter(device=device, **kw)
    it.run_file(path)
    return it
