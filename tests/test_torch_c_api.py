"""The port's C library API (obmd_tpu_torch/csrc/obmdc_torch.cpp, built by
obmd_tpu_torch._build.capi_library) driven by tests/test_c_api.py's C
client (tests/torch_capi_support.py holds a copy of it, equal to it, and
adds a dump of the final positions): on the plain versions
(OBMD_PLATFORM=cpu) it passes that test's checks and equals an in-process Session of obmd_tpu_torch.capi, the same
Interpreter(device="cpu") and views, to the bit; it agrees with the same
client on the JAX package's native/libobmdc.so in natoms and steps, and in
positions within the deck parity tests' 1e-5 relative
(tests/torch_script_support.assert_thermo_close); with OBMD_PLATFORM unset
on a machine without a GPU, obmd_open reports the missing GPU.

The deck declares 5 atom types (all atoms of type 1) so that the JAX
Interpreter runs it on its XLA neighbor-list engine: on its cellpad
engine the Pallas pair kernel in interpret mode takes ~60 s here."""
import os
import subprocess

import numpy as np
import pytest
import torch

from obmd_tpu_torch import _build
from obmd_tpu_torch.capi import Session, open_session, platform_device
from obmd_tpu_torch.io.lammps_data import DataFile, write_data

from tests.test_torch_support import CPU
from tests import test_c_api
from tests.torch_capi_support import (CLIENT_C, build_client,
                                      parse_client_line, read_client_dump)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(ROOT, "native", "libobmdc.so")
N, L, NTYPES, STEPS = 300, 8.0, 5, 30
X_RTOL = 1e-5


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("OBMD_PLATFORM", None)
    env.update(kw)
    return env


def _run(exe, deck, out=None, **env):
    args = [exe, deck] + ([out] if out else [])
    return subprocess.run(args, env=_env(**env), capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The deck, the client built on the port's library, and its run on
    the plain versions: (folder, deck, port client, its line, its x)."""
    tmp = tmp_path_factory.mktemp("capi")
    r = np.random.RandomState(2)
    df = DataFile(natoms=N, ntypes=NTYPES, box_lo=np.zeros(3),
                  box_hi=np.full(3, L), masses=np.ones(NTYPES),
                  x=r.uniform(0.2, L - 0.2, (N, 3)),
                  types=np.zeros(N, np.int32),
                  tags=np.arange(1, N + 1, dtype=np.int32),
                  v=r.normal(0, 1, (N, 3)))
    data = tmp / "s.data"
    write_data(str(data), df)
    deck = tmp / "in.deck"
    deck.write_text(f"""units lj
boundary p p p
atom_style atomic
read_data {data}
pair_style dpd 1.0 1.0 7
pair_coeff * * 25.0 4.5
fix 1 all nve
timestep 0.01
run {STEPS}
""")
    pdir = tmp / "port"
    pdir.mkdir()
    exe = build_client(str(_build.capi_library()), str(pdir))
    out = str(pdir / "x.bin")
    p = _run(exe, str(deck), out, OBMD_PLATFORM="cpu")
    assert p.returncode == 0, p.stderr[-800:]
    x, ids = read_client_dump(out)
    assert np.array_equal(ids, np.arange(1, N + 1))
    return tmp, str(deck), exe, parse_client_line(p.stdout), x


def _check_line(line):
    """tests/test_c_api.py's checks, at this deck's size and run."""
    assert line["natoms"] == str(N) and line["step"] == str(STEPS), line
    assert line["ids_ok"] == "1" and line["v_ok"] == "1", line
    assert line["step2"] == str(STEPS + 5), line


def test_client_on_the_port(case):
    """The client's checks on the plain versions, and its final positions,
    natoms and steps equal to an in-process Session's, bit for bit."""
    _, deck, _, line, x = case
    _check_line(line)
    s = Session(CPU)
    s.file(deck)
    assert s.natoms() == N and s.thermo("step") == STEPS
    x0 = np.frombuffer(s.gather("x"), np.float64)
    v = np.frombuffer(s.gather("v"), np.float64) * 0.5
    s.scatter("v", v.tobytes())
    assert np.frombuffer(s.gather("v"), np.float64).tobytes() == v.tobytes()
    s.scatter("x", x0.tobytes())
    s.command("run 5")
    assert s.thermo("step") == STEPS + 5
    assert np.frombuffer(s.gather("x"), np.float64).tobytes() == x.tobytes()
    ids = np.frombuffer(s.gather_int("id"), np.int64)
    assert np.array_equal(ids, np.arange(1, N + 1))
    assert np.array_equal(np.frombuffer(s.gather_int("type"), np.int64),
                          np.ones(N, np.int64))
    assert line["x0"] == f"{x0[0]:.4f}"


def test_client_agrees_with_the_jax_library(case):
    """The same client on native/libobmdc.so (the JAX package on the CPU):
    the same natoms and steps, positions within X_RTOL of the box."""
    if not os.path.exists(JAX_LIB):
        pytest.skip("native/libobmdc.so is absent (not built here)")
    tmp, deck, _, line, x = case
    jdir = tmp / "jax"
    jdir.mkdir()
    exe = build_client(JAX_LIB, str(jdir))
    out = str(jdir / "x.bin")
    p = _run(exe, deck, out, OBMD_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    assert p.returncode == 0, p.stderr[-800:]
    jline = parse_client_line(p.stdout)
    _check_line(jline)
    for k in ("natoms", "step", "step2", "ids_ok", "v_ok"):
        assert jline[k] == line[k], k
    jx, jids = read_client_dump(out)
    assert jx.shape == x.shape and np.array_equal(jids, np.arange(1, N + 1))
    assert np.abs(jx - x).max() <= X_RTOL * L, np.abs(jx - x).max()


def test_client_without_a_gpu_fails(case, monkeypatch):
    """OBMD_PLATFORM unset means the GPU: without one, obmd_open reports
    it and the client exits non-zero instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the unset platform is valid here")
    _, deck, exe, _, _ = case
    p = _run(exe, deck)
    assert p.returncode != 0
    assert "no GPU" in p.stderr and "OBMD_PLATFORM=cpu" in p.stderr, \
        p.stderr[-800:]
    monkeypatch.delenv("OBMD_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no GPU"):
        open_session()


def test_platform_values():
    assert platform_device(None) == platform_device("") == "cuda"
    assert platform_device("GPU") == platform_device("cuda") == "cuda"
    assert platform_device("cpu") == "cpu"
    with pytest.raises(ValueError, match="OBMD_PLATFORM"):
        platform_device("tpu")


def test_client_copy_equals_the_jax_test_client():
    assert CLIENT_C == test_c_api.CLIENT_C
