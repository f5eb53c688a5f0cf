"""The port's expression engine (obmd_tpu_torch/io/expr.py) against the
JAX package's (obmd_tpu/io/expr.py): on the cases of tests/test_expr.py
and tests/test_variables.py the parse trees are equal and the host and
numpy backends give the same values; torch_backend on 0-dim float32
tensors equals jnp_backend within 1e-6 relative at t in {0, 0.125, 0.37,
3.1}; every error case raises ExprError in both."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obmd_tpu.io import expr as jexpr
from obmd_tpu_torch.io import expr as pexpr

import tests.test_torch_support  # noqa: F401  (one torch thread a worker)

# the formulas of tests/test_expr.py and tests/test_variables.py
HOST_CASES = [
    "-2^2", "2^3^2", "2+3*4^2", "2*3+4", "2^2*3", "-5 % 3", "5 % -3",
    "3 > 2", "3 < 2", "1 && 0", "1 || 0", "!0", "!5", "1 ^| 1", "1 ^| 0",
    "2 == 2.0", "(1 < 2) + (3 >= 3)", "log(100)", "ln(exp(1))",
    "sqrt(2)^2", "sin(PI/2)", "atan2(1, 1)", "floor(2.7) + ceil(2.2)",
    "1.5e3 + 2E-2", ".5*4", "v_a * v_b", "0.5*sin(2*PI*time)", "step*dt",
    "MIN(3, 5) + MAX(1, 2)", "round(2.5) + round(3.5) + abs(-1.25)",
    "pow(2, 0.5) + tan(0.3) + asin(0.5) + acos(0.5) + atan(2)",
    "4.0 + 2.0 * sin(20.0 * time)", "188+v_amp*sin(2*PI*2*time)",
]
ENV = {"PI": math.pi, "time": 2.0, "step": 200, "dt": 0.01}
VARS = {"a": 3.0, "b": "4", "amp": 60.0}


def _resolve(name):
    v = VARS[name]
    return float(v) if isinstance(v, str) else v


@pytest.mark.parametrize("src", HOST_CASES)
def test_parse_and_host_values(src):
    """Parse trees equal, names and v_ references equal, host values
    equal (both evaluate in Python floats)."""
    ja, pa = jexpr.parse(src), pexpr.parse(src)
    assert pa == ja
    assert pexpr.names_in(pa) == jexpr.names_in(ja)
    assert pexpr.var_refs(pa) == jexpr.var_refs(ja)
    want = jexpr.eval_ast(ja, ENV, jexpr.host_backend(), _resolve)
    got = pexpr.eval_ast(pa, ENV, pexpr.host_backend(), _resolve)
    assert got == want


@pytest.mark.parametrize("src", ["(x > 0) && (vx > 0)", "-x^2",
                                 "vx*vx+x*x", "z+v_off", "!(x < 0) % 2",
                                 "round(x*1.5) + MIN(x, vx)"])
def test_numpy_backend(src):
    env = {"x": np.asarray([1.0, -2.0, 3.0, 0.5]),
           "vx": np.asarray([0.5, 0.5, -1.0, 2.5]),
           "z": np.asarray([0.1, 0.2, 0.3, 0.4])}
    res = {"off": 3.0}.get
    want = jexpr.eval_ast(jexpr.parse(src), env, jexpr.numpy_backend(), res)
    got = pexpr.eval_ast(pexpr.parse(src), env, pexpr.numpy_backend(), res)
    assert np.array_equal(np.asarray(got), np.asarray(want))


TIME_CASES = [
    "188+60*sin(2*PI*2*time)", "4.0 + 2.0 * sin(20.0 * time)",
    "0.5*sin(2*PI*time) + cos(time)^2", "exp(-time) * sqrt(1 + time)",
    "(time > 0.2) * 10 + (time <= 0.2) * 5", "step*dt + time % 0.3",
    "round(time*4) + floor(time) + ceil(time)", "atan2(time, 1) + abs(-time)",
    "!(time < 1) + (time > 0 && time < 3) + (time < 0.1 || time > 3)",
    "MIN(time, 1) + MAX(time, 2) + log(2 + time) + ln(1 + time)",
    "2^time + pow(time + 1, 0.5) + tan(time * 0.1)",
    "asin(0.1) + acos(0.2 * time / 4) + atan(time)",
]


@pytest.mark.parametrize("src", TIME_CASES)
@pytest.mark.parametrize("t", [0.0, 0.125, 0.37, 3.1])
def test_torch_backend_against_jnp(src, t):
    """A time-dependent formula at a float32 sim time: torch_backend's
    0-dim tensor equals jnp_backend's within 1e-6 relative (atol 1e-6 at
    zero), and stays a 0-dim float32 tensor."""
    jt = jnp.asarray(t, jnp.float32)
    pt = torch.tensor(t, dtype=torch.float32)
    jenv = {"PI": math.pi, "time": jt, "step": jt / 0.01, "dt": 0.01}
    penv = {"PI": math.pi, "time": pt, "step": pt / 0.01, "dt": 0.01}
    want = float(jexpr.eval_ast(jexpr.parse(src), jenv, jexpr.jnp_backend()))
    got = pexpr.eval_ast(pexpr.parse(src), penv,
                         pexpr.torch_backend(torch.float32, "cpu"))
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)


def test_torch_backend_constants_are_tensors():
    """A formula of numbers alone still gives a tensor on the backend's
    device and dtype (the port's stage adds it to device tensors)."""
    got = pexpr.eval_ast(pexpr.parse("sin(PI/2) + 2^3 + (1 < 2)"),
                         {"PI": math.pi},
                         pexpr.torch_backend(torch.float64, "cpu"))
    assert got.dtype == torch.float64 and float(got) == pytest.approx(10.0)


ERROR_CASES = [
    ("1/0", "Divide by zero"), ("1%0", "Modulo 0"),
    ("sqrt(-1)", "Sqrt of negative"), ("ln(0)", "Log of zero/negative"),
    ("log(-2)", "Log of zero/negative"), ("0^-1", "Invalid power"),
    ("frobnicate(1)", "Invalid math function"), ("1 +", "Invalid syntax"),
    ("(1+2", "Invalid syntax"), ("nosuchthing + 1", "Invalid"),
    ("1 2", "Invalid syntax"), ("3 $ 4", "Invalid syntax"),
    ("sin(1, 2)", "Invalid math function"), ("v_q", "no variable resolver"),
]


@pytest.mark.parametrize("src,msg", ERROR_CASES)
def test_errors_in_both(src, msg):
    for mod in (jexpr, pexpr):
        with pytest.raises(mod.ExprError, match=msg):
            mod.eval_ast(mod.parse(src), {}, mod.host_backend())
