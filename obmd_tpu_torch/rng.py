"""Counter-based, stateless random numbers for the pair noise.

Counterpart of `obmd_tpu/rng.py`.  The hashes and uniform draws match the
reference bit for bit, in the dtype asked for (the state's: float32 or
float64); the gaussian draws (`box_muller`) take torch's log, sqrt and
cos, within rounding of XLA's.  torch on the CPU has no uint32 shift, so
a uint32 value is held in an int64 tensor masked to 32 bits, and each
product by a 32-bit constant is split into 16-bit halves so no
intermediate exceeds 2^49.  The same
functions take python ints, which is how the step salt is computed on the
host and handed to the pair kernel as a kernel argument.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(a):
    """Reinterpret an int (or integer tensor) as uint32 held in int64."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int64) & MASK32
    return int(a) & MASK32


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a uint32 `a` and a 32-bit constant `c`."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _avalanche(h):
    """murmur3 fmix32 — full avalanche on uint32."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash2(a, b):
    """Combine two uint32 streams into one well-mixed uint32."""
    h = _avalanche(u32(a) ^ 0x9E3779B9)
    return _avalanche(h ^ _mul32(u32(b), 0x85EBCA77))


def hash3(a, b, c):
    return _avalanche(hash2(a, b) ^ _mul32(u32(c), 0xC2B2AE3D))


def uniform01(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 bits -> uniform in [0, 1) with 24-bit mantissa resolution."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def pair_bits(step_salt, tag_i: torch.Tensor, tag_j: torch.Tensor):
    """The pair-symmetric noise bits: one fmix32 round over the
    multiplicatively mixed (smaller tag, larger tag, salt)."""
    lo = u32(torch.minimum(tag_i, tag_j))
    hi = u32(torch.maximum(tag_i, tag_j))
    return _avalanche(_mul32(lo, 0x9E3779B9) ^ _mul32(hi, 0x85EBCA77)
                      ^ u32(step_salt))


def box_muller(bits, stream: int, u1_min: float,
               dtype=torch.float32) -> torch.Tensor:
    """A unit gaussian from the pair bits: u1 = uniform01(bits) clamped at
    u1_min, u2 = uniform01(fmix32(bits ^ stream)),
    sqrt(-2 ln u1) cos(2 pi u2), every constant rounded to `dtype`."""
    u1 = torch.clamp(uniform01(bits, dtype),
                     min=float(torch.tensor(u1_min, dtype=dtype)))
    u2 = uniform01(_avalanche(bits ^ stream), dtype)
    two_pi = float(torch.tensor(2.0 * 3.14159265358979, dtype=dtype))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def pair_noise(step_salt, tag_i: torch.Tensor, tag_j: torch.Tensor,
               gaussian: bool = False,
               dtype=torch.float32) -> torch.Tensor:
    """Zero-mean unit-variance deviate, symmetric under i <-> j: the
    uniform sqrt(3)(2u - 1), or with `gaussian` Box-Muller from the stream
    0x6C62272E with u1 clamped at 1e-7 (the pair kernel's Box-Muller takes
    another stream and clamp: forces.pair_kernel)."""
    bits = pair_bits(step_salt, tag_i, tag_j)
    if gaussian:
        return box_muller(bits, 0x6C62272E, 1e-7, dtype)
    u = uniform01(bits, dtype)
    sqrt3 = torch.sqrt(torch.tensor(3.0, dtype=dtype, device=u.device))
    return sqrt3 * (2.0 * u - 1.0)


# dpd/ext's three transverse noise streams: pair_noise of the salt xor each
# (obmd_tpu/forces/pairs.py:199-203)
TRANSVERSE_STREAMS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)


def transverse_noise(step_salt, tag_i: torch.Tensor, tag_j: torch.Tensor,
                     gaussian: bool = False,
                     dtype=torch.float32) -> torch.Tensor:
    """[..., 3] the pair's transverse noise vector of dpd/ext: one
    pair_noise per stream of TRANSVERSE_STREAMS, symmetric under i <-> j
    (the law antisymmetrizes it by the tag order)."""
    return torch.stack([pair_noise(u32(step_salt) ^ c, tag_i, tag_j,
                                   gaussian=gaussian, dtype=dtype)
                        for c in TRANSVERSE_STREAMS], dim=-1)


def step_salt(seed, step, purpose=0):
    """Per-(seed, step, purpose) uint32 salt for counter-based draws."""
    return hash3(seed, step, purpose)
