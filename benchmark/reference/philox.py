"""Philox4x32-10 and Box-Muller in plain PyTorch: the draw algorithm that
the fishing kernels state, frozen here so that the reference draws the same
numbers from the same key and counter without calling the program.

uint32 values are held in int64 tensors; products are taken in 16-bit
pieces so that no int64 product overflows.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
U64 = 1 << 64
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI = 6.283185307179586


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for a < 2^32 held in int64."""
    pl = a * (m & 0xFFFF)
    ph = a * (m >> 16)
    lo = (((ph & 0xFFFF) << 16) + pl) & MASK32
    hi = (ph + (pl >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr, key):
    """Ten Philox rounds on four counter words under a two-word key."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed: int, counter: int, env_idx: torch.Tensor):
    """The four float32 uniforms in (0, 1] of Philox block (env, counter)
    under the 64-bit key `seed`, for every env index in `env_idx` (int64):
    the top 23 bits of each word as the mantissa of a number in [1, 2),
    taken from 2."""
    counter %= U64
    bits = philox4x32_10(
        (env_idx & MASK32, env_idx >> 32, torch.full_like(env_idx, counter & MASK32),
         torch.full_like(env_idx, counter >> 32)),
        (seed & MASK32, seed >> 32))
    out = []
    for b in bits:
        f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        out.append(2.0 - f)
    return out


def box_muller(u_rad: torch.Tensor, u_theta: torch.Tensor):
    """(rad cos theta, rad sin theta) of one Box-Muller pair."""
    rad = torch.sqrt(-2.0 * torch.log(u_rad))
    theta = TWO_PI * u_theta
    return rad * torch.cos(theta), rad * torch.sin(theta)
