"""U(1) gauge group as phase angles.

PyTorch counterpart of the JAX package's `ops/u1.py` (after the reference's
`U1Phase`, src/l2hmc/group/u1/pytorch/group.py:60-165). Links are real
phase angles x with the group element exp(i x); the Lie algebra is R, so
`update_gauge` is addition and momenta are plain Gaussians. Random draws
take a `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi

NAME = "U1"
DIM = 2


def exp(x: torch.Tensor) -> torch.Tensor:
    """Group element exp(i x) as a complex number (group.py:99-100)."""
    return torch.polar(torch.ones_like(x), x)


def update_gauge(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x <- x + p (group.py:102-103)."""
    return x + p


def adjoint(x: torch.Tensor) -> torch.Tensor:
    return -x


def mul(a, b, adjoint_a=False, adjoint_b=False):
    """Group multiply in phase representation (group.py:105-119)."""
    a = -a if adjoint_a else a
    b = -b if adjoint_b else b
    return a + b


def trace(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x)


def diff_trace(x: torch.Tensor) -> torch.Tensor:
    return -torch.sin(x)


def compat_proj(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [-pi, pi) (group.py:137-138). `torch.remainder` is
    a floor-mod, like jnp's `%`."""
    return torch.remainder(x + PI, TWO_PI) - PI


def projectTAH(x: torch.Tensor) -> torch.Tensor:
    """The identity for U(1) (group.py:140-153)."""
    return x


def group_to_vec(x: torch.Tensor) -> torch.Tensor:
    """exp(i x) -> [cos x, sin x] concatenated on axis 1 (group.py:86-89)."""
    return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


def vec_to_group(x: torch.Tensor) -> torch.Tensor:
    """[cos x | sin x] halves (as produced by group_to_vec) -> phase
    angles (group.py:91-97)."""
    d = x.shape[-1] // 2
    return torch.atan2(x[..., d:], x[..., :d])


def random(shape, generator: Optional[torch.Generator] = None,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform angles (group.py:158-159)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return compat_proj(TWO_PI * u)


def random_momentum(shape, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """v ~ N(0, 1) per link (group.py:161-162)."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def kinetic_energy(v: torch.Tensor) -> torch.Tensor:
    """KE = 0.5 * sum v^2 per chain (group.py:164-165)."""
    return 0.5 * torch.sum(torch.square(v.reshape(v.shape[0], -1)), dim=-1)
