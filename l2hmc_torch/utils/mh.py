"""NaN-robust Metropolis-Hastings acceptance.

A diverged trajectory yields a non-finite dH. The naive exp(min(dh, 0))
then gives acc = NaN, and an arithmetic blend of proposal and kept state
multiplies that NaN into the kept chain. MH semantics: a non-finite
proposal has H = +inf and is rejected with probability 1, and the blend is
a `where` (select), so 0 * NaN cannot leak through.
"""
import torch

__all__ = ["accept_prob", "select"]


def accept_prob(dh: torch.Tensor) -> torch.Tensor:
    """exp(min(dh, 0)) with non-finite dh treated as reject (acc = 0)."""
    dh = torch.where(torch.isfinite(dh), dh, torch.full_like(dh, -torch.inf))
    return torch.exp(torch.clamp(dh, max=0.0))


def select(acc_mask: torch.Tensor, prop: torch.Tensor,
           init: torch.Tensor) -> torch.Tensor:
    """Per-chain state select: prop where accepted else init, broadcast
    over the non-chain dims (`torch.where`, not an arithmetic blend)."""
    shape = (-1,) + (1,) * (prop.dim() - 1)
    return torch.where(acc_mask.reshape(shape) > 0.5, prop, init)
