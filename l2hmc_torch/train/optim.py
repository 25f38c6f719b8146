"""Adam as `optax.adam` computes it, with the learning rate and the update
count in tensors on the parameters' device.

The counterpart of the `optax.inject_hyperparams(optax.adam)` that the JAX
package's trainer jits into its train step (train/trainer.py there): the
learning rate is an operand of the compiled step, not a constant of it.
Here the update is written on `torch._foreach_*` ops and reads the rate
from a 0-d tensor (`param_groups[0]["lr"]`, float64) and the bias
corrections from each parameter's `step` tensor, so one arithmetic serves
the CPU, the card's eager step and its CUDA graph, and a graph captured at
one rate applies whatever rate `set_lr` has written before the replay.
`torch.optim.Adam(capturable=True)` would do the same on the card only:
it is refused on CPU tensors.

    m <- b1 m + (1 - b1) g              (as a lerp, like torch.optim.Adam)
    v <- b2 v + (1 - b2) g^2
    p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)

with t the parameter's update count, computed in the parameter's dtype.
The state has torch.optim.Adam's keys ("step", "exp_avg", "exp_avg_sq"),
so checkpoints written with either optimizer restore into this one.
"""
from __future__ import annotations

import torch


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        #: the rate on the host, written with every set_lr
        self.lr = float(lr)
        super().__init__(params, {"lr": self._lr_tensor(lr, device),
                                  "betas": tuple(betas), "eps": float(eps)})

    @staticmethod
    def _lr_tensor(lr: float, device) -> torch.Tensor:
        return torch.full((), float(lr), dtype=torch.float64, device=device)

    def set_lr(self, lr: float) -> None:
        """Write the rate into every group's device scalar (a fill, no
        synchronisation)."""
        self.lr = float(lr)
        for group in self.param_groups:
            group["lr"].fill_(self.lr)

    def _init_state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=p.dtype, device=p.device)
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps = group["eps"]
            by_dtype: dict = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._init_state(p)
                by_dtype.setdefault((p.device, p.dtype), []).append(
                    (p, p.grad, state))
            for (_, dtype), items in by_dtype.items():
                ps = [p for p, _, _ in items]
                gs = [g for _, g, _ in items]
                ms = [s["exp_avg"] for _, _, s in items]
                vs = [s["exp_avg_sq"] for _, _, s in items]
                ts = [s["step"] for _, _, s in items]
                torch._foreach_add_(ts, 1.0)
                torch._foreach_lerp_(ms, gs, 1.0 - b1)
                torch._foreach_mul_(vs, b2)
                torch._foreach_addcmul_(vs, gs, gs, 1.0 - b2)
                # lr / (1 - b1^t) and sqrt(1 - b2^t), per parameter
                step_size = torch._foreach_pow(b1, ts)
                torch._foreach_neg_(step_size)
                torch._foreach_add_(step_size, 1.0)
                torch._foreach_reciprocal_(step_size)
                torch._foreach_mul_(step_size, group["lr"].to(dtype))
                bc2 = torch._foreach_pow(b2, ts)
                torch._foreach_neg_(bc2)
                torch._foreach_add_(bc2, 1.0)
                torch._foreach_sqrt_(bc2)
                denom = torch._foreach_sqrt(vs)
                torch._foreach_div_(denom, bc2)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(ms, denom)
                torch._foreach_mul_(upd, step_size)
                torch._foreach_sub_(ps, upd)

    def state_dict(self) -> dict:
        """torch's layout, the rate as a number (no device read)."""
        sd = super().state_dict()
        for group in sd["param_groups"]:
            group["lr"] = self.lr
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore this optimizer's or torch.optim.Adam's state: the rate
        back into a device scalar, every `step` into the parameter's
        dtype on its device."""
        super().load_state_dict(state_dict)
        lr = self.param_groups[0]["lr"]
        self.lr = float(lr)
        for group in self.param_groups:
            device = group["params"][0].device if group["params"] \
                else torch.device("cpu")
            group["lr"] = self._lr_tensor(self.lr, device)
            for p in group["params"]:
                state = self.state.get(p)
                if state and "step" in state:
                    state["step"] = torch.as_tensor(state["step"]).to(
                        dtype=p.dtype, device=p.device)
