"""Adam as plain functions over tensors, with the update of optax.adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected
moments), so that a state carried over from the JAX package's trainer
continues there.

The step count is a 0-d device tensor and every quantity derived from it
(bias corrections, a scheduled learning rate) is computed on the device,
so a step never waits for the host. Updates return new tensors; nothing is
modified in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch


class AdamState(NamedTuple):
    mu: torch.Tensor     # first moment, shape of the parameter
    nu: torch.Tensor     # second moment
    count: torch.Tensor  # () int32, updates taken so far


def adam_init(param: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(param), torch.zeros_like(param),
                     torch.zeros((), dtype=torch.int32, device=param.device))


def adam_update(param, grad, state: AdamState, lr, b1=0.9, b2=0.999,
                eps=1e-8):
    """One Adam step; `lr` is a float or a 0-d tensor. Returns
    (new_param, new_state)."""
    mu = (1.0 - b1) * grad + b1 * state.mu
    nu = (1.0 - b2) * (grad * grad) + b2 * state.nu
    count = state.count + 1
    c = count.to(torch.float32)
    mu_hat = mu / (1.0 - torch.pow(b1, c))
    nu_hat = nu / (1.0 - torch.pow(b2, c))
    return (param - lr * (mu_hat / (torch.sqrt(nu_hat) + eps)),
            AdamState(mu, nu, count))


def exponential_decay_lr(base: float, gamma: float, interval: int,
                         count: torch.Tensor) -> torch.Tensor:
    """base * gamma ** ceil(count / interval), with `count` the updates
    taken before this one: the first update runs at `base`, updates 1 to
    `interval` at base * gamma, and so on."""
    return base * torch.pow(gamma, torch.ceil(count / interval))


class AdamGroup(NamedTuple):
    """One parameter group's Adam: its learning rate (a float, or a
    schedule: a function of the count of updates taken, such as
    `exponential_decay_lr` with its other arguments bound), betas and eps.
    Called as `(param, grad, state) -> (new_param, new_state)` it takes
    `adam_update`; `training/adam_cuda.py::optimizer_update` takes both
    groups' settings from it."""
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def learning_rate(self, count: torch.Tensor):
        """The rate of the update after `count` updates: a float, or the
        schedule's value (a 0-d tensor on `count`'s device)."""
        return self.lr(count) if callable(self.lr) else self.lr

    def __call__(self, param, grad, state: AdamState):
        return adam_update(param, grad, state,
                           self.learning_rate(state.count), self.b1,
                           self.b2, self.eps)


def adam_state_from_optax(opt_state, device="cuda") -> AdamState:
    """The port's state from an optax adam state (the first element of the
    chain's state carries `mu`, `nu` and `count`; array-likes)."""
    s = opt_state[0]
    return AdamState(
        torch.tensor(np.asarray(s.mu, np.float32), device=device),
        torch.tensor(np.asarray(s.nu, np.float32), device=device),
        torch.tensor(np.asarray(s.count, np.int32), device=device))
