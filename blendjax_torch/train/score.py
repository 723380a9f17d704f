"""Score-function (REINFORCE) gradients through non-differentiable
simulators (port of ``blendjax/train/score.py``).

Simulation parameters are sampled from a diagonal Gaussian, rendered by a
producer that no gradient flows through, and scored by a loss on the
consumer; the sampling distribution then moves along
``grad log p(theta) * (loss - baseline)``, with a running-mean baseline.
The rendered frames find their samples again through ``shape_id`` (the
densityopt example) or the scenario stamp's ``theta``
(:mod:`blendjax_torch.scenario`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blendjax_torch.device import resolve_device


class GaussianSimParams:
    """Diagonal-Gaussian distribution over simulator parameters with a
    REINFORCE update and a running-mean baseline.

    ``mu`` and ``log_sigma`` live on ``device`` (``None``: the card, and
    no card raises; ``device="cpu"`` asks for the CPU) as f32 tensors."""

    def __init__(self, mu, log_sigma, learning_rate: float = 5e-2,
                 baseline_decay: float = 0.9, device=None):
        self.device = resolve_device(device)
        self.mu = self.tensor(mu)
        self.log_sigma = self.tensor(log_sigma)
        self.lr = learning_rate
        self.baseline = None
        self.baseline_decay = baseline_decay

    def tensor(self, x) -> torch.Tensor:
        """``x`` as a detached f32 tensor on this distribution's device."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Draw ``n`` parameter vectors (n, D) with ``generator`` (on this
        distribution's device)."""
        eps = torch.randn((n, *self.mu.shape), generator=generator,
                          device=self.device)
        return self.mu + torch.exp(self.log_sigma) * eps

    def log_prob(self, theta, mu=None, log_sigma=None) -> torch.Tensor:
        """Diagonal-Gaussian log density of each row of ``theta`` (also
        the differentiated core of :meth:`update`)."""
        mu = self.mu if mu is None else mu
        log_sigma = self.log_sigma if log_sigma is None else log_sigma
        var = torch.exp(2 * log_sigma)
        return -0.5 * (
            (theta - mu) ** 2 / var + 2 * log_sigma + math.log(2 * math.pi)
        ).sum(-1)

    def update(self, theta, losses) -> float:
        """One REINFORCE step toward lower expected loss: ``theta`` (n, D)
        sampled parameters, ``losses`` (n,) their losses. Returns the
        plain mean loss (before the baseline), for logging."""
        theta = self.tensor(theta)
        losses = self.tensor(losses)
        mean_loss = losses.mean()
        if self.baseline is None:
            self.baseline = mean_loss
        adv = (losses - self.baseline).detach()  # the stop_gradient
        mu = self.mu.detach().requires_grad_(True)
        log_sigma = self.log_sigma.detach().requires_grad_(True)
        objective = (self.log_prob(theta, mu, log_sigma) * adv).mean()
        gmu, gsig = torch.autograd.grad(objective, (mu, log_sigma))
        self.mu = (self.mu - self.lr * gmu).detach()
        self.log_sigma = (self.log_sigma - self.lr * gsig).detach()
        self.baseline = (self.baseline_decay * self.baseline
                         + (1 - self.baseline_decay) * mean_loss)
        return float(mean_loss)


def chunk_across(items, n_chunks: int):
    """Split a list into ``n_chunks`` contiguous chunks (the last ones one
    shorter): the parameter fan-out across producer instances."""
    k, m = divmod(len(items), n_chunks)
    out = []
    i = 0
    for c in range(n_chunks):
        size = k + (1 if c < m else 0)
        out.append(items[i : i + size])
        i += size
    return out


__all__ = ["GaussianSimParams", "chunk_across"]
