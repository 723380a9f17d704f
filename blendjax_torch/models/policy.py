"""Networks of the RL path (port of ``blendjax/models/policy.py``).

- :class:`QNetwork`: the discrete-action Q head of the DQN learner, a
  plain linear stack (relu between, linear head, f32): the layer shape
  :func:`blendjax_torch.rl.np_mlp_forward` evaluates on the host, so the
  actors run the same policy on a numpy snapshot of its parameters.
- :class:`PolicyValueNet`: a Gaussian policy and value head (tanh between,
  ``log_std`` initialised to -0.5).

Their linear layers are flax's ``Dense_{i}`` in the order the flax module
creates them (:meth:`QNetwork.flax_names`), the names
:func:`blendjax_torch.weights.flax_params` maps them to. ``obs_dim`` is
fixed at construction (flax reads it from the example input at ``init``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from blendjax_torch.models.cnn import lecun_normal_


def _linear(layer: nn.Linear, x):
    """A flax ``Dense`` with ``dtype=None``: the f32 input and the
    parameters promote to f32 (so a bf16 copy of the parameters, as the
    ``bf16-grads`` policy differentiates, still computes in f32)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class _Dense(nn.Module):
    """Shared by both heads: the hidden stack as ``dense.{i}``, flax's
    default initialisation from an explicit seed."""

    def flax_names(self) -> list:
        """``(flax name, linear layer)`` in flax's creation order."""
        return [(f"Dense_{i}", layer) for i, layer in enumerate(self.dense)]

    def init_params(self, seed: int = 0):
        """flax's default initialisation: LeCun-normal kernels (truncated),
        zero biases (``log_std`` keeps -0.5)."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for layer in self.dense:
                lecun_normal_(layer.weight, gen)
                layer.bias.zero_()
        return self


class QNetwork(_Dense):
    """(B, obs_dim) -> Q-values (B, n_actions), f32."""

    def __init__(self, hidden=(64, 64), n_actions: int = 3,
                 obs_dim: int = 4):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.n_actions = int(n_actions)
        dims = (int(obs_dim), *self.hidden, self.n_actions)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, obs):
        x = obs.float()
        for layer in self.dense[:-1]:
            x = torch.relu(_linear(layer, x))
        return _linear(self.dense[-1], x)


class PolicyValueNet(_Dense):
    """(B, obs_dim) -> (mean (B, A), log_std (A,), value (B,)): tanh hidden
    layers ``Dense_0 .. Dense_{k-1}``, the mean head ``Dense_k`` and the
    value head ``Dense_{k+1}``."""

    def __init__(self, hidden=(64, 64), action_dim: int = 1,
                 obs_dim: int = 4):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.action_dim = int(action_dim)
        dims = (int(obs_dim), *self.hidden)
        layers = [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
        layers += [nn.Linear(dims[-1], self.action_dim),
                   nn.Linear(dims[-1], 1)]
        self.dense = nn.ModuleList(layers)
        self.log_std = nn.Parameter(torch.full((self.action_dim,), -0.5))

    def forward(self, obs):
        x = obs.float()
        for layer in self.dense[:-2]:
            x = torch.tanh(_linear(layer, x))
        mean = _linear(self.dense[-2], x)
        value = _linear(self.dense[-1], x)[:, 0]
        return mean, self.log_std, value


__all__ = ["PolicyValueNet", "QNetwork"]
