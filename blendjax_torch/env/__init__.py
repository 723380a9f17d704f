"""Remote environments for the consumer (copied from ``blendjax/env``):
drive remote-controlled producer scenes (Blender or the headless sim) from
a training process over REQ/REP.

:class:`RemoteEnv` is one environment, :func:`launch_env` starts one and
yields it connected, :class:`BatchedRemoteEnv` steps a fleet in lockstep.
With gymnasium installed, :class:`GymnasiumRemoteEnv` adapts them to its
API and importing this package registers ``blendjax_torch/Cartpole-v0``
(:mod:`blendjax_torch.env.registry`). Nothing here imports torch.
"""

from blendjax_torch.env.remote import RemoteEnv, launch_env
from blendjax_torch.env.rendering import RENDER_BACKENDS, create_renderer
from blendjax_torch.env.vector import BatchedRemoteEnv

try:  # gymnasium is optional
    from blendjax_torch.env.gymnasium_adapter import (
        GymnasiumRemoteEnv,
        OpenAIRemoteEnv,
    )
    from blendjax_torch.env.registry import register_envs

    register_envs()
except ImportError:  # pragma: no cover
    GymnasiumRemoteEnv = None
    OpenAIRemoteEnv = None
    register_envs = None

__all__ = [
    "BatchedRemoteEnv",
    "GymnasiumRemoteEnv",
    "OpenAIRemoteEnv",
    "RENDER_BACKENDS",
    "RemoteEnv",
    "create_renderer",
    "launch_env",
    "register_envs",
]
