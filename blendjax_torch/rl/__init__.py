"""The RL actor-learner stack (port of ``blendjax/rl``): a device-resident
trajectory reservoir with uniform and prioritized sampling
(:class:`TrajectoryReservoir`), background actors against a host-side
policy snapshot (:class:`ActorPool`, :class:`HostQPolicy`), learner steps
that gather, update, move the target network and write the priorities
back in one call (:func:`make_dqn_step`, :func:`make_pg_step`; one CUDA
graph replay each when captured), the learner driver
(:class:`RLTrainDriver`) and the env-bound / learner-bound doctor
(:func:`diagnose_rl`).
"""

from blendjax_torch.rl.actor import ActorPool, HostQPolicy, np_mlp_forward
from blendjax_torch.rl.doctor import (
    RL_VERDICTS,
    diagnose_rl,
    diagnose_rl_current,
)
from blendjax_torch.rl.learner import RLTrainDriver
from blendjax_torch.rl.replay import TrajectoryReservoir
from blendjax_torch.rl.steps import (
    RLTrainState,
    make_dqn_step,
    make_pg_step,
    make_rl_train_state,
    mesh_rl_step_kwargs,
)

__all__ = [
    "ActorPool",
    "HostQPolicy",
    "RLTrainDriver",
    "RLTrainState",
    "RL_VERDICTS",
    "TrajectoryReservoir",
    "diagnose_rl",
    "diagnose_rl_current",
    "make_dqn_step",
    "make_pg_step",
    "make_rl_train_state",
    "mesh_rl_step_kwargs",
    "np_mlp_forward",
]
