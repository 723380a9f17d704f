"""Blocking RPC client for remote-controlled environments (copied from
``blendjax/env/remote.py``): one ``step()`` is one simulated frame on the
producer; the REQ socket recovers from a lost reply, and a timeout raises,
so a dead simulator fails fast."""

from __future__ import annotations

import contextlib

from blendjax_torch import constants
from blendjax_torch.transport import RpcClient


class RemoteEnv:
    """Client of a producer-side
    :class:`~blendjax_torch.producer.env.RemoteControlledAgent`. The
    replies need no pickle, so the client's RPC keeps the port's default
    of refusing them."""

    def __init__(self, addr: str, timeoutms: int = constants.DEFAULT_TIMEOUTMS):
        self.client = RpcClient(addr, timeoutms=timeoutms)
        self.env_time = None
        self.rgb_array = None

    def _unpack(self, rep: dict):
        self.env_time = rep.get("time", self.env_time)
        if "rgb_array" in rep:
            self.rgb_array = rep["rgb_array"]
        obs = rep.get("obs")
        info = {
            k: v
            for k, v in rep.items()
            if k not in ("obs", "reward", "done", "rgb_array")
        }
        return obs, float(rep.get("reward", 0.0)), bool(rep.get("done", False)), info

    def reset(self, seed=None):
        """Start a fresh episode; returns ``(obs, info)``. ``seed``
        reseeds the producer's episode RNG before the episode starts, so
        two resets with the same seed start identical episodes."""
        req = {"cmd": "reset"}
        if seed is not None:
            req["seed"] = int(seed)
        obs, _, _, info = self._unpack(self.client.call(**req))
        return obs, info

    def step(self, action):
        """Apply ``action`` for one frame; returns
        ``(obs, reward, done, info)``."""
        return self._unpack(self.client.call(cmd="step", action=action))

    def render(self, mode: str = "human", backend: str | None = None):
        """Show, or with ``mode="rgb_array"`` return, the last
        ``rgb_array`` received."""
        if mode == "rgb_array" or self.rgb_array is None:
            return self.rgb_array
        from blendjax_torch.env.rendering import create_renderer

        if getattr(self, "_viewer", None) is None:
            self._viewer = create_renderer(backend)
        self._viewer.imshow(self.rgb_array)
        return None

    def close(self):
        if getattr(self, "_viewer", None) is not None:
            self._viewer.close()
            self._viewer = None
        self.client.close()


def _kwargs_to_cli(kwargs: dict) -> list[str]:
    """Keyword arguments -> producer CLI flags: ``--key value``, a list as
    ``--key v1 v2``, a bool as ``--key`` / ``--no-key``."""
    argv: list[str] = []
    for k, v in kwargs.items():
        flag = k.replace("_", "-")
        if isinstance(v, bool):
            argv.append(f"--{flag}" if v else f"--no-{flag}")
        elif isinstance(v, (list, tuple)):
            argv.append(f"--{flag}")
            argv.extend(str(x) for x in v)
        else:
            argv.extend([f"--{flag}", str(v)])
    return argv


@contextlib.contextmanager
def launch_env(script: str, scene: str = "", background: bool = False,
               seed: int = 0, real_time: bool = False,
               use_blender: bool | None = None, proto: str = "tcp",
               **kwargs):
    """Launch one environment producer and yield a connected
    :class:`RemoteEnv`. ``script`` speaks the handshake and serves the
    ``GYM`` socket; with ``use_blender`` (or a ``scene``) it runs inside
    Blender, else as a headless Python producer. Other keyword arguments
    become the script's CLI flags."""
    from blendjax_torch.launcher.launcher import (
        BlenderLauncher,
        PythonProducerLauncher,
    )

    extra = _kwargs_to_cli({"real_time": real_time, **kwargs})
    if use_blender is None:
        use_blender = bool(scene)
    if use_blender:
        launcher = BlenderLauncher(
            scene=scene, script=script, background=background,
            num_instances=1, named_sockets=["GYM"], seed=seed,
            instance_args=[extra], proto=proto,
        )
    else:
        launcher = PythonProducerLauncher(
            script=script, num_instances=1, named_sockets=["GYM"],
            seed=seed, instance_args=[extra], proto=proto,
        )
    with launcher as ln:
        env = RemoteEnv(ln.addresses["GYM"][0])
        try:
            yield env
        finally:
            env.close()
