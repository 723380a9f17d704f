"""Producer script: a remote-controlled cartpole environment.

Kept as the examples-path entry point of the JAX package's
``examples/control/cartpole_producer.py``; the implementation is the
package's :mod:`blendjax_torch.producer.scripts.cartpole`, so the Gymnasium
registry launches it from any install (see that module for the physics, the
RPC wiring and the flags). It imports nothing of :mod:`blendjax_torch.env`:
producer processes do not pay the env package's gymnasium import.
"""

from blendjax_torch.producer.scripts.cartpole import CartpoleEnv, main  # noqa: F401

if __name__ == "__main__":
    main()
