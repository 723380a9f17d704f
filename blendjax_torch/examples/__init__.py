"""The port's examples: the counterparts of the JAX package's
``examples/`` on ``blendjax_torch``.

- :mod:`~blendjax_torch.examples.datagen`: stream rendered cube batches
  into training (``minimal``, ``train``, ``train_transformer``), the
  falling-cubes producer and the Blender scene scripts;
- :mod:`~blendjax_torch.examples.control`: the remote cartpole, REINFORCE
  and the DQN actor-learner;
- :mod:`~blendjax_torch.examples.densityopt`: simulation parameters
  optimised from a discriminator's loss.

Each runs as ``python -m blendjax_torch.examples.<group>.<name>`` or by
path. Every example that places tensors takes ``--device`` (``cuda``, the
default, raises without a card; ``--device cpu`` runs the kernels' plain
versions). Each ``main(argv=None)`` parses ``argv`` (``sys.argv[1:]`` when
None) and returns a dict of what it measured, which the tests and
``chip_smoke.py`` read beside its printed lines.
"""
