"""Producer script: streams rotating-cube images and corner annotations.

Kept as the examples-path entry point of the JAX package's
``examples/datagen/cube_producer.py``; the implementation is the package's
:mod:`blendjax_torch.producer.cube`, which takes every flag of the
reference (``--shape``, ``--frames``, ``--batch``, ``--encoding
raw|tile|pal``, ``--tile``, ``--tile-rgba``, ``--ref-interval``,
``--tile-capacity``, ``--trace-every``) and the port's own (``--wire``,
``--no-native``, ``--log``). Launch it with
:class:`blendjax_torch.launcher.PythonProducerLauncher`; it reads the
launcher's handshake after ``--``.
"""

from blendjax_torch.producer.cube import main

if __name__ == "__main__":
    main()
