"""blendjax_torch: the PyTorch/CUDA port of blendjax's streaming train path.

A second package beside ``blendjax`` (the JAX reference): producers push
tile-delta frame batches over ZMQ, :class:`blendjax_torch.data.StreamDataPipeline`
packs each chunk group into one uint8 buffer and places it on the card,
and :func:`blendjax_torch.train.make_fused_tile_step` decodes it there
with hand-written CUDA kernels (``blendjax_torch/kernels``) before the
``CubeRegressor`` updates, driven by :class:`blendjax_torch.train.TrainDriver`.
When the producers are the bound, the decoded form of the pipeline feeds
:class:`blendjax_torch.data.EchoingPipeline`, which re-draws each frame
with fresh augmentation into :func:`blendjax_torch.train.make_echo_fused_step`.

Importing the package (or its host-only modules: ``transport``,
``producer``, the numpy half of ``ops.tiles``) does not import torch, so
producer processes stay light. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no device given and no GPU they raise.
"""

__version__ = "0.1.0"
