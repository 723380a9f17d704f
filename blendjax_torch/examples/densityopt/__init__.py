"""The port's densityopt examples (see ``blendjax_torch/examples/__init__.py``)."""
