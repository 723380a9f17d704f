"""The port's control examples (see ``blendjax_torch/examples/__init__.py``)."""
