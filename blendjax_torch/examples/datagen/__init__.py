"""The port's datagen examples (see ``blendjax_torch/examples/__init__.py``)."""
