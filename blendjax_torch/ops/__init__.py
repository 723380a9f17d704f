"""Ops of the port: the tile-delta codec (``tiles``) and image casts (``image``)."""
