"""Host-side utilities of the port: the metrics registry
(:mod:`blendjax_torch.utils.metrics`) and the logger
(:mod:`blendjax_torch.utils.logging`)."""
