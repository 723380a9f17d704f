"""Host-side utilities of the port: the metrics registry
(:mod:`blendjax_torch.utils.metrics`), the logger
(:mod:`blendjax_torch.utils.logging`) and the primary IP
(:mod:`blendjax_torch.utils.ipaddr`)."""
