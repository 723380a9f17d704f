"""Viewers for ``env.render(mode='human')`` (copied from
``blendjax/env/rendering.py``): a registry of backends, each registered
only if its import succeeds, tried in a preference order. The headless
array collector is always there; matplotlib where it is installed.
"""

from __future__ import annotations

RENDER_BACKENDS: dict = {}
LOOKUP_ORDER = ["matplotlib", "array"]


class ArrayRenderer:
    """Headless: stores frames; ``frames`` accumulates for video export."""

    def __init__(self):
        self.frames: list = []

    def imshow(self, rgb):
        self.frames.append(rgb)

    def close(self):
        self.frames.clear()


RENDER_BACKENDS["array"] = ArrayRenderer

try:  # pragma: no cover - depends on env
    import matplotlib  # noqa: F401  (availability probe for the backend)

    class MatplotlibRenderer:
        """Interactive imshow window."""

        def __init__(self):
            import matplotlib.pyplot as plt

            self._plt = plt
            plt.ion()
            self.fig, self.ax = plt.subplots()
            self.ax.set_axis_off()
            self._im = None

        def imshow(self, rgb):
            if self._im is None:
                self._im = self.ax.imshow(rgb)
            else:
                self._im.set_data(rgb)
            self.fig.canvas.draw_idle()
            self._plt.pause(0.001)

        def close(self):
            self._plt.close(self.fig)

    RENDER_BACKENDS["matplotlib"] = MatplotlibRenderer
except ImportError:  # pragma: no cover
    pass


def create_renderer(backend: str | None = None):
    """``backend``, or the first available one in preference order."""
    if backend is not None:
        return RENDER_BACKENDS[backend]()
    for name in LOOKUP_ORDER:
        if name in RENDER_BACKENDS:
            return RENDER_BACKENDS[name]()
    raise RuntimeError("no render backend available")
