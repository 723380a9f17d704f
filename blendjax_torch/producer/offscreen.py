"""Real-time offscreen rendering inside the Blender UI (copied from
``blendjax/producer/offscreen.py``): a ``gpu.types.GPUOffScreen`` target,
the view drawn with the camera's matrices, pixels read back into an
(H, W, C) uint8 array (``texture_color.read()``, or ``glReadPixels`` on
Blender builds without it).

Call it from a POST_PIXEL draw handler; offscreen rendering is not
available under ``--background`` (use the headless sim renderer there).
No gamma correction here: frames ship linear and the consumer applies
gamma on the card.
"""

from __future__ import annotations

import numpy as np

try:
    import bpy
    import gpu
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "blendjax_torch.producer.offscreen requires Blender (bpy/gpu). "
        "Use blendjax_torch.producer.sim for headless rendering."
    ) from e

from blendjax_torch.producer.bpy_engine import find_first_view3d


class OffScreenRenderer:
    def __init__(self, camera=None, mode: str = "rgb", origin: str = "upper-left"):
        assert mode in ("rgb", "rgba")
        self.camera = camera or bpy.context.scene.camera
        self.channels = 3 if mode == "rgb" else 4
        self.origin = origin
        render = bpy.context.scene.render
        scale = render.resolution_percentage / 100.0
        self.shape = (
            int(render.resolution_y * scale),
            int(render.resolution_x * scale),
        )
        h, w = self.shape
        self.offscreen = gpu.types.GPUOffScreen(w, h)
        self.buffer = np.empty((h, w, 4), dtype=np.uint8)
        self.space = find_first_view3d()
        self.area = None
        self.region = None

    def set_render_style(self, shading: str = "RENDERED", overlays: bool = False):
        """(reference ``offscreen.py:101``)"""
        self.space.shading.type = shading
        self.space.overlay.show_overlays = overlays

    def render(self) -> np.ndarray:
        """Draw the view through ``self.camera`` and return H×W×C uint8.

        The returned array's origin follows ``self.origin`` — Blender/GL
        give lower-left scanlines, so 'upper-left' flips vertically
        (reference ``offscreen.py:95-96``).
        """
        scene = bpy.context.scene
        view_m = self.camera.matrix_world.inverted()
        proj_m = self.camera.calc_matrix_camera(
            bpy.context.evaluated_depsgraph_get(),
            x=self.shape[1],
            y=self.shape[0],
        )
        with self.offscreen.bind():
            self.offscreen.draw_view3d(
                scene,
                bpy.context.view_layer,
                self.space,
                self.region or bpy.context.region,
                view_m,
                proj_m,
                do_color_management=True,
            )
            tex = getattr(self.offscreen, "texture_color", None)
            if tex is not None:
                buf = tex.read()
                buf.dimensions = self.shape[0] * self.shape[1] * 4
                arr = np.asarray(buf, dtype=np.uint8)
            else:
                # Blender 2.8x/2.9x: no texture_color — read the bound
                # color attachment through GL like the reference does
                # (``offscreen.py:68-99``: ``bgl.Buffer`` lacks the
                # buffer protocol, hence PyOpenGL's glGetTexImage there;
                # glReadPixels on the bound FBO needs neither).
                arr = self._read_pixels_gl()
        arr = arr.reshape(self.shape[0], self.shape[1], 4)
        if self.origin == "upper-left":
            arr = np.flipud(arr)
        return arr[..., : self.channels]

    def _read_pixels_gl(self) -> np.ndarray:
        """Legacy readback for Blender builds predating
        ``GPUOffScreen.texture_color`` (reference counterpart:
        ``btb/offscreen.py:68-99``). ``glReadPixels`` into a numpy
        buffer while the offscreen FBO is bound — PyOpenGL accepts any
        writable buffer-protocol object, sidestepping the bgl.Buffer
        limitation the reference works around via glGetTexImage."""
        try:
            from OpenGL import GL
        except ImportError as e:  # pragma: no cover - legacy-Blender only
            raise RuntimeError(
                "this Blender's GPUOffScreen has no texture_color and "
                "PyOpenGL is not importable; pip-install PyOpenGL into "
                "Blender's Python (scripts/install_producer.py does)"
            ) from e
        h, w = self.shape
        GL.glReadPixels(
            0, 0, w, h, GL.GL_RGBA, GL.GL_UNSIGNED_BYTE, self.buffer
        )
        # Copy: render() must return memory the next render won't
        # overwrite — the zero-copy publish path (DataPublisher
        # copy=False) queues frames by reference, and the modern
        # texture_color path returns fresh memory per call.
        return self.buffer.reshape(-1).copy()
