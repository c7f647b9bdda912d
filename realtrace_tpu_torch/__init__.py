"""realtrace_tpu_torch: the realtrace Whitted ray tracer in PyTorch, with its
chunk sweep as a hand-written CUDA kernel for Hopper (sm_90a).

A port of the JAX package ``realtrace_tpu`` (the reference it is tested
against); it imports torch and numpy only.
"""

from realtrace_tpu_torch.core.types import Lights, Materials, RenderConfig, Scene, SceneBuilder
from realtrace_tpu_torch.render.camera import Camera, InteractiveCamera
from realtrace_tpu_torch.render.pipeline import render_buffer, render_image, render_with_stats

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "InteractiveCamera",
    "Lights",
    "Materials",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "render_buffer",
    "render_image",
    "render_with_stats",
]
