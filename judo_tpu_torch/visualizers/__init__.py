"""The browser GUI: the scene, the widgets, the Visualizer and its server
(counterpart of ``judo_tpu/visualizers``)."""

from judo_tpu_torch.visualizers.scene import SceneModel, build_scene, scene_source, trace_segments_to_scene
from judo_tpu_torch.visualizers.visualizer import Visualizer
from judo_tpu_torch.visualizers.widgets import WidgetSpec, reflect_config

__all__ = [
    "SceneModel",
    "Visualizer",
    "WidgetSpec",
    "build_scene",
    "reflect_config",
    "scene_source",
    "trace_segments_to_scene",
]
