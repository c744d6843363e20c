from .frame_visualizer import FrameVisualizer  # noqa: F401
from .map_visualizer import MapVisualizer  # noqa: F401
