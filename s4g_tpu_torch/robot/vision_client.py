"""Kinect capture service client (a copy of s4g_tpu/robot/vision_client.py;
reference: data_gen/real_robot/vision_client.py): requests a point-cloud
snapshot from the robot-side vision server and returns it as a numpy
array."""

from __future__ import annotations

import numpy as np


class VisionClient:
    def __init__(self, ros=None):
        self._service = None
        if ros is not None:  # pragma: no cover - requires rosbridge
            import roslibpy
            self._service = roslibpy.core.Service(
                ros, "/web_server/cloud_server", "web_server/CloudService")

    @staticmethod
    def parse_cloud_response(response: dict) -> np.ndarray:
        """Flatten the service's {points: [{x, y, z}...]} payload
        into (n, 3)."""
        points = response.get("points", [])
        return np.array([[p["x"], p["y"], p["z"]] for p in points],
                        np.float32)

    def capture(self) -> np.ndarray:
        if self._service is None:
            raise RuntimeError("Not connected to rosbridge")
        import roslibpy  # pragma: no cover
        res = self._service.call(roslibpy.core.ServiceRequest({}))
        return self.parse_cloud_response(res)
