"""ROS bridge connection (roslibpy), import-gated (a copy of
s4g_tpu/robot/ros.py).

Mirrors the reference's remote handle (reference: data_gen/real_robot/ros.py):
a module-level rosbridge connection the service clients share.  roslibpy is
not part of this image; connect() raises a clear error if it is missing.
"""

from __future__ import annotations

_ros = None


def connect(host: str = "localhost", port: int = 9090):
    """Create (or return) the shared rosbridge connection."""
    global _ros
    if _ros is not None:
        return _ros
    try:
        import roslibpy
    except ImportError as exc:  # pragma: no cover - optional dependency
        raise ImportError(
            "roslibpy is required for real-robot clients; install it on the "
            "robot workstation") from exc
    _ros = roslibpy.Ros(host=host, port=port)
    _ros.run()
    return _ros
