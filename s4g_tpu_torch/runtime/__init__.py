"""Host-side runtime: the native host ops (built at first use, not at
import), the training-data loaders and the device check."""

from .host_ops import (native_available, voxel_downsample_trace,
                       radius_outlier_mask, nearest_neighbor_match)
from .loader import AsyncSceneLoader
