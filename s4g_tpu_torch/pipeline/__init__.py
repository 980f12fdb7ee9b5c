"""Detector pipeline of the port (preprocessing, post-processing,
collision check, GraspDetector); the JAX package's names."""

from .preprocessing import (preprocess_cloud, radius_outlier_mask,
                            random_sample_fixed, voxel_downsample,
                            workspace_crop_mask)
from .collision import batch_view_non_collision
from .postprocessing import post_process_predictions
from .detector import GraspDetector
