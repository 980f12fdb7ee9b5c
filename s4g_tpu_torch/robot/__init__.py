"""Real-robot clients (copies of s4g_tpu/robot): grasp poses to the robot's
grasp service and point clouds from its camera, over rosbridge."""
from .grasp_client import GraspClient, HAND_TO_EE, EE_TO_HAND
from .vision_client import VisionClient
