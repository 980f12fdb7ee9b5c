"""Detector pipeline of the port (preprocessing, post-processing,
collision check, GraspDetector)."""
