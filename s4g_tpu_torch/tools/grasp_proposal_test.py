"""End-to-end smoke inference on a scene pickle — the install check (port
of tools/grasp_proposal_test.py; reference:
inference/grasp_proposal/grasp_proposal_test.py:36-91).

Loads a training-data pickle ('point_cloud' key), preprocesses it to the
model's fixed point budget (25,600 for the curvature model), runs the
model once to warm up and once timed (synchronized), appends the forward
latency to inference_time_ours.txt in the working directory, dumps the
prediction artifacts and exports the top collision-free grasps
(`pipeline.file_logger.log_to_file`).

Usage: python -m s4g_tpu_torch.tools.grasp_proposal_test --scene PATH
           [--output DIR] [--model NAME_OR_YAML] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .common import add_device_arg, device_label, load_cloud, synchronize


def load_static_data_batch(scene_path: str, num_points: int,
                           generator: torch.Generator) -> dict:
    """{"scene_points": (1, 3, num_points)} on the generator's device: the
    scene's cloud voxelized, outlier-filtered and sampled (the sample drawn
    from `generator`), with a voxel capacity of the next power of two."""
    from ..pipeline.preprocessing import preprocess_cloud

    cloud_array = load_cloud(scene_path)                       # (3, n)
    points = torch.from_numpy(np.ascontiguousarray(cloud_array.T))
    pre = preprocess_cloud(points.to(generator.device), num_points=num_points,
                           capacity=1 << int(np.ceil(np.log2(
                               cloud_array.shape[1]))),
                           generator=generator)
    return {"scene_points": pre.points.t()[None].contiguous()}


def main(argv=None) -> dict:
    """Returns {"device", "forward_ms", "data_ms", "num_poses",
    "best_score"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", required=True,
                        help="scene pickle with a (3, n) 'point_cloud'")
    parser.add_argument("--output", default="./output")
    parser.add_argument("--model", default="curvature_model",
                        help="curvature_model, contact_model or a YAML path")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..pipeline.detector import GraspDetector
    from ..pipeline.file_logger import log_to_file
    from ..runtime.device import resolve_device
    from ..utils.logger import MetricLogger, setup_logger, shutdown_logger
    from ..utils.profiling import append_timing

    dev = resolve_device(args.device, "grasp_proposal_test")
    os.makedirs(args.output, exist_ok=True)
    logger = setup_logger("S4G", args.output, "unit_test")
    try:
        label = device_label(dev)
        logger.info("Device: %s", label)
        detector = GraspDetector(model=args.model, output_dir=args.output,
                                 device=dev)
        meters = MetricLogger(delimiter="  ")

        tic = time.time()
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        data_batch = load_static_data_batch(args.scene, detector.num_input,
                                            generator)
        synchronize(dev)
        data_time = time.time() - tic

        def forward():
            with torch.no_grad():
                return detector.net(data_batch)

        forward()                     # warm-up (first launches, the build)
        synchronize(dev)
        tic = time.time()
        predictions = forward()
        synchronize(dev)
        batch_time = time.time() - tic
        append_timing("inference_time_ours.txt", batch_time * 1000.0)
        meters.update(time=batch_time, data=data_time)
        logger.info(str(meters))

        result = log_to_file(data_batch, predictions, 0, args.output,
                             prefix="test", with_label=False)
        num_poses, best = 0, float("nan")
        if result is not None:        # a model with the 4-bin score head
            top_poses, scores = result
            num_poses = len(top_poses)
            best = float(scores.max()) if len(scores) else best
            logger.info("top poses: %d, best score %.3f", num_poses, best)
    finally:
        for handler in logger.handlers:
            handler.close()
        shutdown_logger(logger)
    print("Finish")
    return {"device": label, "forward_ms": 1e3 * batch_time,
            "data_ms": 1e3 * data_time, "num_poses": num_poses,
            "best_score": best}


if __name__ == "__main__":
    main()
