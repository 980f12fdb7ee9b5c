"""Wall-clock serving throughput: sequential detect() vs detect_stream
(port of tools/measure_stream.py).

Kernel timings measure device time; a real serving loop pays host prep +
launches + device per frame unless it pipelines.  This measures the frames
per second a consumer sees, both ways, on the deployment config over a
scene pickle: `n_frames` frames of 30,000 points drawn from its cloud, a
detector of capacity CAPACITY (32,768, as in the JAX tool), seeded random
weights (or the output directory's `last_checkpoint`).

Usage: python -m s4g_tpu_torch.tools.measure_stream [n_frames] [depth]
           --scene PATH [--model NAME_OR_YAML] [--device cpu]   (run solo)
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .common import add_device_arg, device_label, load_cloud

CAPACITY = 32768


def main(argv=None) -> dict:
    """Returns the printed JSON object."""
    parser = argparse.ArgumentParser()
    parser.add_argument("n_frames", type=int, nargs="?", default=50)
    parser.add_argument("depth", type=int, nargs="?", default=2)
    parser.add_argument("--scene", required=True,
                        help="scene pickle with a (3, n) 'point_cloud'")
    parser.add_argument("--model", default="curvature_model",
                        help="curvature_model, contact_model or a YAML path")
    parser.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "s4g_stream"))
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..pipeline.detector import GraspDetector
    from ..runtime.device import resolve_device

    dev = resolve_device(args.device, "measure_stream")
    n_frames, depth = args.n_frames, args.depth
    rng = np.random.RandomState(0)
    cloud = load_cloud(args.scene).T                       # (n, 3)
    frames = [cloud[rng.choice(len(cloud), 30000, replace=True)]
              for _ in range(n_frames)]

    det = GraspDetector(model=args.model, output_dir=args.output,
                        cloud_capacity=CAPACITY, device=dev)
    kwargs = dict(num_selected=5, score_threshold=0.3,
                  verticalness_threshold=-1.0)

    # warm both paths
    det.detect(frames[0], **kwargs)
    list(det.detect_stream(frames[:2], depth=depth, **kwargs))

    t0 = time.perf_counter()
    for f in frames:
        det.detect(f, **kwargs)
    seq_s = (time.perf_counter() - t0) / n_frames

    t0 = time.perf_counter()
    for _ in det.detect_stream(frames, depth=depth, **kwargs):
        pass
    stream_s = (time.perf_counter() - t0) / n_frames

    out = {"n_frames": n_frames, "depth": depth,
           "sequential_ms_per_frame": seq_s * 1000,
           "streamed_ms_per_frame": stream_s * 1000,
           "sequential_fps": 1.0 / seq_s, "streamed_fps": 1.0 / stream_s,
           "device": device_label(det.device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
