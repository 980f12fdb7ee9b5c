"""Detect-QA from a saved at-scale checkpoint (port of tools/detect_qa.py).

Restores the latest checkpoint under <out>/train_out (the port's
Checkpointer: {"model", "optimizer", "extra"}) and runs the same held-out
scene detection QA as train_at_scale, on the SAVED weights.

Usage:
    python -m s4g_tpu_torch.tools.detect_qa --out OUT [--num-points 25600]
        [--json-out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from .common import add_device_arg


def main(argv=None) -> dict:
    """Returns the QA dict, with the checkpoint's step."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "s4g_scale"))
    parser.add_argument("--num-points", type=int, default=25600)
    parser.add_argument("--qa-seed", type=int, default=777)
    parser.add_argument("--json-out", default=None,
                        help="also write the QA dict to this path")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..runtime.device import resolve_device
    from ..utils.checkpoint import Checkpointer, model_state_dict
    from .train_at_scale import (build_procedural_catalog, deploy_config,
                                 draw_specs, run_detect_qa)

    dev = resolve_device(args.device, "detect_qa")
    cfg = deploy_config(args.num_points)
    restored = Checkpointer(os.path.join(args.out, "train_out"),
                            map_location="cpu").load(None, resume=True)
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.out}/train_out")
    step = int(restored["extra"]["step"])
    print(f"[detect-qa] restored step {step}", flush=True)

    meshes, base_specs = build_procedural_catalog(args.out)
    qa = run_detect_qa(model_state_dict(restored), cfg, meshes,
                       draw_specs(base_specs, args.qa_seed),
                       args.num_points, qa_seed=args.qa_seed,
                       device=str(dev))
    qa["checkpoint_step"] = step
    print("[detect-qa] " + json.dumps(qa), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(qa, f, indent=1)
    return qa


if __name__ == "__main__":
    main()
