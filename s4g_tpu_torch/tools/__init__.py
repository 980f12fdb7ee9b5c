"""Entry points of the port (twins of the JAX package's tools/*.py), each
run as `python -m s4g_tpu_torch.tools.<name>`: train, grasp_proposal_test,
measure_batch, measure_stream, profile_stages, trace_forward,
visualize_scored_grasp and pick_grasp_viewer.  A tool that touches tensors
takes `--device` ("cuda" by default; without a GPU it fails, and "cpu"
must be asked for).  Each `main(argv)` returns what it printed, so a
script can drive it."""
