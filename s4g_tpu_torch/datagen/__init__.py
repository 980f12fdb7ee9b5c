"""Synthetic training-data factory (the reference's data_gen half; port of
s4g_tpu/datagen).

Pipeline (reference README.md:105-108): random scene generation (MuJoCo) ->
viewed-point rendering -> scene point generation -> grasp pose searching ->
grasp pose post-processing, plus movability labels and the merge step.
The device stages run on CUDA unless the caller passes device="cpu".
"""

from .generate import generate_end_to_end, generate_scenes, grade_object
from .grading import (darboux_frames, estimate_normals, grade_frames,
                      antipodal_scores)
from .mesh_tools import (load_mesh, make_box, make_cylinder, make_icosphere,
                         save_stl)
from .scene_compose import compose_scene
