from .config import Config, load_cfg_from_file, load_cfg_from_dict, default_config
from . import processing_config
from . import gripper_config
from . import real_world_config
