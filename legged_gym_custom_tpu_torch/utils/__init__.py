from .config import BaseConfig, class_to_dict, set_seed, update_class_from_dict
from .task_registry import TaskRegistry, get_load_path, task_registry, update_cfg_from_args
