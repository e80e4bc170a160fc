"""Task family + registrations (port of legged_gym_custom_tpu/envs/__init__.py;
the flat `go2` and `go2_stiction` tasks and `go2_parkour` so far)."""
from legged_gym_custom_tpu_torch.utils.task_registry import task_registry

from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .base_env import EnvState, LeggedEnv, Obs
from .go2_config import Go2Cfg, Go2CfgPPO, Go2StictionCfg, Go2StictionCfgPPO
from .go2_env import Go2Env
from .go2_parkour_config import Go2ParkourCfg, Go2ParkourCfgPPO

task_registry.register("go2", Go2Env, Go2Cfg, Go2CfgPPO)
task_registry.register("go2_stiction", Go2Env, Go2StictionCfg, Go2StictionCfgPPO)
task_registry.register("go2_parkour", Go2Env, Go2ParkourCfg, Go2ParkourCfgPPO)
