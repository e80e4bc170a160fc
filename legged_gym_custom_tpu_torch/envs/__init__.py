"""Task family + registrations (port of legged_gym_custom_tpu/envs/__init__.py
:25-46): the flat `go2` and `go2_stiction` tasks, `go2_parkour` and its stage
ladder."""
from legged_gym_custom_tpu_torch.utils.task_registry import task_registry

from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .base_env import EnvState, LeggedEnv, Obs
from .go2_config import Go2Cfg, Go2CfgPPO, Go2StictionCfg, Go2StictionCfgPPO
from .go2_env import Go2Env
from .go2_parkour_config import (
    Go2ParkourBootcampCfg,
    Go2ParkourBootcampCfgPPO,
    Go2ParkourCfg,
    Go2ParkourCfgPPO,
    Go2ParkourCliffCfg,
    Go2ParkourCliffCfgPPO,
    Go2ParkourCommitCfg,
    Go2ParkourCommitCfgPPO,
    Go2ParkourFinetune2Cfg,
    Go2ParkourFinetune2CfgPPO,
    Go2ParkourFinetuneCfg,
    Go2ParkourFinetuneCfgPPO,
    Go2ParkourGapCommitCfg,
    Go2ParkourGapCommitCfgPPO,
)

task_registry.register("go2", Go2Env, Go2Cfg, Go2CfgPPO)
task_registry.register("go2_stiction", Go2Env, Go2StictionCfg, Go2StictionCfgPPO)
task_registry.register("go2_parkour", Go2Env, Go2ParkourCfg, Go2ParkourCfgPPO)
task_registry.register("go2_parkour_finetune", Go2Env, Go2ParkourFinetuneCfg,
                       Go2ParkourFinetuneCfgPPO)
task_registry.register("go2_parkour_finetune2", Go2Env, Go2ParkourFinetune2Cfg,
                       Go2ParkourFinetune2CfgPPO)
task_registry.register("go2_parkour_bootcamp", Go2Env, Go2ParkourBootcampCfg,
                       Go2ParkourBootcampCfgPPO)
task_registry.register("go2_parkour_commit", Go2Env, Go2ParkourCommitCfg, Go2ParkourCommitCfgPPO)
task_registry.register("go2_parkour_gap_commit", Go2Env, Go2ParkourGapCommitCfg,
                       Go2ParkourGapCommitCfgPPO)
task_registry.register("go2_parkour_cliff", Go2Env, Go2ParkourCliffCfg, Go2ParkourCliffCfgPPO)
