"""Task family + registrations (port of legged_gym_custom_tpu/envs/__init__.py
:25-75): the flat `go2` and `go2_stiction` tasks, `go2_parkour` and its stage
ladder, and the other robots: `anymal_c_rough` and `anymal_c_flat` (the SEA
actuator network), `cassie` and `g1`.  The configs import nothing that can be
missing, so a failure here is a bug and raises."""
from legged_gym_custom_tpu_torch.utils.task_registry import task_registry

from .anymal_config import AnymalCFlatCfg, AnymalCFlatCfgPPO, AnymalCRoughCfg, AnymalCRoughCfgPPO
from .anymal_env import AnymalEnv
from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO
from .base_env import EnvState, LeggedEnv, Obs
from .cassie_config import CassieCfg, CassieCfgPPO
from .cassie_env import CassieEnv
from .g1_config import G1Cfg, G1CfgPPO
from .g1_env import G1Env
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
task_registry.register("anymal_c_rough", AnymalEnv, AnymalCRoughCfg, AnymalCRoughCfgPPO)
task_registry.register("anymal_c_flat", AnymalEnv, AnymalCFlatCfg, AnymalCFlatCfgPPO)
task_registry.register("cassie", CassieEnv, CassieCfg, CassieCfgPPO)
task_registry.register("g1", G1Env, G1Cfg, G1CfgPPO)
