"""Frozen copy (see portbench/reference/frozen/__init__.py).  The port's
`envs/__init__.py` registers its tasks with the task registry; here the
same registrations are one table, `TASKS`: each task's name to its (env
class, env config class, train config class)."""
from .anymal_config import AnymalCFlatCfg, AnymalCFlatCfgPPO, AnymalCRoughCfg, AnymalCRoughCfgPPO
from .anymal_env import AnymalEnv
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

TASKS = {
    "go2": (Go2Env, Go2Cfg, Go2CfgPPO),
    "go2_stiction": (Go2Env, Go2StictionCfg, Go2StictionCfgPPO),
    "go2_parkour": (Go2Env, Go2ParkourCfg, Go2ParkourCfgPPO),
    "go2_parkour_finetune": (Go2Env, Go2ParkourFinetuneCfg, Go2ParkourFinetuneCfgPPO),
    "go2_parkour_finetune2": (Go2Env, Go2ParkourFinetune2Cfg, Go2ParkourFinetune2CfgPPO),
    "go2_parkour_bootcamp": (Go2Env, Go2ParkourBootcampCfg, Go2ParkourBootcampCfgPPO),
    "go2_parkour_commit": (Go2Env, Go2ParkourCommitCfg, Go2ParkourCommitCfgPPO),
    "go2_parkour_gap_commit": (Go2Env, Go2ParkourGapCommitCfg, Go2ParkourGapCommitCfgPPO),
    "go2_parkour_cliff": (Go2Env, Go2ParkourCliffCfg, Go2ParkourCliffCfgPPO),
    "anymal_c_rough": (AnymalEnv, AnymalCRoughCfg, AnymalCRoughCfgPPO),
    "anymal_c_flat": (AnymalEnv, AnymalCFlatCfg, AnymalCFlatCfgPPO),
    "cassie": (CassieEnv, CassieCfg, CassieCfgPPO),
    "g1": (G1Env, G1Cfg, G1CfgPPO),
}
