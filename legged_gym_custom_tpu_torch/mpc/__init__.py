"""Batched sampling MPC (MPPI) on the port's physics core."""
from .mppi import MPPI, CostStatics, MPCState, MPPIConfig, stage_cost
