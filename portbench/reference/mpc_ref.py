"""The plain reference of the MPPI cells: the frozen MPPI over the frozen env
(eager engine), fed each sampled solve's inputs as the program got them: the
robots' state, the warm-started plan and the noise generator's state."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import compare
from .frozen.mpc.mppi import MPPI, MPCState, MPPIConfig
from .frozen.physics.engine import DomainRandParams, PhysicsState
from .train_ref import generator, precision


def solve(mpc: MPPI, rec, tf32: bool = False):
    """(new plan, expected cost) of the reference for one recorded solve."""
    inp = rec["in"]
    ms = MPCState(nominal=inp["nominal"].clone(), phase=inp["phase"].clone())
    with precision(tf32), torch.no_grad():
        _, new, cost = mpc.solve(ms, PhysicsState(**rec["physics"]), DomainRandParams(**rec["dr"]),
                                 rec["commands"], generator(rec["generator"]))
    return new.nominal, cost


def numbers(env, mppi_cfg: dict, recs: List[dict], tf32: bool = False,
            prog_override=None) -> Dict[str, float]:
    """The widest gap over the sampled solves of the new plan and of the
    expected cost.  `prog_override(rec)` gives (plan, cost) in place of the
    program's recorded answer: the control's or a fault's."""
    mpc = MPPI(env, MPPIConfig(**mppi_cfg))
    plan = cost = 0.0
    for rec in recs:
        r_plan, r_cost = solve(mpc, rec)
        p_plan, p_cost = (rec["out"]["nominal"], rec["out"]["cost"]) if prog_override is None \
            else prog_override(mpc, rec)
        plan = max(plan, compare.rel(p_plan, r_plan))
        cost = max(cost, compare.rel(p_cost, r_cost))
    return {"plan": plan, "cost": cost}
