"""The whole training step: the FLOPs of the window's iterations, counted
from shapes (`portbench/reference/net_flops.py`: physics from the frozen
kernel count of the spec each launch runs times the launches a control step,
plus the actuator network's matrix products a dof and tick times the dofs
and ticks; the networks' forward passes in collection, forward and backward
in the update), over the window's wall time at 67 TFLOP/s a card (float32
without TF32, the port's precision) times the cards."""
from portbench.reference import kernel_ops, net_flops, peaks


def read(run):
    w, f = run.window, run.facts
    if not w or not w["iterations"] or f.get("launch_spec") is None:
        return None
    env_cfg = f["configs"][0]
    mods = net_flops.module_flops(*f["configs"])
    kflops = (kernel_ops.cached_counts(f["launch_spec"])["flops"] * f["launches"]
              + mods["actuator"] * env_cfg.env.num_actions * env_cfg.control.decimation)
    total = sum(net_flops.iteration_flops(mods, kflops, w["envs"], w["steps_per_env"],
                                          f["epochs"], it[3]) for it in w["iterations"])
    return 100.0 * total / (w["elapsed_s"] * peaks.FP32_FLOPS * f.get("chips", 1))
