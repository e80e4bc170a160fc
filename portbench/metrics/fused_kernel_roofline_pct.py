"""Fused control-step layer (`physics/engine.py` -> `ops/fused_step.py` ->
`ops/csrc/fused_step.cu`): the kernel's least time at the published peaks
over its measured device time a launch.  The least time is the largest of
its flops at 67 TFLOP/s, its transcendentals at the SFU rate and its bytes
at 3.35 TB/s, all for the cell's batch; the counts are the frozen
`count_kernel_ops` of the spec each launch runs (the cell's spec, or its
one-tick spec where the env steps tick by tick), the time the mean of the
`fused_control_step_kernel` events of the traced window."""
from portbench.reference import kernel_ops, peaks

KERNEL = "fused_control_step_kernel"


def read(run):
    spec = run.facts.get("launch_spec")
    lo, hi = run.trace.window
    ks = [e - b for n, b, e in run.trace.device if n.startswith(KERNEL) and lo <= b and e <= hi]
    if spec is None or not ks:
        return None
    ops = kernel_ops.cached_counts(spec)
    B = run.facts["batch"]
    least = max(ops["flops"] * B / peaks.FP32_FLOPS,
                ops["transcendentals"] * B / peaks.SFU_OPS_PER_S,
                kernel_ops.kernel_bytes_per_env(spec) * B / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / (sum(ks) / len(ks) / 1e9)
