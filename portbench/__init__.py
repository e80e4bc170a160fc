"""The benchmark of the PyTorch/CUDA port (`legged_gym_custom_tpu_torch`).
One run: `python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; see README.md."""
