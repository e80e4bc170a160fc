"""go2_parkour task + train configs, a copy of Go2ParkourCfg and
Go2ParkourCfgPPO from legged_gym_custom_tpu/envs/go2_parkour_config.py
(reference go2_parkour_config.py).

The later parkour stages of that file (finetune, bootcamp, commit,
gap-commit, cliff) need resume, the spawn curriculum, progress-stall
termination, the progress reward and `parkour_row_widths`, and come with a
later slice.
"""
import numpy as np

from .go2_config import Go2Cfg, Go2CfgPPO


class Go2ParkourCfg(Go2Cfg):
    class env(Go2Cfg.env):
        num_envs = 4096
        # bounding phase for parkour (go2_parkour_config.py:18-22)
        period = 0.40
        fr_offset = 0.0
        bl_offset = 0.5
        fl_offset = 0.0
        br_offset = 0.5

    class terrain(Go2Cfg.terrain):
        mesh_type = "trimesh"
        measure_heights = True
        num_rows = 12
        num_cols = 20
        terrain_length = 28.0
        terrain_width = 10.0
        selected = False
        parkour = True
        curriculum = True
        promote_threshold = 0.60
        demote_threshold = 0.40
        terrain_proportions = [1.0, 0.0]  # [gaps, hurdles]
        max_init_terrain_level = 2

        _n = 7
        parkour_kwargs = {
            "start_platform_length": 3.0,
            "start_platform_height": 0.0,
            "x_positions": list(np.arange(5.0, 5.0 + 7 * 3.5, 3.5)),
            "y_positions": [0.0] * 7,
            "obstacle_heights": [-2.0] * 7,
            "obstacle_lengths": [0.2, 0.4, 0.6, 0.8, 1.0, 1.1, 1.2],
            "half_valid_width": 5.0,
            "border_width": 0.50,
            "border_height": -2.0,
        }

    class domain_rand(Go2Cfg.domain_rand):
        friction_range = [0.1, 1.0]

    class init_state(Go2Cfg.init_state):
        pos = [2.0, 0.0, 0.50]

    class asset(Go2Cfg.asset):
        terminate_after_contacts_on = ["base", "Head"]

    class commands(Go2Cfg.commands):
        resampling_time = 10.0
        zero_command = True
        zero_command_prob = 0.10
        curriculum = False
        max_forward_vel = 1.75
        max_reverse_vel = 0.5
        vel_increment = 0.10
        heading_command = True
        heading_error_gain = 0.5

        class ranges:
            lin_vel_x = [0.75, 1.5]
            lin_vel_y = [0.0, 0.0]
            ang_vel_yaw = [-0.0, 0.0]
            heading = [-0.2, 0.2]

    class rewards(Go2Cfg.rewards):
        only_positive_rewards = True
        soft_dof_pos_limit = 0.9
        base_height_target = 0.27
        max_foot_height = 0.08
        percent_time_on_ground = 0.50
        max_contact_force = 75.0

        class scales(Go2Cfg.rewards.scales):
            tracking_lin_vel = 2.25
            tracking_ang_vel = 2.25
            phase_contact_match = 1.0
            phase_foot_lifting = 1.0
            action_rate = -0.1
            lin_vel_z = -1.0
            ang_vel_xy = -0.01
            torques = -0.00001
            dof_acc = -2.5e-7
            delta_torques = -1.0e-7
            collision = -10.0
            orientation = -1.0
            stumble_feet = -1.0
            dof_error = -0.04
            hip_pos = -0.5
            thigh_pos = -0.5
            thigh_symmetry = -0.2
            calf_symmetry = -0.2
            heading_alignment = -4.5
            reverse_penalty = -1.0
            jump_zone_forward_vel = 1.75
            jump_zone_upward_vel = 3.75
            zero_cmd_dof_error = -1.0
            base_height = 0.0  # disabled for parkour


class Go2ParkourCfgPPO(Go2CfgPPO):
    class policy(Go2CfgPPO.policy):
        actor_hidden_dims = [512, 256, 128]
        critic_hidden_dims = [512, 256, 128]
        init_noise_std = 1.0
        priv_encoder_hidden_dims = [64, 20]
        latent_encoder_output_dim = 20
        scan_encoder_hidden_dims = [128, 64]
        scan_encoder_output_dim = 32
        estimator_hidden_dims = [256, 128]
        use_history = True
        activation = "elu"

    class algorithm(Go2CfgPPO.algorithm):
        estimator_learning_rate = 1e-4
        learning_rate = 2e-4
        schedule = "fixed"

    class runner(Go2CfgPPO.runner):
        num_steps_per_env = 24
        max_iterations = 5000
        save_interval = 50
        run_name = "parkour_v15_ft"
        experiment_name = "go2_parkour"
        resume = False
