"""Go2 task + train configs (copy of legged_gym_custom_tpu/envs/go2_config.py).

The flat `go2` task and `go2_stiction`, the same task on the
implicit-stiction plant.
"""
from portbench.reference.frozen import LEGGED_GYM_RESOURCES_DIR
from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO


class Go2Cfg(LeggedRobotCfg):
    class env(LeggedRobotCfg.env):
        num_envs = 4096
        num_proprio = 52
        num_scan_obs = 132
        num_estimated_obs = 3
        num_privileged_obs = 4 + 1 + 12 + 12
        history_buffer_length = 10
        num_actions = 12
        num_critic_obs = 52 * 11 + 29 + 3 + 132
        num_observations = 52 * 11
        # trot phase features (go2_config.py:18-22)
        period = 0.45
        fr_offset = 0.0
        bl_offset = 0.0
        fl_offset = 0.5
        br_offset = 0.5

    class terrain(LeggedRobotCfg.terrain):
        measured_points_x = [-0.45, -0.3, -0.15, 0, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05, 1.2]
        measured_points_y = [-0.75, -0.6, -0.45, -0.3, -0.15, 0.0, 0.15, 0.3, 0.45, 0.6, 0.75]
        mesh_type = "plane"
        measure_heights = False
        add_roughness_to_selected_terrain = False
        num_rows = 10
        num_cols = 20
        terrain_length = 8.0
        terrain_width = 8.0
        parkour = False
        selected = False
        curriculum = False
        max_init_terrain_level = 1
        promote_threshold = 0.5
        demote_threshold = 0.4
        terrain_proportions = [0.20, 0.20, 0.20, 0.20, 0.20, 0.00, 0.00]

    class domain_rand:
        randomize_friction = True
        friction_range = [0.3, 1.2]
        randomize_base_mass = True
        added_mass_range = [0.0, 3.0]
        randomize_center_of_mass = True
        added_com_range = [-0.15, 0.15]
        randomize_kp_kd = True
        kp_kd_range = [0.8, 1.2]
        push_robots = True
        push_interval_s = 8
        max_push_vel_xy = 0.5

    class init_state(LeggedRobotCfg.init_state):
        pos = [0.0, 0.0, 0.42]
        default_joint_angles = {
            "FL_hip_joint": 0.1, "FL_thigh_joint": 0.8, "FL_calf_joint": -1.5,
            "FR_hip_joint": -0.1, "FR_thigh_joint": 0.8, "FR_calf_joint": -1.5,
            "RL_hip_joint": 0.1, "RL_thigh_joint": 1.0, "RL_calf_joint": -1.5,
            "RR_hip_joint": -0.1, "RR_thigh_joint": 1.0, "RR_calf_joint": -1.5,
        }

    class control(LeggedRobotCfg.control):
        control_type = "P"
        stiffness = {"joint": 40.0}
        damping = {"joint": 1.0}
        action_scale = 0.25
        decimation = 4

    class asset(LeggedRobotCfg.asset):
        # The real go2.urdf is not in this repository; the synthetic
        # Go2-shaped model stands in for it (see the file's header).
        file = LEGGED_GYM_RESOURCES_DIR + "/robots/go2/urdf/go2_synthetic.urdf"
        name = "go2"
        foot_name = "foot"
        penalize_contacts_on = ["base", "hip", "thigh", "calf", "Head"]
        terminate_after_contacts_on = ["base"]
        self_collisions = 0

    class sim(LeggedRobotCfg.sim):
        # Plant fidelity for sim-to-sim transfer (round-4; VERDICT r3 #1):
        # joint passive dynamics from the deploy plant (go2.xml:9) and a
        # stiffer, overdamped contact so the trained gait does not exploit
        # penalty-spring push-off energy that MuJoCo's hard contact (and the
        # real robot) won't return.  substeps=4 keeps the explicit integrator
        # inside its stability bound at the higher stiffness
        # (tests/test_engine.py::test_joint_passive_dynamics).
        substeps = 4
        contact_stiffness = 40000.0
        contact_damping = 250.0
        contact_friction_vel = 250.0
        joint_damping = 0.1
        joint_armature = 0.01
        joint_frictionloss = 0.2

    class commands(LeggedRobotCfg.commands):
        resampling_time = 10.0
        zero_command = True
        zero_command_prob = 0.10
        curriculum = False
        max_forward_vel = 1.0
        max_reverse_vel = -1.0
        vel_increment = 0.10
        heading_command = False

        class ranges:
            lin_vel_x = [-1.0, 1.0]
            lin_vel_y = [-0.75, 0.75]
            ang_vel_yaw = [-1.0, 1.0]
            heading = [-0.2, 0.2]

    class normalization(LeggedRobotCfg.normalization):
        clip_observations = 100.0
        clip_actions = 3.14

    class noise(LeggedRobotCfg.noise):
        add_noise = True
        noise_level = 1.0

        class noise_scales(LeggedRobotCfg.noise.noise_scales):
            lin_vel = 0.1
            dof_pos = 0.01
            dof_vel = 0.05
            ang_vel = 0.05
            gravity = 0.02
            imu = 0.02
            height_measurements = 0.02

    class rewards(LeggedRobotCfg.rewards):
        only_positive_rewards = True
        soft_dof_pos_limit = 0.9
        base_height_target = 0.25
        pitch_deg_target = 0.0
        roll_deg_target = 0.0
        max_foot_height = 0.08
        percent_time_on_ground = 0.50
        max_contact_force = 100.0

        class scales(LeggedRobotCfg.rewards.scales):
            tracking_lin_vel = 1.5
            tracking_ang_vel = 1.0
            phase_contact_match = 1.0
            phase_foot_lifting = 0.25
            lin_vel_z = -2.0
            action_rate = -0.1
            ang_vel_xy = -0.01
            torques = -0.00001
            dof_acc = -2.5e-7
            delta_torques = -1.0e-7
            orientation = -5.0
            base_height = -20.0
            collision = -10.0
            dof_error = -0.04
            hip_pos = -0.75


class Go2CfgPPO(LeggedRobotCfgPPO):
    class policy(LeggedRobotCfgPPO.policy):
        init_noise_std = 1.0
        actor_hidden_dims = [512, 256, 128]
        critic_hidden_dims = [512, 256, 128]
        latent_encoder_output_dim = 20
        scan_encoder_output_dim = 32
        activation = "elu"

    class algorithm(LeggedRobotCfgPPO.algorithm):
        value_loss_coef = 1.0
        use_clipped_value_loss = True
        clip_param = 0.2
        entropy_coef = 0.01
        num_learning_epochs = 5
        num_mini_batches = 4
        learning_rate = 2e-4
        estimator_learning_rate = 2e-4
        schedule = "fixed"
        gamma = 0.99
        lam = 0.95
        desired_kl = 0.01
        max_grad_norm = 1.0
        dagger_update_freq = 20

    class runner(LeggedRobotCfgPPO.runner):
        num_steps_per_env = 24
        max_iterations = 5000
        save_interval = 50
        run_name = "go2_base_policy"
        experiment_name = "go2"
        resume = False


class Go2StictionCfg(Go2Cfg):
    """Flat go2 on the implicit-stiction plant: frictionloss as a
    velocity-space Coulomb clamp with true holding torque at rest (engine
    `frictionloss_implicit`) instead of the tanh surrogate."""

    class sim(Go2Cfg.sim):
        joint_frictionloss_implicit = True


class Go2StictionCfgPPO(Go2CfgPPO):
    class runner(Go2CfgPPO.runner):
        run_name = "go2_stiction"
