"""Base task + train configs (copy of legged_gym_custom_tpu/envs/base_config.py).

Default values replicate the reference; engine-specific additions are marked.
Configs are nested classes instantiated recursively (utils/config.py).
"""
from portbench.reference.frozen.utils.config import BaseConfig


class LeggedRobotCfg(BaseConfig):
    class env:
        history_buffer_length = 5
        num_proprio = 235
        num_scan_obs = 0
        num_estimated_obs = 6
        num_observations = 235 * 6
        num_envs = 4096
        num_privileged_obs = 6
        num_critic_obs = 235 * 6 + 6 + 0 + 6
        num_actions = 12
        env_spacing = 3.0
        send_timeouts = True
        episode_length_s = 20
        # gait phase features (go2 tasks override; reference go2_config.py:18-22)
        period = 0.45
        fr_offset = 0.0
        bl_offset = 0.0
        fl_offset = 0.5
        br_offset = 0.5

    class terrain:
        mesh_type = "trimesh"  # none, plane, heightfield, trimesh
        horizontal_scale = 0.1
        vertical_scale = 0.005
        border_size = 25
        curriculum = True
        promote_threshold = 0.60
        demote_threshold = 0.40
        static_friction = 1.0
        dynamic_friction = 1.0
        restitution = 0.0
        terrain_length = 8.0
        terrain_width = 8.0
        num_rows = 10
        num_cols = 20
        measure_heights = True
        measured_points_x = [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
                             0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
        measured_points_y = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
        selected = False
        terrain_kwargs = None
        max_init_terrain_level = 5
        terrain_proportions = [0.1, 0.1, 0.35, 0.25, 0.2, 0.0, 0.0]
        add_roughness_to_selected_terrain = False
        parkour = False
        slope_treshold = 0.75

    class commands:
        curriculum = False
        max_curriculum = 1.0
        num_commands = 4
        resampling_time = 10.0
        heading_command = True
        heading_error_gain = 0.5
        zero_command = False
        zero_command_prob = 0.10
        user_command = []
        # command curriculum extents (reference go2_config.py:185-187)
        max_forward_vel = 1.0
        max_reverse_vel = -1.0
        vel_increment = 0.10

        class ranges:
            lin_vel_x = [-1.0, 1.0]
            lin_vel_y = [-1.0, 1.0]
            ang_vel_yaw = [-1.0, 1.0]
            heading = [-3.14, 3.14]

    class init_state:
        pos = [0.0, 0.0, 1.0]
        rot = [0.0, 0.0, 0.0, 1.0]  # xyzw to match reference configs
        lin_vel = [0.0, 0.0, 0.0]
        ang_vel = [0.0, 0.0, 0.0]
        default_joint_angles = {"joint_a": 0.0, "joint_b": 0.0}

    class control:
        control_type = "P"
        stiffness = {"joint_a": 10.0, "joint_b": 15.0}
        damping = {"joint_a": 1.0, "joint_b": 1.5}
        action_scale = 0.5
        decimation = 4
        use_actuator_network = False
        actuator_net_file = None

    class asset:
        file = ""
        name = "legged_robot"
        foot_name = "None"
        penalize_contacts_on = []
        terminate_after_contacts_on = []
        disable_gravity = False
        fix_base_link = False
        self_collisions = 0

    class domain_rand:
        randomize_friction = True
        friction_range = [0.5, 1.25]
        randomize_base_mass = False
        added_mass_range = [-1.0, 1.0]
        randomize_center_of_mass = False
        added_com_range = [-0.2, 0.2]
        randomize_kp_kd = False
        kp_kd_range = [0.8, 1.2]
        push_robots = False
        push_interval_s = 15
        max_push_vel_xy = 1.0

    class rewards:
        class scales:
            termination = -0.0
            tracking_lin_vel = 1.0
            tracking_ang_vel = 0.5
            lin_vel_z = -2.0
            ang_vel_xy = -0.05
            orientation = -0.0
            torques = -0.00001
            dof_vel = -0.0
            dof_acc = -2.5e-7
            base_height = -0.0
            feet_air_time = 0.0
            collision = -1.0
            stumble_feet = -0.0
            action_rate = -0.01
            stand_still = -0.0
            contact_forces = -0.0

        only_positive_rewards = True
        tracking_sigma = 0.25
        soft_dof_pos_limit = 1.0
        soft_dof_vel_limit = 1.0
        soft_torque_limit = 1.0
        base_height_target = 1.0
        max_contact_force = 100.0
        pitch_deg_target = 0.0
        roll_deg_target = 0.0
        max_foot_height = 0.08
        percent_time_on_ground = 0.50

    class normalization:
        clip_observations = 100.0
        clip_actions = 100.0

        class obs_scales:
            lin_vel = 2.0
            ang_vel = 0.25
            dof_pos = 1.0
            dof_vel = 0.05
            height_measurements = 5.0

    class noise:
        add_noise = True
        noise_level = 1.0

        class noise_scales:
            lin_vel = 0.1
            ang_vel = 0.2
            dof_pos = 0.01
            dof_vel = 1.5
            gravity = 0.05
            imu = 0.05
            height_measurements = 0.1

    class viewer:
        ref_env = 0
        pos = [10, 0, 6]
        lookat = [11.0, 5, 3.0]

    class sim:
        dt = 0.005
        gravity = [0.0, 0.0, -9.81]
        up_axis = 1
        # --- batched engine (replaces the reference's `physx` block) ---
        substeps = 2               # integrator substeps per torque update
        contact_stiffness = 6000.0
        contact_damping = 100.0
        contact_friction_vel = 80.0
        joint_limit_stiffness = 60.0
        joint_limit_damping = 2.0
        # --- joint passive dynamics (scalar or {name-substring: value} dict,
        # matched like control.stiffness).  Defaults 0 = the reference's Isaac
        # training plant (armature=0, legged_robot_config.py:107); robot
        # configs override with their deploy plant's values (go2.xml:9) so
        # trained policies transfer.
        joint_damping = 0.0
        joint_armature = 0.0
        joint_frictionloss = 0.0
        # --- port addition: step on the card through the fused kernel (True),
        # or the eager engine (False: the heightfield modes the kernel does
        # not cover, a yardstick).  LGC_FUSED_KERNEL=0 / off / false turns it
        # off for every env built while it is set; the env prints the choice.
        fused_kernel = True

    class parallel:
        """Data-parallel layout (JAX base_config.py:197-200): the env batch is
        split over one rank per card; `scripts/train.py` reads it."""
        data_axis = "data"         # env batch sharded over this mesh axis
        mesh_shape = None          # None -> all local cards; an int -> that many


class LeggedRobotCfgPPO(BaseConfig):
    seed = 1
    runner_class_name = "OnPolicyRunner"

    class policy:
        init_noise_std = 1.0
        actor_hidden_dims = [512, 256, 128]
        critic_hidden_dims = [512, 256, 128]
        priv_encoder_hidden_dims = [64, 20]
        scan_encoder_hidden_dims = [128, 64]
        estimator_hidden_dims = [256, 128]
        use_history = True
        latent_encoder_output_dim = 20
        scan_encoder_output_dim = 32
        activation = "elu"

    class algorithm:
        dagger_update_freq = 20
        value_loss_coef = 1.0
        use_clipped_value_loss = True
        clip_param = 0.2
        entropy_coef = 0.01
        num_learning_epochs = 5
        num_mini_batches = 4
        learning_rate = 1.0e-3
        estimator_learning_rate = 1.0e-3
        schedule = "adaptive"
        gamma = 0.99
        lam = 0.95
        desired_kl = 0.01
        max_grad_norm = 1.0

    class runner:
        policy_class_name = "ActorCritic"
        algorithm_class_name = "PPO"
        num_steps_per_env = 24
        max_iterations = 10000
        save_interval = 100
        experiment_name = "test"
        run_name = ""
        resume = False
        load_run = -1
        checkpoint = -1
        resume_path = None
