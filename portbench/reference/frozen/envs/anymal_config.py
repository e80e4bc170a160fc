"""ANYmal-C configs (copy of legged_gym_custom_tpu/envs/anymal_config.py;
reference envs/anymal_c/mixed_terrains/anymal_c_rough_config.py and
flat/anymal_c_flat_config.py).

The real anymal_c.urdf and anydrive_v3_lstm.pt are not in this repository:
`asset.file` names the synthetic ANYmal-shaped stand-in the package ships
(see the file's header), and `control.actuator_net_file` the reference's
path under LEGGED_GYM_RESOURCES, which a caller points at a TorchScript of
the SEA network's shape; a missing file raises, it never falls back to PD.
"""
from portbench.reference.frozen import LEGGED_GYM_RESOURCES_DIR
from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO


class AnymalCRoughCfg(LeggedRobotCfg):
    class env(LeggedRobotCfg.env):
        num_envs = 4096
        num_actions = 12
        num_proprio = 235       # 48 + 187 height samples
        history_buffer_length = 5
        num_observations = 235 * 6
        num_scan_obs = 0
        num_estimated_obs = 6
        num_privileged_obs = 6
        num_critic_obs = 235 * 6 + 6 + 0 + 6

    class terrain(LeggedRobotCfg.terrain):
        mesh_type = "trimesh"

    class init_state(LeggedRobotCfg.init_state):
        pos = [0.0, 0.0, 0.6]
        default_joint_angles = {
            "LF_HAA": 0.0, "LH_HAA": 0.0, "RF_HAA": -0.0, "RH_HAA": -0.0,
            "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
            "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
        }

    class control(LeggedRobotCfg.control):
        stiffness = {"HAA": 80.0, "HFE": 80.0, "KFE": 80.0}
        damping = {"HAA": 2.0, "HFE": 2.0, "KFE": 2.0}
        action_scale = 0.5
        decimation = 4
        use_actuator_network = True
        actuator_net_file = (
            LEGGED_GYM_RESOURCES_DIR + "/actuator_nets/anydrive_v3_lstm.pt"
        )

    class asset(LeggedRobotCfg.asset):
        file = LEGGED_GYM_RESOURCES_DIR + "/robots/anymal_c/urdf/anymal_c_synthetic.urdf"
        name = "anymal_c"
        foot_name = "FOOT"
        penalize_contacts_on = ["SHANK", "THIGH"]
        terminate_after_contacts_on = ["base"]
        self_collisions = 1

    class domain_rand(LeggedRobotCfg.domain_rand):
        randomize_base_mass = True
        added_mass_range = [-5.0, 5.0]

    class rewards(LeggedRobotCfg.rewards):
        base_height_target = 0.5
        max_contact_force = 500.0
        only_positive_rewards = True

        class scales(LeggedRobotCfg.rewards.scales):
            pass


class AnymalCRoughCfgPPO(LeggedRobotCfgPPO):
    class runner(LeggedRobotCfgPPO.runner):
        run_name = ""
        experiment_name = "rough_anymal_c"
        load_run = -1


class AnymalCFlatCfg(AnymalCRoughCfg):
    class env(AnymalCRoughCfg.env):
        num_proprio = 48
        num_observations = 48 * 6
        num_critic_obs = 48 * 6 + 6 + 0 + 6

    class terrain(AnymalCRoughCfg.terrain):
        mesh_type = "plane"
        measure_heights = False

    class asset(AnymalCRoughCfg.asset):
        self_collisions = 0

    class rewards(AnymalCRoughCfg.rewards):
        max_contact_force = 350.0

        class scales(AnymalCRoughCfg.rewards.scales):
            orientation = -5.0
            torques = -0.000025
            feet_air_time = 2.0

    class commands(AnymalCRoughCfg.commands):
        heading_command = False
        resampling_time = 4.0

        class ranges(AnymalCRoughCfg.commands.ranges):
            ang_vel_yaw = [-1.5, 1.5]

    class domain_rand(AnymalCRoughCfg.domain_rand):
        friction_range = [0.0, 1.5]


class AnymalCFlatCfgPPO(AnymalCRoughCfgPPO):
    class policy(AnymalCRoughCfgPPO.policy):
        actor_hidden_dims = [128, 64, 32]
        critic_hidden_dims = [128, 64, 32]
        activation = "elu"

    class algorithm(AnymalCRoughCfgPPO.algorithm):
        entropy_coef = 0.01

    class runner(AnymalCRoughCfgPPO.runner):
        run_name = ""
        experiment_name = "flat_anymal_c"
        load_run = -1
        max_iterations = 300
