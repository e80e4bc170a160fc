"""Cassie configs (copy of legged_gym_custom_tpu/envs/cassie_config.py;
reference envs/cassie/cassie_config.py).

The real cassie.urdf is not in this repository: `asset.file` names the
synthetic Cassie-shaped stand-in the package ships (see the file's header).
One value differs from the JAX package's config: `sim.joint_armature`, the
drives' reflected rotor inertia, which the engine adds to the joint-space
inertia (the reference's Isaac plant runs its PD drives implicitly; this
explicit integrator, at the config's PD gains and 2.5 ms substeps, diverges
on the synthetic legs without it).
"""
from portbench.reference.frozen import LEGGED_GYM_RESOURCES_DIR
from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO


class CassieCfg(LeggedRobotCfg):
    class env(LeggedRobotCfg.env):
        num_envs = 4096
        num_actions = 12
        num_proprio = 169       # 48 + 121 height samples (11x11 grid)
        history_buffer_length = 5
        num_observations = 169 * 6
        num_scan_obs = 0
        num_estimated_obs = 6
        num_privileged_obs = 6
        num_critic_obs = 169 * 6 + 6 + 0 + 6

    class terrain(LeggedRobotCfg.terrain):
        mesh_type = "trimesh"
        measured_points_x = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
        measured_points_y = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]

    class init_state(LeggedRobotCfg.init_state):
        pos = [0.0, 0.0, 1.0]
        default_joint_angles = {
            "hip_abduction_left": 0.1, "hip_rotation_left": 0.0,
            "hip_flexion_left": 1.0, "thigh_joint_left": -1.8,
            "ankle_joint_left": 1.57, "toe_joint_left": -1.57,
            "hip_abduction_right": -0.1, "hip_rotation_right": 0.0,
            "hip_flexion_right": 1.0, "thigh_joint_right": -1.8,
            "ankle_joint_right": 1.57, "toe_joint_right": -1.57,
        }

    class control(LeggedRobotCfg.control):
        stiffness = {
            "hip_abduction": 100.0, "hip_rotation": 100.0,
            "hip_flexion": 200.0, "thigh_joint": 200.0, "ankle_joint": 200.0,
            "toe_joint": 40.0,
        }
        damping = {
            "hip_abduction": 3.0, "hip_rotation": 3.0,
            "hip_flexion": 6.0, "thigh_joint": 6.0, "ankle_joint": 6.0,
            "toe_joint": 1.0,
        }
        action_scale = 0.5
        decimation = 4

    class asset(LeggedRobotCfg.asset):
        file = LEGGED_GYM_RESOURCES_DIR + "/robots/cassie/urdf/cassie_synthetic.urdf"
        name = "cassie"
        foot_name = "toe"
        penalize_contacts_on = []
        terminate_after_contacts_on = ["pelvis"]
        self_collisions = 1

    class sim(LeggedRobotCfg.sim):
        # reflected rotor inertia [kg m^2], the armature of Agility's
        # cassie.xml (hip roll and yaw 0.038125, hip pitch and knee 0.09344,
        # toe 0.01225; the tarsus drive as the hip's)
        joint_armature = {
            "hip_abduction": 0.038125, "hip_rotation": 0.038125, "hip_flexion": 0.09344,
            "thigh_joint": 0.09344, "ankle_joint": 0.038125, "toe_joint": 0.01225,
        }

    class rewards(LeggedRobotCfg.rewards):
        soft_dof_pos_limit = 0.95
        soft_dof_vel_limit = 0.9
        soft_torque_limit = 0.9
        max_contact_force = 300.0
        only_positive_rewards = False

        class scales(LeggedRobotCfg.rewards.scales):
            termination = -200.0
            tracking_ang_vel = 1.0
            torques = -5.0e-6
            dof_acc = -2.0e-7
            lin_vel_z = -0.5
            feet_air_time = 5.0
            dof_pos_limits = -1.0
            no_fly = 0.25
            dof_vel = -0.0
            ang_vel_xy = -0.0
            feet_contact_forces = -0.0


class CassieCfgPPO(LeggedRobotCfgPPO):
    class runner(LeggedRobotCfgPPO.runner):
        run_name = ""
        experiment_name = "rough_cassie"

    class algorithm(LeggedRobotCfgPPO.algorithm):
        entropy_coef = 0.01
