"""Unitree G1 humanoid configs (copy of legged_gym_custom_tpu/envs/g1_config.py;
reference "g1 (broken)/g1_config_broken.py", made functional as the JAX
package does).

The real g1_12dof.urdf is not in this repository: `asset.file` names the
synthetic G1-shaped stand-in the package ships (see the file's header).
One value differs from the JAX package's config: `sim.joint_armature`, the
drives' reflected rotor inertia, which the engine adds to the joint-space
inertia (the explicit integrator needs it at the config's PD gains and
2.5 ms substeps, as cassie_config.py says).
"""
from portbench.reference.frozen import LEGGED_GYM_RESOURCES_DIR
from .base_config import LeggedRobotCfg, LeggedRobotCfgPPO


class G1Cfg(LeggedRobotCfg):
    class env(LeggedRobotCfg.env):
        num_envs = 4096
        num_actions = 12
        num_proprio = 47       # 3+3+3+12+12+12+2 (g1_env_broken.py:70-82)
        history_buffer_length = 6   # min for the adaptation CNN (deviation:
                                    # the reference G1 had no history buffer)
        num_observations = 47 * 7
        num_scan_obs = 0
        num_estimated_obs = 3
        num_privileged_obs = 29
        num_critic_obs = 47 * 7 + 29 + 3 + 0
        period = 0.8

    class terrain(LeggedRobotCfg.terrain):
        mesh_type = "plane"
        measure_heights = False

    class init_state(LeggedRobotCfg.init_state):
        pos = [0.0, 0.0, 0.8]
        default_joint_angles = {
            "left_hip_yaw_joint": 0.0,
            "left_hip_roll_joint": 0.0,
            "left_hip_pitch_joint": -0.1,
            "left_knee_joint": 0.3,
            "left_ankle_pitch_joint": -0.2,
            "left_ankle_roll_joint": 0.0,
            "right_hip_yaw_joint": 0.0,
            "right_hip_roll_joint": 0.0,
            "right_hip_pitch_joint": -0.1,
            "right_knee_joint": 0.3,
            "right_ankle_pitch_joint": -0.2,
            "right_ankle_roll_joint": 0.0,
        }

    class control(LeggedRobotCfg.control):
        stiffness = {
            "hip_yaw": 100.0, "hip_roll": 100.0, "hip_pitch": 100.0,
            "knee": 150.0, "ankle": 40.0,
        }
        damping = {
            "hip_yaw": 2.0, "hip_roll": 2.0, "hip_pitch": 2.0,
            "knee": 4.0, "ankle": 2.0,
        }
        action_scale = 0.25
        decimation = 4

    class asset(LeggedRobotCfg.asset):
        file = LEGGED_GYM_RESOURCES_DIR + "/robots/g1/urdf/g1_12dof_synthetic.urdf"
        name = "g1"
        foot_name = "ankle_roll"
        penalize_contacts_on = ["hip", "knee"]
        terminate_after_contacts_on = ["pelvis"]
        self_collisions = 0

    class sim(LeggedRobotCfg.sim):
        # reflected rotor inertia [kg m^2]: plausible values of the order of
        # G1's hip, knee and ankle drives
        joint_armature = {"hip": 0.0102, "knee": 0.0251, "ankle": 0.0072}

    class rewards(LeggedRobotCfg.rewards):
        base_height_target = 0.78
        only_positive_rewards = True

        class scales(LeggedRobotCfg.rewards.scales):
            tracking_lin_vel = 1.0
            tracking_ang_vel = 0.5
            lin_vel_z = -2.0
            ang_vel_xy = -0.05
            orientation = -1.0
            base_height = -10.0
            dof_acc = -2.5e-7
            dof_vel = -1e-3
            action_rate = -0.01
            dof_pos_limits = -5.0
            alive = 0.15
            hip_pos = -1.0
            contact_no_vel = -0.2
            feet_swing_height = -20.0
            contact = 0.18
            collision = 0.0
            torques = 0.0


class G1CfgPPO(LeggedRobotCfgPPO):
    class policy(LeggedRobotCfgPPO.policy):
        init_noise_std = 0.8
        actor_hidden_dims = [256, 128, 128]
        critic_hidden_dims = [256, 128, 128]

    class runner(LeggedRobotCfgPPO.runner):
        run_name = ""
        experiment_name = "g1"
