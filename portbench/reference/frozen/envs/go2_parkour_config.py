"""go2_parkour task + train configs and its stage ladder, a copy of
legged_gym_custom_tpu/envs/go2_parkour_config.py (reference
go2_parkour_config.py and go2_parkour_finetune_config.py).

The stages resume in order, each from the newest run of experiment
`go2_parkour` (`runner.resume = True`, which also flips the ROA schedule to
a flat 0.1): finetune -> finetune2 -> bootcamp -> commit -> gap_commit ->
cliff.  They add a composite jump course, the motion-gated jump rewards,
the spawn curriculum (`init_state.rand_x_offsets`, `rand_x_jitter`,
`rand_vx_range`), progress-stall termination (`termination.stall_time_s`),
the `progress` reward and the cliff's `terrain.parkour_row_widths`.
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


# copied from JAX go2_parkour_config.py:135-186
class Go2ParkourFinetuneCfg(Go2ParkourCfg):
    """Jump finetuning (reference go2_parkour_finetune_config.py:3-55).

    The curriculum's plain gap courses teach running but let the policy
    settle into edge-hovering at wider gaps; the finetune stage switches to a
    fixed course of composite obstacles — [0.3 m gap, raised 0.2 m-long
    platform (+0.10..+0.35 m), 0.4 m gap] — that can only be crossed by an
    actual jump, with curriculum off, a wider command range, and a foot
    contact-force penalty for landing hard."""

    class terrain(Go2ParkourCfg.terrain):
        parkour = True
        curriculum = False
        add_roughness_to_selected_terrain = False

        _gap_heights = [-2.0, 0.10, -2.0, -2.0, 0.15, -2.0,
                        -2.0, 0.20, -2.0, -2.0, 0.25, -2.0,
                        -2.0, 0.30, -2.0, -2.0, 0.35, -2.0]
        _x_positions = [6.0, 6.3, 6.7, 10.0, 10.3, 10.7,
                        14.0, 14.3, 14.7, 18.0, 18.3, 18.7,
                        22.0, 22.3, 22.7, 26.0, 26.3, 26.7]

        parkour_kwargs = {
            "start_platform_length": 3.0,
            "start_platform_height": 0.0,
            "x_positions": _x_positions,
            "y_positions": [0.0, 0.0, 0.0] * 6,
            "obstacle_heights": _gap_heights,
            "obstacle_lengths": [0.3, 0.2, 0.4] * 6,
            "half_valid_width": 5.0,
            "border_width": 0.50,
            "border_height": -2.0,
        }

    class commands(Go2ParkourCfg.commands):
        class ranges(Go2ParkourCfg.commands.ranges):
            lin_vel_x = [0.5, 2.0]

    class rewards(Go2ParkourCfg.rewards):
        max_contact_force = 75.0

        class scales(Go2ParkourCfg.rewards.scales):
            feet_contact_forces = -0.01


class Go2ParkourFinetuneCfgPPO(Go2ParkourCfgPPO):
    class runner(Go2ParkourCfgPPO.runner):
        run_name = "parkour_finetune"
        # same experiment dir as the base task so resume finds its checkpoints
        # (reference go2_parkour_finetune_config.py:57-60)
        experiment_name = "go2_parkour"
        resume = True  # flips ROA schedule to flat 0.1 (reference ppo.py:42-43)


# copied from JAX go2_parkour_config.py:189-211
class Go2ParkourFinetune2Cfg(Go2ParkourFinetuneCfg):
    """Consolidation finetune — the analog of the reference's REPEATED
    finetune stages (its shipped networks are parkour_v12_ft_i ... ft_iii,
    i.e. finetunes of finetunes).  Same jump course, two changes:

    * jump-zone rewards gate on ACTUAL forward velocity (>0.3 m/s), not just
      the command mask — implementing the reference's stated intent ("reward
      only when the robot is moving", go2.py:771) and removing the
      stationary edge-bobbing exploit that creates the balk local optimum.
    * the entropy bonus drops to zero so the policy std decays and the
      deterministic mean consolidates onto the jumping behavior.
    """

    class rewards(Go2ParkourFinetuneCfg.rewards):
        jump_zone_fwd_gate = 0.3


class Go2ParkourFinetune2CfgPPO(Go2ParkourFinetuneCfgPPO):
    class algorithm(Go2ParkourFinetuneCfgPPO.algorithm):
        entropy_coef = 0.0

    class runner(Go2ParkourFinetuneCfgPPO.runner):
        run_name = "parkour_consolidate"


# copied from JAX go2_parkour_config.py:214-243
class Go2ParkourBootcampCfg(Go2ParkourFinetune2Cfg):
    """Jump bootcamp: the spawn curriculum concentrates experience at the
    obstacles — robots start scattered across the course's flat segments
    (one offset per segment, composites at x = 6 + 4k) with an initial
    forward velocity, so every episode confronts a composite within ~2 m of
    spawn while already in motion.  Combined with the motion-gated jump
    rewards this makes edge-balking both unprofitable and kinematically
    awkward (momentum carries the robot into the zone)."""

    class init_state(Go2ParkourFinetune2Cfg.init_state):
        # Flat-segment spawn slots: composites span [6+4k, 7.1+4k] in course
        # x and the base spawn is x=2, so slot+jitter lands spawns in
        # [3, 5.3] + 4k — 0.7-3.0 m before the next composite.  NOTE the
        # custom-origin reset additionally jitters xy by ±1 m
        # (_sample_reset_physics), so worst-case spawns still reach ~0.3 m
        # into a composite; the commit stage below leaves full 1 m slack.
        # (The round-4 run used a coarser {0,4,8,12,16}+[0,2] grid that put
        # ~25% of spawns inside gaps — insta-terminations that churned the
        # episode stats; corrected here.)
        rand_x_offsets = [1.0, 5.2, 9.2, 13.2]
        rand_x_jitter = (0.0, 2.3)
        rand_vx_range = (0.8, 1.6)


class Go2ParkourBootcampCfgPPO(Go2ParkourFinetune2CfgPPO):
    class algorithm(Go2ParkourFinetune2CfgPPO.algorithm):
        entropy_coef = 0.005   # keep a sliver of exploration pressure

    class runner(Go2ParkourFinetune2CfgPPO.runner):
        run_name = "parkour_bootcamp"


# copied from JAX go2_parkour_config.py:246-288
class Go2ParkourCommitCfg(Go2ParkourBootcampCfg):
    """Commitment stage (round 5) — makes edge-balking a losing strategy
    instead of hoping exploration out-competes it.

    The round-4 plateau: the stochastic policy attempts and sometimes lands
    composite crossings (flight-rich gait, 0.35 m open-loop air), but the
    deterministic mean brakes at every gap edge ≥0.2 m.  Balking survives
    because it is SAFE: a braked robot keeps its episode (and its trickle of
    phase/posture reward) while a missed jump dies.  Two additions change
    the payoff matrix directly:

    * progress-stall termination (`termination.stall_time_s`): with an
      active velocity command, 2 s without gaining NEW course ground ends
      the episode as a death (no value bootstrap).  Balking now forfeits the
      same future the missed jump does — committing is the only strategy
      with upside.  "New ground" (x beyond the episode's running max) is
      oscillation-proof: edge-bobs, backtracks and lateral pacing all gain
      none of it, while a pre-jump crouch shorter than 2 s is unaffected.
    * a `progress` reward on the same signal: pays scale*dx once per metre
      of new ground, so a landed crossing is worth the gap width in reward
      no matter how un-tracklike the jump's velocity profile is.

    Spawn slots leave a full 1 m of slack for the reset's ±1 m xy jitter so
    every spawn starts on support: slots+jitter+2 land in [3.1, 4.0]+{0,
    5.05, 9.05, 13.05} ⊂ flat segments ±1 m (composites span [6+4k, 7.1+4k]).
    """

    class init_state(Go2ParkourBootcampCfg.init_state):
        rand_x_offsets = [1.1, 6.15, 10.15, 14.15]
        rand_x_jitter = (0.0, 0.8)

    class termination:
        stall_time_s = 2.0     # s of no-new-ground under command → death
        stall_min_vel = 0.2    # m/s of new ground that counts as progress

    class rewards(Go2ParkourBootcampCfg.rewards):
        class scales(Go2ParkourBootcampCfg.rewards.scales):
            progress = 1.5     # ≈ perfect-tracking-sized at 1.5 m/s new ground


class Go2ParkourCommitCfgPPO(Go2ParkourBootcampCfgPPO):
    class runner(Go2ParkourBootcampCfgPPO.runner):
        run_name = "parkour_commit"


# copied from JAX go2_parkour_config.py:291-330
class Go2ParkourGapCommitCfg(Go2ParkourCommitCfg):
    """Commit stage, rung 2: plain-gap course with in-course width
    progression.  The composite jump course (gap + raised 0.2 m platform +
    gap) never produced crossings in the deterministic mean across five
    stages; this rung trains the acceptance capability directly — plain
    gaps widening 0.15→0.35 m along the course (the 0.15 m entry is a gap
    the r4 policy already crosses, so every episode starts from practiced
    behavior and the stall rule forces progression onto the wider ones).
    Spawn slots put robots on the flat segments between gaps (gap k spans
    [5+3.5k, 5.35+3.5k]; flats are ~3.15 m) with 1 m slack for the reset's
    ±1 m xy jitter."""

    class terrain(Go2ParkourCommitCfg.terrain):
        parkour = True
        curriculum = False
        add_roughness_to_selected_terrain = False
        _n = 7
        parkour_kwargs = {
            "start_platform_length": 3.0,
            "start_platform_height": 0.0,
            "x_positions": list(np.arange(5.0, 5.0 + 7 * 3.5, 3.5)),
            "y_positions": [0.0] * 7,
            "obstacle_heights": [-2.0] * 7,
            "obstacle_lengths": [0.15, 0.20, 0.25, 0.30, 0.30, 0.35, 0.35],
            "half_valid_width": 5.0,
            "border_width": 0.50,
            "border_height": -2.0,
        }

    class init_state(Go2ParkourCommitCfg.init_state):
        # flats between gaps: [5.35+3.5k, 8.5+3.5k]; spawn = 2 + slot +
        # jitter ± 1 must stay >=1 m inside → slot+2+[0,0.8] ∈ [6.35+3.5k+1,
        # 8.5+3.5k-1+0.8... keep simple margins]
        rand_x_offsets = [1.1, 4.6, 8.1, 11.6, 15.1]
        rand_x_jitter = (0.0, 0.8)


class Go2ParkourGapCommitCfgPPO(Go2ParkourCommitCfgPPO):
    class runner(Go2ParkourCommitCfgPPO.runner):
        run_name = "parkour_gap_commit"


# copied from JAX go2_parkour_config.py:333-368
class Go2ParkourCliffCfg(Go2ParkourCommitCfg):
    """Commit stage, rung 3: the CLIFF curriculum.

    Probing the gap_commit policy found a razor-sharp scandot-driven width
    cliff: deterministic crossings of 3-4 gaps at 0.15 m (98% survival),
    hard refusal at 0.20 m, at any commanded speed — 0.15 m is within
    stride reach, 0.20 m is perceived as a jump and never attempted.  A
    coarse curriculum (the reference's 0.1-per-row) jumps straight over the
    cliff; this rung ladders gap width in 0.01 m steps right at it, with
    per-env adaptive difficulty (terrain-curriculum promote on distance) so
    each robot trains at ITS commitment boundary.  Stall termination stays
    on: balking at the current width demotes AND dies."""

    class terrain(Go2ParkourCommitCfg.terrain):
        parkour = True
        curriculum = True
        num_rows = 10
        num_cols = 20
        terrain_proportions = [1.0, 0.0]  # all gap courses
        parkour_row_widths = [0.15, 0.16, 0.17, 0.18, 0.19,
                              0.20, 0.22, 0.24, 0.27, 0.30]
        promote_threshold = 0.40   # ~11 m = 2-3 gaps crossed at this width
        demote_threshold = 0.30
        max_init_terrain_level = 1

    class init_state(Go2ParkourCommitCfg.init_state):
        # spawn at the course start: the curriculum's promote metric is
        # distance from the env origin, so slot offsets would corrupt it
        rand_x_offsets = None
        rand_x_jitter = (0.0, 0.0)
        rand_vx_range = None


class Go2ParkourCliffCfgPPO(Go2ParkourCommitCfgPPO):
    class runner(Go2ParkourCommitCfgPPO.runner):
        run_name = "parkour_cliff"
