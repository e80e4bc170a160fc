"""Batched Featherstone physics in PyTorch (port of legged_gym_custom_tpu/physics)."""
from .actuator import PDParams, compute_torques
from .algorithms import (
    ModelArrays,
    aba,
    body_inertias,
    crba,
    forward_kinematics,
    joint_transforms,
    model_arrays,
    rnea,
)
from .contact import ContactParams, compute_contacts, geom_centers, sample_surface
from .engine import (
    DomainRandParams,
    PhysicsState,
    SimParams,
    StepInfo,
    actuated_control_step,
    control_step,
    effective_joint_inertia,
    kernel_spec,
    link_states,
    patch_K,
    substep,
    tickwise_control_step,
)
from .heightfield import Heightfield, from_raw, height_bilinear, height_min3, plane, surface
from .patch import LocalPatch, extract as extract_patch
from .patch import height_min3 as patch_height_min3
from .model import RobotModel
from .urdf import load_urdf
