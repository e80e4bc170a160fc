"""Deploy stack, port of legged_gym_custom_tpu/deploy: the `.npz` policy-bundle
export, the numpy policy runtime, the YAML deploy config, the native C++
runtime, MuJoCo scenes and the sim-to-sim runner, the gamepad and the
real-robot DDS client.  Importing the package needs neither `yaml` nor
`mujoco`: each is imported by the code that reads a config or steps MuJoCo."""
from .config_parser import ConfigParser
from .controller import BaseController, NumpyAdaptationEncoder, NumpyMLP, parse_scan_trace
from .export import export_policy_bundle, load_policy_bundle
