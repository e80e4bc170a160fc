"""Deploy stack: the `.npz` policy-bundle export and the numpy policy runtime
(port of legged_gym_custom_tpu/deploy; the config parser, the MuJoCo runner
and the real-robot client are not ported)."""
from .controller import BaseController, NumpyAdaptationEncoder, NumpyMLP, parse_scan_trace
from .export import export_policy_bundle, load_policy_bundle
