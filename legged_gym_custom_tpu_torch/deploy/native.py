"""ctypes binding for the native C++ deploy inference runtime, port of
legged_gym_custom_tpu/deploy/native.py over the port's own copy of the source
(deploy/csrc/deploy_runtime.cpp).

Replaces the reference's libtorch/TorchScript C++ runtime on the robot
(deploy_base.py:32-35) with a dependency-free shared library.  It is built
with g++ at first use into `build/native/`, one library per hash of the
source and the flags, and a failed build raises with the compiler's stderr:
nothing falls back to the numpy runtime.  The flags leave out
`-march=native`, so a library in the build directory runs on any x86-64 host
the checkout is copied to, and its arithmetic (no FMA contraction) is the
same on every one.

The weight file is a flat binary ("LGCT") written from the same .npz bundle
the numpy controller consumes (deploy/export.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess

import numpy as np

from .export import load_policy_bundle

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "deploy_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def write_flat_bundle(npz_path: str, out_path: str) -> str:
    """Convert an .npz policy bundle to the C runtime's flat binary format."""
    bundle = load_policy_bundle(npz_path)
    arrays = {}
    for mod in ("policy", "estimator", "scan_encoder", "adaptation_module"):
        for i, layer in enumerate(bundle[mod]):
            for kind, arr in layer.items():
                arrays[f"{mod}/{i}/{kind}"] = np.asarray(arr, np.float32)
    with open(out_path, "wb") as f:
        f.write(b"LGCT")
        f.write(struct.pack("<II", 1, len(arrays)))
        for name, arr in arrays.items():
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<I", d))
            f.write(np.ascontiguousarray(arr, np.float32).tobytes())
    return out_path


def library_path(source: str = SOURCE) -> str:
    """Where the library of `source` under CXX_FLAGS is built: the name is a
    hash of both."""
    with open(source, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"liblgc_deploy_{key}.so")


def build_library(source: str = SOURCE) -> str:
    """Build `source` with g++ into BUILD_DIR unless its library is there;
    returns the library's path.  Raises RuntimeError with the compiler's
    stderr when the build fails."""
    lib = library_path(source)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the native deploy runtime failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


class NativePolicy:
    """C++-evaluated policy: obs(572) + scan(132) -> actions(12)."""

    def __init__(self, flat_bundle_path: str, num_actions: int = 12):
        self.lib = ctypes.CDLL(build_library())
        self.lib.lgc_bundle_load.restype = ctypes.c_void_p
        self.lib.lgc_bundle_load.argtypes = [ctypes.c_char_p]
        self.lib.lgc_bundle_free.restype = None
        self.lib.lgc_bundle_free.argtypes = [ctypes.c_void_p]
        self.lib.lgc_policy_forward.restype = ctypes.c_int
        self.lib.lgc_policy_forward.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        self.handle = self.lib.lgc_bundle_load(flat_bundle_path.encode())
        if not self.handle:
            raise RuntimeError(f"failed to load {flat_bundle_path}")
        self.num_actions = num_actions

    def __call__(self, obs: np.ndarray, scan: np.ndarray) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32)
        scan = np.ascontiguousarray(scan, np.float32)
        out = np.zeros(self.num_actions, np.float32)
        rc = self.lib.lgc_policy_forward(
            self.handle,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), obs.size,
            scan.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), scan.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
        )
        if rc != 0:
            raise RuntimeError(f"lgc_policy_forward failed: {rc}")
        return out

    def close(self):
        if getattr(self, "handle", None):
            self.lib.lgc_bundle_free(ctypes.c_void_p(self.handle))
            self.handle = None

    def __del__(self):
        self.close()
