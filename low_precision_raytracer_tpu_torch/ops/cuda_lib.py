"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with `ctypes`.  Libraries are cached in
`_build/` beside the package under a name keyed by the source bytes, the
bytes of the shared headers (`csrc/*.cuh`) and the flags, so a changed
source or header rebuilds and an unchanged one loads at once.  Nothing is built or loaded at import time: the CPU tests import
every module on a machine with no `nvcc`.

Every C entry point launches on the stream it is given and returns its
`cudaError_t` (0 on success); `check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("dense_trace", "dense_multi", "svgf", "wavefront", "packet_trace", "mxu_proto",
           "bvh_walk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction into FMA: the kernels round like their plain versions
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each C entry point, by library
SIGNATURES = {
    "dense_trace": {
        "lprt_dense_trace": [P] * 9 + [I, I, I, F] + [I, F, F, F] + [I, I] + [P] * 6 + [P],
    },
    "dense_multi": {
        "lprt_dense_multi": [P] * 14 + [I] * 8 + [F] * 3 + [P] * 6 + [P],
        "lprt_band_scan": [P] * 8 + [I] * 5 + [F] * 3 + [P] * 5 + [P],
    },
    "svgf": {
        "lprt_coef_fetch": [P, P, I, I, I, I, I, P, P],
        "lprt_temporal": [P, P, P, I, I, F, F, F, F, F, P, P, P, P],
        "lprt_wavelet": [P, P, I, I, I, F, F, F, F, P, P],
    },
    "wavefront": {
        "lprt_wavefront_schedule": [P] * 6 + [I] * 6 + [P] * 3 + [P],
        "lprt_wavefront_assigned": [P] * 6 + [I, I] + [P] * 3 + [I] * 4 + [P] * 5,
    },
    "mxu_proto": {
        "lprt_mxu_proto_vpu": [P] * 3 + [I] * 3 + [P] * 3 + [P],
        "lprt_mxu_proto_mxu": [P] * 4 + [I] * 5 + [P] * 3 + [P],
    },
    "packet_trace": {
        "lprt_packet_trace": [P] * 14 + [I] * 7 + [F] * 3 + [P] * 6 + [P],
    },
    "bvh_walk": {
        "lprt_bvh_walk": [P] * 16 + [I] * 5 + [F] * 6 + [P] * 6 + [P],
        "lprt_bvh_walk_stack": [P] * 18 + [I] * 5 + [F] * 6 + [P] * 6 + [P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}

# launches per kernel wrapper, counted where the wrapper launches its
# kernel (never on the CPU path); a run resets them to read its own counts
LAUNCHES = {"dense_trace": 0, "dense_trace_multi": 0, "coef_fetch": 0,
            "temporal_accum": 0, "wavelet_iter": 0, "wavefront_schedule": 0,
            "wavefront_assigned": 0, "packet_trace": 0,
            # the packed epilogue's forms of K1a and K1b
            "dense_trace_pack": 0, "dense_trace_multi_pack": 0,
            # the measurement tool's two bodies (tools/mxu_proto.py)
            "mxu_proto_vpu": 0, "mxu_proto_mxu": 0,
            # the all-row scan of a widened band: the walks' reference on
            # the card, on no render path (a render must leave it at 0)
            "band_scan": 0,
            # the two-level BVH walk (traversal_impl='jax')
            "bvh_walk": 0,
            # its first form, the walk's reference on the card: on no render
            # path (a render must leave it at 0)
            "bvh_walk_ref": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one `nvcc` per source, all started
    together.  -> {name: nvcc's output (ptxas register/spill report)}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
