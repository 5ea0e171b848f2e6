"""Build the port's host C++ libraries (`csrc/*.cpp`) with `g++`.

A library is compiled at first use into `_build/` beside the package
under a name keyed by the source bytes and the flags (written to a
temporary name and renamed, so processes building at once do not
collide) and loaded by its caller with ctypes.  A failing compiler
raises with its output: no caller falls back to a Python path.
`CXX` names another compiler.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from low_precision_raytracer_tpu_torch.ops.cuda_lib import BUILD, CSRC

CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


def build_host_library(name: str) -> Path:
    """-> the built `csrc/<name>.cpp` library's path in `_build/`, building
    it first if it is missing; raises RuntimeError with the compiler's
    output."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for csrc/{name}.cpp:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out
