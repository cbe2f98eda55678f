"""Builds the package's native sources (``csrc/``) at first use.

Each CUDA source (``*.cu``) is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads; each
host C source (``*.c``) by the system C compiler. The library's name
carries a hash of its source and flags, so an edited source is rebuilt and a
built one is reused. Libraries go to ``_build/`` inside the package, which
version control ignores.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CC_FLAGS = ["-O3", "-shared", "-fPIC"]


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, under $CUDA_HOME, or the toolkit's default
    place. Raises when there is none."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels of topaz_tpu_torch cannot be built")


def library_path(name: str, ext: str = ".cu") -> str:
    """Where the library built from ``csrc/<name><ext>`` lives."""
    flags = NVCC_FLAGS if ext == ".cu" else CC_FLAGS
    with open(os.path.join(CSRC_DIR, name + ext), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_libraries(names: List[str]) -> Dict[str, str]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: library path}."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"csrc/{name}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_library(name: str) -> str:
    """Path of the library built from ``csrc/<name>.cu``, building it first
    when needed."""
    return build_libraries([name])[name]


def build_c_library(name: str) -> str:
    """Path of the host library built from ``csrc/<name>.c`` by the system C
    compiler (``$CC``, else ``cc``), building it first when needed. Raises
    when there is no compiler or the build fails."""
    path = library_path(name, ".c")
    if os.path.exists(path):
        return path
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError(f"no C compiler ($CC, cc, gcc) to build csrc/{name}.c")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *CC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".c")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on csrc/{name}.c (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path
