"""Build a CUDA source of this package with nvcc and load it with ctypes.

Each kernel lives in ``fms_fsdp_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use it is compiled for Hopper into a shared library
under ``build/fms_fsdp_tpu_torch/<name>-<hash>/`` at the repo root, keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads
what is there. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library.

Nothing here runs at import: the CPU tests import every module, and a
build needs ``nvcc``, which a CPU-only install lacks. A build that fails
raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "fms_fsdp_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    ptxas: str  # the -Xptxas -v report of the build that made ``path``


_LOADED: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME/bin): the CUDA kernels of "
        "fms_fsdp_tpu_torch build from source at first use"
    )


def _paths(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")


def compile_source(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed build exists. Returns
    (library path, ptxas report)."""
    src, out_dir = _paths(name)
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, "ptxas.txt")
    if os.path.exists(lib_path):
        with open(log_path) as f:
            return lib_path, f.read()
    os.makedirs(out_dir, exist_ok=True)
    # build to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(log_path, "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path, proc.stderr


def load(name: str) -> BuiltLibrary:
    """The loaded library of ``csrc/<name>.cu``, built on first call."""
    if name not in _LOADED:
        path, ptxas = compile_source(name)
        _LOADED[name] = BuiltLibrary(ctypes.CDLL(path), path, ptxas)
    return _LOADED[name]


def ptxas_summary(report: str) -> Dict[str, Dict[str, int]]:
    """Registers, shared memory and spill bytes per kernel from an
    ``-Xptxas -v`` report: {mangled kernel name: {...}}."""
    fields = {
        "registers": re.compile(r"Used (\d+) registers"),
        "static_smem_bytes": re.compile(r"(\d+) bytes smem"),
        "spill_stores": re.compile(r"(\d+) bytes spill stores"),
        "spill_loads": re.compile(r"(\d+) bytes spill loads"),
    }
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = entry.group(1)
            out[current] = dict.fromkeys(fields, 0)
            continue
        if current is None:
            continue
        for key, pat in fields.items():
            m = pat.search(line)
            if m:
                out[current][key] = int(m.group(1))
    return out
