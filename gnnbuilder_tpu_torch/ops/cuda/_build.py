"""Build the CUDA kernels with nvcc into one plain-C shared library, load
it with ctypes.

Every ``csrc/*.cu`` is compiled by its own nvcc process, all started
together, and one more nvcc links the objects into ``libgnnb.so`` under
``build/gnnbuilder_tpu_torch/<hash>/`` at the repository root, where the
hash covers every source and header, the flags and the compiler path, so
an edit rebuilds and an unchanged tree reuses the build.  The library is
written under a temporary name and renamed into place when every step
succeeds.  The sources include no PyTorch header; the launchers take raw
pointers, sizes and a ``cudaStream_t`` and return the ``cudaError_t`` of
the launch.

    python -m gnnbuilder_tpu_torch.ops.cuda._build   # build and print ptxas

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

__all__ = ["load", "build", "build_log", "nvcc", "build_root",
           "set_build_root", "SOURCES"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "gnnbuilder_tpu_torch"
SOURCES = ("pna_block", "readout", "pna_layer", "scatter_bwd", "mp_block",
           "ell_bwd", "mp_layer", "gat_layer", "gat_block", "gat_bwd",
           "ell_agg", "gine_layer", "edge_block")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600
LIB_NAME = "libgnnb.so"

_lib: Optional[ctypes.CDLL] = None
# nvcc's output of the build this process made (the -Xptxas -v report:
# registers, shared memory and spills per kernel); empty when reused
build_log = ""


def nvcc() -> str:
    """Path of nvcc; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def build_root() -> pathlib.Path:
    """The directory under which each build's hashed directory lies."""
    return _BUILD_ROOT


def set_build_root(path) -> pathlib.Path:
    """Put later builds (and the lookup of earlier ones) under ``path``;
    a library this process has loaded stays loaded."""
    global _BUILD_ROOT
    _BUILD_ROOT = pathlib.Path(path).expanduser()
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    return _BUILD_ROOT


def _build_dir(nvcc_path: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(nvcc_path.encode())
    h.update(" ".join(FLAGS).encode())
    headers = sorted(p.name for p in _CSRC.glob("*.cuh"))
    for name in [f"{n}.cu" for n in SOURCES] + headers:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; [(returncode, output)] in order.
    Every process is waited for, and killed if the time limit passes."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def build() -> pathlib.Path:
    """Compile every source into the library unless it exists; raise with
    nvcc's output if nvcc fails.  Returns the library's path."""
    global build_log
    nvcc_path = nvcc()
    out_dir = _build_dir(nvcc_path)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out_dir / f"{name}.{tag}.o" for name in SOURCES]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    try:
        results = _run_all([
            [nvcc_path, *FLAGS, "-c", str(_CSRC / f"{name}.cu"), "-o",
             str(obj)] for name, obj in zip(SOURCES, objs)])
        build_log = "".join(out for _, out in results)
        failed = [n for n, (rc, _) in zip(SOURCES, results) if rc != 0]
        if failed:
            raise RuntimeError(f"CUDA kernel build failed in {failed}\n"
                               f"{build_log}")
        ((rc, out),) = _run_all([[nvcc_path, *FLAGS[:2], "-shared", "-o",
                                  str(tmp), *map(str, objs)]])
        build_log += out
        if rc != 0:
            raise RuntimeError(f"CUDA kernel link failed: nvcc exit {rc}\n"
                               f"{out}")
        os.replace(tmp, lib)
    finally:
        for f in [*objs, tmp]:
            if f.exists():
                f.unlink()
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


if __name__ == "__main__":
    print(build())
    print(build_log)
