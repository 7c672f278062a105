"""Build the native packing library with g++ at first use.

``packing.cpp`` is compiled into ``libgnnb_packing.so`` under
``<build root>/native/<hash>/`` (the build root of the CUDA kernels,
``ops/cuda/_build.py``: ``build/gnnbuilder_tpu_torch`` of the checkout),
where the hash covers the source, the flags and the compiler's path and
version, so an edit rebuilds and an unchanged tree reuses the build.  The
library is written under a name of its own process and thread and renamed
into place, so processes that build at once each load a whole library.
A failed build raises with the compiler's output: there is no numpy
fallback.  The flags are portable (no ``-march=native``): a build
directory copied to another machine still loads there.

    python -m gnnbuilder_tpu_torch.native.build   # build, print the path
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["build", "library_path", "SRC", "FLAGS"]

SRC = pathlib.Path(__file__).resolve().parent / "packing.cpp"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "libgnnb_packing.so"
GXX_TIMEOUT_S = 120


def compiler() -> str:
    """Path of g++; raises when there is none."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native packer is "
                           "built with it at first use")
    return gxx


def library_path(gxx: str) -> pathlib.Path:
    """Where the library built from this source by ``gxx`` lies."""
    from gnnbuilder_tpu_torch.ops.cuda import _build

    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, timeout=GXX_TIMEOUT_S).stdout
    h = hashlib.sha256()
    for part in (gxx, version, " ".join(FLAGS)):
        h.update(part.encode())
    h.update(SRC.read_bytes())
    return _build.build_root() / "native" / h.hexdigest()[:16] / LIB_NAME


def build() -> pathlib.Path:
    """Compile ``packing.cpp`` unless its library exists; raise with the
    compiler's output if it fails.  Returns the library's path."""
    gxx = compiler()
    lib = library_path(gxx)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        proc = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True,
                              timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"native packer build failed: g++ exit "
                               f"{proc.returncode}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


if __name__ == "__main__":
    print(build())
