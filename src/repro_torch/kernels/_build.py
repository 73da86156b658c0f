"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface and compiles on its own,
with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC

into ``build/repro_torch/<name>-<hash>.so`` at the root of the checkout,
where the hash covers the source, the ``csrc/`` headers it includes (with
``#include "..."``, followed through the headers) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  ``build_all`` starts one ``nvcc``
per missing library, all at once, and waits for them; a failed build
raises with the compiler's output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each library built by this
# process, keyed by kernel name, and the wall seconds from the start of
# the parallel build to that library's compiler exit
build_logs: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are compiled "
        f"from {CSRC} at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str, csrc: Path = CSRC) -> list[Path]:
    """The source of kernel `name` and the headers under `csrc` it includes
    with ``#include "..."``, directly or through another header, in the
    order first reached."""
    todo, seen = [csrc / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [csrc / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes()) if (csrc / inc.decode()).is_file()]
    return seen


def library_path(name: str, csrc: Path = CSRC) -> Path:
    digest = hashlib.sha256()
    for path in sources(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every kernel library that is missing, in parallel.

    Returns the wall seconds spent (0.0 when everything was built)."""
    todo = [(n, library_path(n)) for n in kernel_names()
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all missing ones first."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
