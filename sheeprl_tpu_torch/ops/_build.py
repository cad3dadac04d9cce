"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is compiled
with ``nvcc`` into a shared library the first time a wrapper needs it, into
``build/torch_kernels/`` at the root of the checkout (listed in ``.gitignore``),
and loaded with ``ctypes``. The library's name carries a digest of its source,
so an edited source is rebuilt and a built one is reused. Nothing here runs at
import time: the CPU tests import every module of the package.

:func:`build_snapshot` counts this process's ``nvcc`` builds and library loads
and their seconds: the port's counterpart of the JAX package's XLA compile
count (``obs/compile_monitor.py``), which the serving telemetry reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc builds and library loads of this process, and their seconds
_lock_events = threading.Lock()
_events = {"builds": 0, "loads": 0, "seconds": 0.0}
# launch counts: the decoupled topology's player and learner threads both launch
_lock_launches = threading.Lock()


@dataclass
class KernelSpec:
    """One hand-written kernel of the port: where its source lives, which TPU
    kernel it replaces, and how often the main path launched it (``launches``
    is bumped by the wrapper at each launch and nowhere else, and
    ``launches_by_dtype`` beside it by the operands' dtype)."""

    name: str
    source: str  # file name under csrc/
    replaces: str  # file:line of the Pallas kernel in the JAX package
    route: str = "cuda"
    launches: int = 0
    launches_by_dtype: Dict[str, int] = field(default_factory=dict)

    def count_launch(self, dtype: str) -> None:
        with _lock_launches:
            self.launches += 1
            self.launches_by_dtype[dtype] = self.launches_by_dtype.get(dtype, 0) + 1

    def zero_launches(self) -> None:
        with _lock_launches:
            self.launches = 0
            self.launches_by_dtype.clear()

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source


def find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def library_path(spec: KernelSpec) -> Path:
    digest = hashlib.sha256(spec.source_path.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{spec.source_path.stem}_{digest.hexdigest()[:16]}.so"


def _nvcc_command(spec: KernelSpec, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(spec.source_path)]


def build(specs: Sequence[KernelSpec]) -> Dict[str, Path]:
    """Compile every spec whose library is missing, one ``nvcc`` per source, all
    started together. Returns name -> library path. Raises with the compiler's
    output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths = {spec.name: library_path(spec) for spec in specs}
    running = []
    for spec in specs:
        out = paths[spec.name]
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            _nvcc_command(spec, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((spec, proc, tmp, out))
    failures = []
    for spec, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{spec.source}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a torn file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    if running:
        with _lock_events:
            _events["builds"] += len(running)
            _events["seconds"] += time.perf_counter() - t0
    return paths


def load(spec: KernelSpec) -> ctypes.CDLL:
    """The spec's library, built on first use and cached for the process."""
    with _lock:
        lib = _loaded.get(spec.name)
        if lib is None:
            path = build([spec])[spec.name]
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            _loaded[spec.name] = lib
            with _lock_events:
                _events["loads"] += 1
                _events["seconds"] += time.perf_counter() - t0
        return lib


def build_snapshot() -> Dict[str, float]:
    """``{count, seconds, builds, loads}``: the kernel libraries this process
    built with ``nvcc`` or loaded, and the seconds they took."""
    with _lock_events:
        return {"count": _events["builds"] + _events["loads"], **_events}
