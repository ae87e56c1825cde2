"""Build the port's CUDA sources at first use.

Each `src/repro_torch/csrc/<name>.cu` is compiled by `nvcc` into its own
shared library with a plain C interface, loaded with `ctypes`. The
libraries go to `build/repro_torch_kernels/<hash>/` under the checkout;
the directory name is a hash of every file under `csrc/` (the `.cu`
sources and the headers they share) and of the flags, so an unchanged
tree reuses its build and an edit anywhere, a header included,
rebuilds. All sources
compile in parallel, one `nvcc` each. Nothing builds at import time: the
first CUDA call does, so the package imports on hosts without CUDA.

`--fmad=false` keeps nvcc from contracting a*b+c into one rounding: the
kernels must repeat the plain PyTorch versions' arithmetic bit for bit,
and eager PyTorch never fuses across operations.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}   # seconds, directory, ptxas reports


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _tree_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not built yet (in parallel) and return the
    build directory. Raises RuntimeError with nvcc's output on failure."""
    out_dir = BUILD_ROOT / _tree_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out_dir / f"{s.stem}.so").exists()]
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"{src.stem}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        reports[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    if todo:
        build_info.update(seconds=time.perf_counter() - t0,
                          directory=str(out_dir), ptxas=reports)
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all() / f"{name}.so"))
        return lib
