"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled at first use into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), one
``nvcc`` per source, all started together. Libraries go to
``build/versband_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "versband_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def start(sources: Dict[str, Path], out_dir: Path, include: Path = CSRC) -> list:
    """Start one ``nvcc`` per source (name -> ``.cu``), all together, each
    into ``out_dir/lib<name>.so`` with ``include`` on the header path; hand
    the returned jobs to :func:`finish`."""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in sources.items():
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(include), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out_dir, tmp, proc))
    return jobs


def finish(jobs: list) -> Dict[str, Tuple[Path, str]]:
    """Wait for the jobs of :func:`start`; return name -> (library, compiler
    output). Each output (``-Xptxas -v``: registers, shared memory, spills)
    is also kept beside its library as ``lib<name>.log``. Raises, naming
    every source that failed, if any did."""
    built, failed = {}, []
    for name, src, out_dir, tmp, proc in jobs:
        log, _ = proc.communicate()
        (out_dir / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            lib = out_dir / f"lib{name}.so"
            os.replace(tmp, lib)  # atomic: concurrent builders agree
            built[name] = (lib, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return built


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet; return name -> library."""
    out_dir = build_dir()
    srcs = {s.stem: s for s in sorted(CSRC.glob("*.cu"))}
    libs = {name: out_dir / f"lib{name}.so" for name in srcs}
    todo = {name: src for name, src in srcs.items() if not libs[name].exists()}
    if todo:
        finish(start(todo, out_dir))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        libs = build_all()
        if name not in libs:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(libs[name]))
    return _LIBS[name]
