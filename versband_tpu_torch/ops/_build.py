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
from typing import Dict

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


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet; return name -> library.

    Each library's compiler output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside it as ``lib<name>.log``.
    """
    out_dir = build_dir()
    srcs = sorted(CSRC.glob("*.cu"))
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in srcs}
    todo = [s for s in srcs if not libs[s.stem].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, proc))
    failed = []
    for src, tmp, proc in jobs:
        log, _ = proc.communicate()
        (out_dir / f"lib{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[src.stem])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        libs = build_all()
        if name not in libs:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(libs[name]))
    return _LIBS[name]
