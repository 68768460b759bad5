"""The native (C++) mel batch loader, loaded with ``ctypes`` (port of
``versband_tpu/native/__init__.py``, with the package's own copy of
``batch_loader.cpp``).

``load_mel_batch`` assembles one padded ``[B, C, T]`` float32 batch from
``.npy`` mel files, mmapped and copied by a C++ thread pool outside the
interpreter lock. It is host code, not a kernel of the card.

``ensure_built`` compiles the source with ``g++`` at first use into
``build/versband_tpu_torch/native/<hash>/libvbloader.so`` beside the package
(the hash covers the source and the flags), writing a temporary file and
renaming it into place, so concurrent builds (loader threads, worker
processes) never see a torn library. A missing ``g++`` or a failed build
raises: nothing falls back quietly. ``load_mel_batch_numpy`` is the plain
version of the same contract, which the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "batch_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "versband_tpu_torch" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvbloader.so"


def ensure_built() -> ctypes.CDLL:
    """The loaded library, compiled first where it is not built yet."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = library_path()
        if not lib_path.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on PATH; the native mel loader cannot be built")
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"libvbloader.{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(lib_path))
        lib.vb_load_mel_batch.restype = ctypes.c_int
        lib.vb_load_mel_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_long), ctypes.c_int]
        _LIB = lib
        return lib


def load_mel_batch_numpy(paths: Sequence[str], channels: int, t_target: int,
                         pad_value: float = -5.0, starts: Optional[Sequence[int]] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`load_mel_batch`, in numpy."""
    out = np.full((len(paths), channels, t_target), pad_value, np.float32)
    lengths = np.full(len(paths), -1, np.int64)
    for i, p in enumerate(paths):
        try:
            arr = np.load(p, mmap_mode="r")
        except Exception:  # an unreadable file is marked, as the library marks it
            continue
        s = int(starts[i]) if starts is not None else 0
        s = max(0, min(s, arr.shape[1]))
        valid = min(arr.shape[1] - s, t_target)
        out[i, :, :valid] = arr[:channels, s: s + valid]
        lengths[i] = valid
    return out, lengths


def load_mel_batch(paths: Sequence[str], channels: int, t_target: int, pad_value: float = -5.0,
                   starts: Optional[Sequence[int]] = None,
                   num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Load B mel ``.npy`` files (float32 ``[C_i, T_i]``) into one
    ``[B, channels, t_target]`` float32 batch, item i read from frame
    ``starts[i]`` (0 by default) and padded with ``pad_value``. Returns
    (batch, lengths): ``lengths[i]`` is the number of frames read, -1 for a
    missing or unreadable file (its row all ``pad_value``)."""
    lib = ensure_built()
    n = len(paths)
    out = np.empty((n, channels, t_target), np.float32)
    lengths = np.empty(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    starts_arr = np.ascontiguousarray(starts if starts is not None else np.zeros(n), np.int64)
    lib.vb_load_mel_batch(c_paths, n, starts_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                          channels, t_target, pad_value,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), num_threads)
    return out, lengths
