"""Mel spectrograms as PNG images, with no plotting package.

:func:`mel_to_rgb` maps a mel ``[bins, frames]`` through matplotlib's
``magma`` colormap (a copy of its 256-entry table, as 8-bit RGB) between
``vmin`` and ``vmax``, one pixel per frame and bin, the lowest bin at the
bottom; :func:`write_png` writes 8-bit RGB with the standard library
(``zlib``, ``struct``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# matplotlib.cm.magma(range(256), bytes=True)[:, :3], row-major RGB
_MAGMA_HEX = (
    "00000300000400000601000701010901010b02020d02020f03031104031304041505041706051907051b0806"
    "1d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31120d33140d35150e38160e3a170f3c18"
    "0f3f1a10411b10441c10461e10491f114b20114d2211502311522511552611572811592a115c2b115e2d1060"
    "2f1062301065321067341068350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f"
    "774810784a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e5d177e5e"
    "177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e816f1e81711f81731f81742081"
    "7621817721817922817a22817c23817e24817f24818125818225818426818526818727818928818a28818c29"
    "808d29808f2a80912a80922b80942b80952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4"
    "307da6317da7317da9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070d0416fd1426ed342"
    "6dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66e14c66e24d65e44e64e55063e65162e7"
    "5262e85461ea5560eb5660ec585fed595fee5b5eee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb84"
    "60fb8660fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6bfd9f6cfd"
    "a16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37bfeb57cfeb77dfeb97ffebb80"
    "febc82febe83fec085fec286fec488fec689fec78bfec98dfecb8efdcd90fdcf92fdd193fdd295fdd497fdd6"
    "98fdd89afdda9cfddc9dfddd9ffddfa1fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fc"
    "f1b3fcf3b5fcf5b7fbf7b9fbf9bbfbfabdfbfcbf"
)
MAGMA = np.frombuffer(bytes.fromhex(_MAGMA_HEX), np.uint8).reshape(256, 3)


def mel_to_rgb(mel: np.ndarray, vmin: float = -5.0, vmax: float = 1.5) -> np.ndarray:
    """``[bins, frames]`` -> ``[bins, frames, 3]`` uint8, the highest bin in row
    0: magma of ``(mel - vmin) / (vmax - vmin)`` clipped to [0, 1], indexed as
    matplotlib indexes a 256-entry colormap (``floor(x * 256)``, 1.0 to the
    last entry); NaN is black."""
    x = np.clip((np.asarray(mel, np.float64) - vmin) / (vmax - vmin), 0.0, 1.0)
    bad = np.isnan(x)
    idx = np.minimum((np.where(bad, 0.0, x) * 256).astype(np.int64), 255)
    rgb = MAGMA[idx]
    rgb[bad] = 0
    return np.ascontiguousarray(rgb[::-1])


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """8-bit RGB PNG of ``rgb`` ``[height, width, 3]`` uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))

