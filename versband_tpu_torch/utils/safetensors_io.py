"""``.safetensors`` files read and written with no package.

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``), then the tensors' bytes, little-endian, each at its offsets
from the end of the header.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, on the CPU."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise NotImplementedError(f"{path}: dtype {info['dtype']} of {name}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > len(buf):
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} for shape {shape} "
                             f"of {info['dtype']}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (moved to the CPU, made contiguous) to ``path``."""
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # the tensors start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)
