"""Read and write ``.safetensors`` files with numpy alone.

The format: an 8-byte little-endian header length, then a JSON header that
maps each tensor's name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the byte buffer after the header; an optional
``__metadata__`` entry maps strings to strings), then the raw little-endian
bytes of the tensors. F32, F16, BF16 and I64 are read and written; BF16 has
no numpy type, so it is read as its 16 bits and widened to float32.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np

_NUMPY = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "I64": np.dtype("<i8"), "BF16": np.dtype("<u2")}
_CODES = {np.dtype("float32"): "F32", np.dtype("float16"): "F16", np.dtype("int64"): "I64"}


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file as a numpy array (BF16 as float32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in _NUMPY:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}; this reader takes {sorted(_NUMPY)}")
        begin, end = info["data_offsets"]
        a = np.frombuffer(data[begin:end], dtype=_NUMPY[code]).reshape(info["shape"])
        out[name] = _bf16_to_f32(a) if code == "BF16" else a.astype(a.dtype.newbyteorder("="))
    return out


def save_file(tensors: Mapping[str, np.ndarray], path: str, metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (float32, float16 or int64 arrays) in name order,
    each aligned to 8 bytes as the reference writer aligns them."""
    header, chunks, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        if a.dtype not in _CODES:
            raise ValueError(f"tensor {name!r} has dtype {a.dtype}; this writer takes {sorted(map(str, _CODES))}")
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": _CODES[a.dtype], "shape": list(a.shape), "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
