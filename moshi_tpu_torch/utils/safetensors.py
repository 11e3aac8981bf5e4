"""The safetensors file format, read and written without the `safetensors`
package (counterpart of moshi_tpu/models/loaders.py `load_safetensors` and
of `safetensors.flax.save_file`).

A file is an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, padded with spaces to a multiple of 8), then the tensors' raw
bytes, each at its offsets from the end of the header.  numpy has no
bfloat16: BF16 goes through an int16 view, as utils/params.py does.

Reading maps the file (`numpy.memmap`, copy-on-write) and makes each tensor
a view of the map, so a checkpoint of several GB is not read into host
memory twice; with a device, each tensor is copied there from the map.
`dumps` / `loads` do the same with the file's bytes in memory (session
snapshots on the wire, serve/snapshots.py).
"""

import json
import struct
from pathlib import Path

import numpy as np
import torch

# safetensors dtype -> (torch dtype, numpy dtype the bytes are read as)
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.int16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "U16": (torch.uint16, np.uint16),
    "BOOL": (torch.bool, np.bool_),
    "I32": (torch.int32, np.int32),
    "I64": (torch.int64, np.int64),
}
_NAMES = {torch_dtype: name for name, (torch_dtype, _) in DTYPES.items()}


def load_file(path: str | Path, device=None) -> dict[str, torch.Tensor]:
    """Every tensor of the file, by name: views of the mapped file, or
    copies on `device` when one is given."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = max((info["data_offsets"][1] for info in header.values()), default=0)
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n, shape=(size,))
            if size else np.zeros(0, np.uint8))
    return _tensors(header, data, path, device)


def loads(blob: bytes, device=None) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file held in memory, by name (copies)."""
    (n,) = struct.unpack_from("<Q", blob, 0)
    header = json.loads(blob[8:8 + n])
    header.pop("__metadata__", None)
    data = np.frombuffer(blob, np.uint8, offset=8 + n).copy()
    return _tensors(header, data, "<bytes>", device)


def _tensors(header: dict, data: np.ndarray, where, device) -> dict[str, torch.Tensor]:
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{where}: {name} has dtype {info['dtype']}, which is not "
                             f"one of {sorted(DTYPES)}")
        torch_dtype, np_dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = data[begin:end].view(np_dtype)
        if begin % arr.itemsize:
            arr = arr.copy()  # an unaligned tensor: torch needs aligned storage
        t = torch.from_numpy(arr.reshape(info["shape"])).view(torch_dtype)
        out[name] = t if device is None else t.to(device)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> int:
    """Write the tensors (on any device) to `path`, the widest dtypes first
    so that every tensor's offset is a multiple of its item size.  Returns
    the bytes written."""
    head, names = _header(tensors, metadata)
    with open(path, "wb") as f:
        f.write(head)
        for name in names:
            f.write(_raw(tensors[name]))
    return len(head) + sum(t.numel() * t.element_size() for t in tensors.values())


def dumps(tensors: dict[str, torch.Tensor], metadata: dict[str, str] | None = None) -> bytes:
    """The bytes `save_file` would write."""
    return b"".join(dump_chunks(tensors, metadata)[0])


def dump_chunks(tensors: dict[str, torch.Tensor],
                metadata: dict[str, str] | None = None) -> tuple[list, int]:
    """The bytes `save_file` would write, as the header and one buffer per
    tensor (views of host tensors, not copies), and their total length:
    a body to stream without joining it first."""
    head, names = _header(tensors, metadata)
    chunks = [head] + [_raw(tensors[name]) for name in names]
    return chunks, sum(len(c) for c in chunks)


def _header(tensors: dict, metadata: dict | None) -> tuple[bytes, list]:
    """The length-prefixed JSON header and the order of the tensors."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    return struct.pack("<Q", len(blob)) + blob, names


def _raw(t: torch.Tensor):
    return t.detach().contiguous().reshape(-1).cpu().view(torch.uint8).numpy().data
