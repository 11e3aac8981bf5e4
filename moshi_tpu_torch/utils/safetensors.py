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
    start = 8 + n
    size = max((info["data_offsets"][1] for info in header.values()), default=0)
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start, shape=(size,))
            if size else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not "
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
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().reshape(-1)
            f.write(t.cpu().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
