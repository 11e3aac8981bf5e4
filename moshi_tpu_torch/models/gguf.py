"""gguf checkpoint reader/writer (v2/v3; f32, f16, bf16, q8_0 tensors); a
copy of moshi_tpu/models/gguf.py, which needs numpy only.

Kyutai publishes its rust-ecosystem quantized checkpoints as q8 gguf files
(`rust/moshi-core/src/lm.rs:1009-1031` loads them via
`gguf_file::Content::read`; `nn.rs` `MaybeQuantizedVarBuilder` consumes the
quantized tensors).  Tensor names in those files are the same torch-export
names the safetensors checkpoints use, so `read_gguf` -> name-keyed arrays
feeds the existing `lm_params_from_torch_state` remapping unchanged;
`get_moshi_lm`/`get_mimi` accept a `.gguf` path (and `CheckpointInfo` a
`.gguf` moshi_name) transparently.

Format (little endian): magic "GGUF", version u32, tensor_count u64,
metadata_kv_count u64; metadata k/v pairs (string key, type u32, value);
tensor infos (string name, n_dims u32, dims u64[n] innermost-first, ggml
type u32, data offset u64); data section aligned to `general.alignment`
(default 32).  q8_0 blocks: 32 values as (f16 scale + 32x int8), laid along
the innermost dimension.
"""

import struct
from pathlib import Path

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF"

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = \
    range(13)

# ggml tensor types (ggml.h)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_BF16 = 30

_Q8_0_BLOCK = 32


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f, vtype: int):
    scalars = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _BOOL: "<?", _U64: "<Q", _I64: "<q",
               _F64: "<d"}
    if vtype in scalars:
        fmt = scalars[vtype]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == _STR:
        return _read_str(f)
    if vtype == _ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


def _dequant_q8_0(raw: bytes, n: int) -> np.ndarray:
    nb = n // _Q8_0_BLOCK
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"),
                                             ("qs", "i1", (_Q8_0_BLOCK,))]),
                        count=nb)
    out = rec["qs"].astype(np.float32) * rec["d"].astype(np.float32)[:, None]
    return out.reshape(n)


def read_gguf(path: str | Path, dequantize: bool = True):
    """Returns (metadata dict, {name: np.ndarray}).  Quantized tensors are
    dequantized to f32 (dequantize=True) — the TPU serving path re-quantizes
    with `utils.quantize.quantize_lm_params`, whose int8 QTensors feed the
    MXU natively (a straight port of ggml block layouts would not)."""
    path = Path(path)
    meta: dict = {}
    infos = []
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a gguf file")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported gguf version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)
        for _ in range(n_tensors):
            name = _read_str(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            ttype, offset = struct.unpack("<IQ", f.read(12))
            infos.append((name, dims, ttype, offset))
        align = int(meta.get("general.alignment", 32))
        base = (f.tell() + align - 1) // align * align

        tensors = {}
        for name, dims, ttype, offset in infos:
            # gguf dims are innermost-first; numpy shape is the reverse
            shape = tuple(reversed(dims))
            n = int(np.prod(shape)) if shape else 1
            f.seek(base + offset)
            if ttype == GGML_F32:
                arr = np.frombuffer(f.read(4 * n), np.float32, n)
            elif ttype == GGML_F16:
                arr = np.frombuffer(f.read(2 * n), np.float16, n)
                arr = arr.astype(np.float32)
            elif ttype == GGML_BF16:
                raw = np.frombuffer(f.read(2 * n), np.uint16, n)
                arr = (raw.astype(np.uint32) << 16).view(np.float32).copy()
            elif ttype == GGML_Q8_0:
                assert n % _Q8_0_BLOCK == 0, (name, shape)
                nb = n // _Q8_0_BLOCK
                arr = _dequant_q8_0(f.read(nb * (2 + _Q8_0_BLOCK)), n)
            else:
                raise ValueError(f"{name}: unsupported ggml type {ttype}")
            tensors[name] = np.array(arr).reshape(shape)
    return meta, tensors


def _write_str(f, s: str):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _quant_q8_0(x: np.ndarray) -> bytes:
    flat = x.reshape(-1).astype(np.float32)
    nb = flat.size // _Q8_0_BLOCK
    blocks = flat.reshape(nb, _Q8_0_BLOCK)
    amax = np.abs(blocks).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    df[df == 0] = 1.0
    qs = np.clip(np.round(blocks / df[:, None]), -127, 127).astype(np.int8)
    rec = np.zeros(nb, dtype=np.dtype([("d", "<f2"),
                                       ("qs", "i1", (_Q8_0_BLOCK,))]))
    rec["d"] = d
    rec["qs"] = qs
    return rec.tobytes()


def write_gguf(path: str | Path, tensors: dict, metadata: dict | None = None,
               quantize: set | None = None, align: int = 32):
    """Write a gguf v3 file.  `tensors`: {name: np.ndarray (f32)};
    names in `quantize` are stored as q8_0 (innermost dim must be a
    multiple of 32), the rest as f32.  Inverse of `read_gguf` — also the
    export path for rust-ecosystem consumers."""
    metadata = dict(metadata or {})
    metadata.setdefault("general.alignment", align)
    quantize = quantize or set()

    def meta_entry(f, key, val):
        _write_str(f, key)
        if isinstance(val, bool):
            f.write(struct.pack("<I", _BOOL) + struct.pack("<?", val))
        elif isinstance(val, int):
            f.write(struct.pack("<I", _U32) + struct.pack("<I", val))
        elif isinstance(val, float):
            f.write(struct.pack("<I", _F32) + struct.pack("<f", val))
        elif isinstance(val, str):
            f.write(struct.pack("<I", _STR))
            _write_str(f, val)
        else:
            raise ValueError(f"unsupported metadata value for {key}: {val!r}")

    payloads = []
    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGUF_MAGIC, 3))
        f.write(struct.pack("<QQ", len(tensors), len(metadata)))
        for k, v in metadata.items():
            meta_entry(f, k, v)
        offset = 0
        for name, x in tensors.items():
            x = np.asarray(x)
            _write_str(f, name)
            dims = tuple(reversed(x.shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            if name in quantize:
                assert x.shape[-1] % _Q8_0_BLOCK == 0, (name, x.shape)
                data = _quant_q8_0(x)
                ttype = GGML_Q8_0
            else:
                data = np.ascontiguousarray(x, np.float32).tobytes()
                ttype = GGML_F32
            f.write(struct.pack("<IQ", ttype, offset))
            payloads.append(data)
            offset += (len(data) + align - 1) // align * align
        pos = f.tell()
        f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
        for data in payloads:
            f.write(data)
            pad = (len(data) + align - 1) // align * align - len(data)
            f.write(b"\x00" * pad)
