"""Build the hand-written CUDA kernels in `moshi_tpu_torch/csrc/` and load
them with ctypes.

Each kernel source `csrc/<name>.cu`, with the C entry point `<name>`, is
compiled by `nvcc` for sm_90a into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library lands in `build/kernels/` at the repository root (listed in
.gitignore), named by a hash of the sources and flags, so the first call
builds it and later calls, in this process or another, reuse it until a
source changes.  `build_all` starts one nvcc per source at once.  Nothing
is built on import: the CPU tests import every module of the port on a
machine with no `nvcc`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point (pointers and the stream as c_void_p:
# ctypes would otherwise pass a Python int as a 32-bit int)
SIGNATURES = {
    # x, q, scale, out, batch, din, dout, group_size, then the plan (cols,
    # warps, cluster, rows_per_block, seg_rows), x_is_bf16, stream
    "q4_gemv": [_P] * 4 + [_I] * 10 + [_P],
    # x, q, scale, out, partial, batch, din, dout, group_size,
    # groups_per_split, splits, stream
    "q4_mma": [_P] * 5 + [_I] * 6 + [_P],
    # the same as q4_mma
    "q4_wgmma": [_P] * 5 + [_I] * 6 + [_P],
    # x, q, scale, out, batch, din, dout, then the plan (cols, warps,
    # cluster, rows_per_block, seg_rows), x_is_bf16, stream
    "int8_gemv": [_P] * 4 + [_I] * 9 + [_P],
    # x, q, scale, out, batch, din, dout, rows_per_block, cluster, stream
    "int8_mma": [_P] * 4 + [_I] * 5 + [_P],
    # x, q, scale, out, partial, M, din, dout, then the plan (split_rows,
    # splits), stream
    "int8_wgmma": [_P] * 5 + [_I] * 5 + [_P],
    # q, k_all, v_all, k_scale, v_scale, mask, kk, vv, pos, acc, m, l, layer,
    # B, H, Hkv, D, cap, cap_pad, warps, kk_stride, vv_stride, stream
    "decode_attention_int4": [_P] * 12 + [_I] * 10 + [_P],
    # q, k_all, v_all, k_scale, v_scale, mask, out, layer, B, H, Hkv, D, cap,
    # per_split, splits, warps, stream
    "decode_attention_int8": [_P] * 7 + [_I] * 9 + [_P],
}

# more C entry points of a kernel's library: name -> (function, argtypes);
# each returns an int
EXTRA_ENTRIES = {
    # batch, cols, warps, cluster, seg_rows, x_is_bf16
    "q4_gemv": [("q4_gemv_resident", [_I] * 6)],
    "int8_gemv": [("int8_gemv_resident", [_I] * 6)],
}

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library for kernel `name` is (or will be) built."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None, extra_flags=()) -> dict[str, str]:
    """Compile csrc/<name>.cu for every name (all kernels by default) that
    has no library of the same sources yet, one nvcc process per source, all
    started together.  Returns nvcc's output per compiled name (with
    extra_flags=("-Xptxas", "-v"): registers, shared memory, spills)."""
    todo = [n for n in (names or SIGNATURES) if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for name in todo:
        # compile to a private name, then rename: concurrent builders never
        # see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same sources exists."""
    build_all([name])
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fname, argtypes in [(name, SIGNATURES[name]), *EXTRA_ENTRIES.get(name, [])]:
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
