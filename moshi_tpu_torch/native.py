"""The native streaming ogg-opus codec (`native/moshi_native.cpp`, the
sphn analog: `OpusStreamWriter` / `OpusStreamReader`) for the port's
server, built at first use.

The source is compiled with the command of `native/build.sh`,

    g++ -O2 -shared -fPIC -std=c++17 -I<python include> moshi_native.cpp -l:libopus.so.0

into `build/native/` at the repository root (listed in .gitignore), named
by a hash of the source, the command and the interpreter's extension
suffix, so later calls reuse it until the source changes; the module is
loaded from that path.  Nothing is built on import, and nothing is written
into the JAX package.
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "moshi_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-l:libopus.so.0",)

_module = None


def library_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    h.update(suffix.encode())
    return BUILD_DIR / f"moshi_native-{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the codec unless a build of the same source exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, f"-I{sysconfig.get_paths()['include']}", str(SOURCE), *LIBS,
           "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):  # a failed link removes its output itself
            os.unlink(tmp)
        raise RuntimeError(f"building the opus codec failed:\n{proc.stderr}")
    # compiled to a private name, then renamed: a concurrent loader never
    # sees a half-written library
    os.replace(tmp, path)
    return path


def load():
    """The codec's module (its PyInit is `moshi_native`), built on first
    use."""
    global _module
    if _module is None:
        spec = importlib.util.spec_from_file_location("moshi_native", build())
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _module = module
    return _module
