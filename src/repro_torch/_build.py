"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface.  It is compiled
at first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/`` at the repository root, under a
name that carries the hash of the source, so an edited source is rebuilt and
an unchanged one is loaded as it is.  The library is loaded with ``ctypes``.
Only sources in the repository are built.

    python -m repro_torch._build        # build every kernel, print the times
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> (source, {C function: (argtypes, restype)})
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "flash_attention_fwd": (
        PKG / "kernels" / "flash_attention" / "csrc" / "flash_attention_fwd.cu",
        {
            # q, k, v, o, dtype, B, Sq, Skv, H, group, hd, causal, window,
            # sq_valid, skv_valid, stream
            "flash_attention_fwd": ([_P, _P, _P, _P] + [_I] * 11 + [_P], _I),
            "flash_attention_error_string": ([_I], ctypes.c_char_p),
        },
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    src = KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    (process or None, temporary output, final output)."""
    out = lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=None) -> dict:
    """Build the named kernels (all by default), one ``nvcc`` per source, all
    started together.  Returns {name: compiler log ('' when cached)}; raises
    if a build fails."""
    names = list(KERNELS) if names is None else list(names)
    started = {n: _start(n) for n in names}
    logs = {}
    for n, (proc, tmp, out) in started.items():
        if proc is None:
            logs[n] = ""
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        out.with_suffix(".log").write_text(log)
        logs[n] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    for fn, (argtypes, restype) in KERNELS[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib


if __name__ == "__main__":
    t0 = time.perf_counter()
    for n, log in build().items():
        print(f"[build] {n}: {lib_path(n).name}")
        if log:
            print(log)
    print(f"[build] {time.perf_counter() - t0:.1f}s")
