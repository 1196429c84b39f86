"""Build the port's CUDA kernels with ``nvcc`` and bind them through ctypes.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, from the sources in
the checkout only.  The library lands in ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source is never served by a stale build.  The sources
compile in parallel, one ``nvcc`` each, then link.  A failed compile
raises with the compiler's output.

Nothing here runs on import: the CPU tests import every module, and only
a CUDA tensor reaches the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see the sources)
SIGNATURES = {
    "adaln_norm_f32": [_P, _P, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P,
                       _LL, _I, _I, _F, _P],
    "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None
# what the last build of this process did: seconds and compiler output
last_build = {"seconds": 0.0, "log": "", "path": ""}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on the
    path, then the toolkit's default install."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists."""
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    cc = nvcc()
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [cc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = work / out.name
    link = subprocess.run([cc, *ARCH, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {out.name}:\n{link.stdout}")
    os.replace(tmp, out)                   # atomic: a reader sees all or none
    shutil.rmtree(work, ignore_errors=True)
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    last_build.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
