"""Build the CUDA sources in ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), under a name that carries a hash of the source
and the flags, so an edited source rebuilds.  The library is loaded with
:mod:`ctypes`.  Nothing is built when this module is imported.

No source links the driver library: ``flash_attention.cu`` and
``rwkv6_scan.cu`` encode their TMA tensor maps with
``cuTensorMapEncodeTiled``, which they find at run time through the CUDA
runtime's driver entry point.  No source includes CUTLASS.  Each build
keeps nvcc's ptxas report (``-Xptxas -v``) beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ctypes signature of each source's C entry point: (symbol, argtypes, restype)
SIGNATURES: Dict[str, Tuple[str, tuple, type]] = {
    "delta_snapshot": (
        "delta_snapshot_mask",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p),
        ctypes.c_int,
    ),
    "flash_attention": (
        "flash_attention_fwd",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int,
    ),
    "rwkv6_scan": (
        "rwkv6_scan_fwd",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int,
    ),
    "rglru_scan": (
        "rglru_scan_fwd",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int,
    ),
}

_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) of each library built, by this process
#: or (read back from the ``.log`` beside the library) by an earlier one
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once; returns each library's path."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    for n, t in targets.items():
        log = t.with_suffix(".log")
        if n not in todo and n not in BUILD_LOGS and log.exists():
            BUILD_LOGS[n] = log.read_text()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            else:
                todo[n].with_suffix(".log").write_text(out)
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        symbol, argtypes, restype = SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _LOADED[name] = lib
    return lib
