"""Build and load the port's CUDA kernels, and count their launches.

The kernels in ``viabel_torch/csrc/*.cu`` have a plain C interface and are
compiled by ``nvcc`` into one shared library for Hopper (``sm_90a``) on
first use, then loaded with ``ctypes``. The library's file name carries a
hash of the sources and flags, so an edit rebuilds. Nothing here runs at
import time: a machine without ``nvcc`` or a GPU imports the package and
uses the plain PyTorch versions on CPU tensors.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "launch_counts",
           "reset_launch_counts", "count_launch", "check"]

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
BUILD_DIR = _PACKAGE.parent / "build" / "viabel_torch"
#: where the CUDA toolkit installs nvcc by default, tried after CUDA_HOME and PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, element type) for every exported C function; all return cudaError_t
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "viabel_ring_group_stats_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    "viabel_ring_group_stats_f64": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    "viabel_stl_transpose_solve_f32": (_P, _P, _P, _I64, _I64, _P),
    "viabel_stl_transpose_solve_f64": (_P, _P, _P, _I64, _I64, _P),
    "viabel_tri_solve_f32": (_P, _P, _P) + (_I64,) * 6 + (ctypes.c_int, _P),
    "viabel_tri_solve_f64": (_P, _P, _P) + (_I64,) * 6 + (ctypes.c_int, _P),
}

_LAUNCHES = {"ring_group_stats": 0, "stl_transpose_solve": 0,
             "vmem_solve_triangular": 0}
_state = {"lib": None, "info": None}


def launch_counts():
    """Kernel launches per wrapper since the last reset (a copy)."""
    return dict(_LAUNCHES)


def reset_launch_counts():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name):
    """Called by a wrapper right after its kernel launched."""
    _LAUNCHES[name] += 1


def _find_nvcc():
    tried = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        tried.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    tried.append(on_path or "nvcc on PATH")
    tried.append(DEFAULT_NVCC)
    for path in tried:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found; tried: " + ", ".join(tried))


def _library_path():
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libviabel_kernels-{h.hexdigest()[:16]}.so"


def _build(out):
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"built": True, "seconds": seconds, "nvcc": nvcc,
            "log": proc.stdout + proc.stderr}


def load_library():
    """Build (if needed) and load the kernels' shared library, once per
    process. Raises if ``nvcc`` is missing or the build fails."""
    if _state["lib"] is None:
        out = _library_path()
        info = ({"built": False, "seconds": 0.0, "nvcc": None, "log": ""}
                if out.exists() else _build(out))
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        info["path"] = str(out)
        _state["info"] = info
        _state["lib"] = lib
    return _state["lib"]


def build_info():
    """What :func:`load_library` did: ``built``, ``seconds``, ``nvcc``,
    the compiler's ``log`` and the library ``path`` (None before a load)."""
    return _state["info"]


def check(err, name):
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
