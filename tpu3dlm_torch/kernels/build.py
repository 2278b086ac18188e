"""Build and load the port's CUDA kernels and its host C++ code.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

Host sources, ``csrc/host/<name>.cpp``, are compiled the same way by the
system C++ compiler, so they build on a host without CUDA: ``codecs.cpp``
(JPEG, PNG and the resizes), ``containers.cpp`` (the other image
containers' bit-level decoding), ``webp.cpp`` (WebP's VP8L and VP8
bitstreams), ``jpeg2000.cpp`` (JPEG 2000 codestreams), ``dbscan.cpp`` (the map stage's DBSCAN) and
``meshing.cpp`` (marching tetrahedra, the Poisson leakage cull and the
trilinear splat); the last two are copies of the JAX package's
``native/src/dbscan.cpp`` and ``poisson.cpp``:

    c++ -O3 -shared -fPIC -std=c++17 -o _build/host-<name>-<hash>.so \
        csrc/host/<name>.cpp

Libraries land in ``tpu3dlm_torch/_build/`` (git-ignored), keyed by a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source rebuilds and an unchanged one loads at once. ``build_all``
starts one compiler per source, all together, and waits for them. A missing
``nvcc`` or C++ compiler, or a failed build, raises: there is no fallback to
the plain PyTorch versions, to a Python decoder or to numpy meshing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
HOST_SRC = CSRC / "host"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> list[str]:
    """Names of every host C++ source in ``csrc/host/``."""
    return sorted(p.stem for p in HOST_SRC.glob("*.cpp"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("tpu3dlm_torch: nvcc not found; the CUDA kernels cannot be built")


def _cxx() -> str:
    found = shutil.which("c++")
    if found:
        return found
    raise RuntimeError("tpu3dlm_torch: no C++ compiler (c++) found; the host C++ sources cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to: keyed by the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes(), *(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def host_library_path(name: str) -> Path:
    """Where ``csrc/host/<name>.cpp`` is built to: keyed by the source and
    the flags."""
    src = (HOST_SRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"host-{name}-{digest}.so"


def _start(src: Path, out: Path, compiler: list[str]) -> tuple[subprocess.Popen, Path, Path] | None:
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(src: Path, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed for {src.relative_to(PKG)}:\n{log}")
    os.replace(tmp, out)


def build_all(names: list[str] | None = None, host: list[str] | None = None) -> dict[str, Path]:
    """Compile every listed kernel source and host source (default: all of
    ``csrc/`` and ``csrc/host/``) in parallel; returns the library path of
    each, host libraries under ``host/<name>``."""
    names = sources() if names is None else names
    host = host_sources() if host is None else host
    jobs = [(CSRC / f"{n}.cu", library_path(n), n, [_nvcc(), *NVCC_FLAGS]) for n in names]
    jobs += [(HOST_SRC / f"{n}.cpp", host_library_path(n), f"host/{n}", [_cxx(), *HOST_FLAGS])
             for n in host]
    started = [(src, _start(src, out, cc)) for src, out, _, cc in jobs]
    for src, st in started:
        _finish(src, st)
    return {key: out for _, out, key, _ in jobs}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name], host=[])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/host/<name>.cpp``, building it if needed."""
    key = f"host/{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_all([], host=[name])
            lib = ctypes.CDLL(str(host_library_path(name)))
            _libs[key] = lib
        return lib
