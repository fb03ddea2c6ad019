"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. :func:`build`
compiles sources with ``nvcc`` for sm_90a into shared libraries under
``build/torch_kernels/``, each named by the hash of its source, the shared
headers in ``csrc/`` and the flags, so an edited source or header is rebuilt
and an unchanged one is reused; each compile's ``-Xptxas -v`` log is kept
beside its library (:func:`ptxas_report`). Several
sources compile in parallel, one ``nvcc`` process each. :func:`load` opens a
built library with ctypes and declares its functions.

Nothing here runs at import; a wrapper calls :func:`load` the first time a
CUDA tensor reaches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(source: Path) -> Path:
    """Where the shared library of ``source`` goes, named by the content of
    the source, of every header beside it (``*.cuh``, which a source may
    include) and of the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(*sources: Path, verbose: bool = False) -> list[Path]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` each); raise if any fails. Returns the libraries' paths in the
    order of ``sources``. With ``verbose``, print each compile's time and
    its ``-Xptxas -v`` report."""
    outs = [_library_path(s) for s in sources]
    jobs = []
    try:
        for src, out in zip(sources, outs):
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src, out, tmp, proc, time.time()))
        failed = []
        for src, out, tmp, proc, t0 in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{log}")
                continue
            if verbose:
                print(f"nvcc {src.name} {time.time() - t0:.1f}s\n{log}", end="")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def ptxas_report(source: Path) -> list[str]:
    """The register, spill and shared-memory lines of ``-Xptxas -v`` from
    the build of ``source`` (kept beside its library)."""
    log = _library_path(source).with_suffix(".log")
    keys = ("registers", "spill", "stack frame", "smem")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keys)]


def load(source: Path, functions: dict) -> ctypes.CDLL:
    """Build ``source`` if needed, open it and declare ``functions``:
    ``{name: (argtypes, restype)}``."""
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, (argtypes, restype) in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
