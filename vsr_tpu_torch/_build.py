"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

Every ``csrc/*.cu`` is compiled into one shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes): one
``nvcc -c`` per source, all started together, then one link. The library
lands in ``_build/`` beside this file under a name keyed by the
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import: ``load()`` builds at
the first kernel launch. Pointer and stream arguments are ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# C entry points of csrc/ and their ctypes signatures (restype c_int: a
# cudaError_t, 0 on success).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # xs, channels, count, w, b, alpha, out, n, hw, f_out, dtype, stream
    "vsr_concat_conv1x1": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
                           _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xs, channels, count, g, partial, dw, db, n, hw, f_out, chunk, splits,
    # split_stride, dtype, stream
    "vsr_concat_dw": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _P, _P,
                      _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _I, _P],
    # x, logits, out, n, h, w, size, r, stream
    "vsr_duf_filter": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # af, out, rows, gs, stream
    "vsr_pairwise_rank": [_P, _P, ctypes.c_longlong, _I, _P],
    # x, x_kind, wq, ws, bias, xs, out, out_kind, dims[20], plan[7], stream
    "vsr_w8a8_conv": [_P, _I, _P, _P, _P, _P, _P, _I, ctypes.POINTER(_I),
                      ctypes.POINTER(_I), _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location; raises if none exists."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels of vsr_tpu_torch cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvsr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into :func:`library_path`: every source to its
    own object file in parallel, then one link (atomically: a concurrent
    process never loads a half-written file)."""
    out = library_path()
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objects)]
        logs = [proc.communicate()[0] for proc in procs]  # waits for each
        lib = os.path.join(tmp, "lib.so")
        failed = [(src.name, proc.returncode, log)
                  for src, proc, log in zip(sources(), procs, logs)
                  if proc.returncode]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode:
                failed = [("link", link.returncode, link.stdout)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built first if this source hash has none."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
