"""ctypes bindings to the port's native NIfTI decoder
(``vsr_tpu_torch/csrc_host/vsr_native.cpp``; port of ``vsr_tpu/io/native.py``).

``load_nifti_native`` decodes one file to float32 (the values, shape and
Fortran order ``io/nifti.load_nifti`` gives, as float32) and
``load_nifti_batch`` a list of files on a pool of native threads, outside
the interpreter lock. The datasets' ``native_decode: true`` reads through
it. The output array is sized from the file's header (its first 352
bytes, read in Python) and filled in place: no scratch buffer, no copy.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17
-ffp-contract=off ... -lz -lpthread`` at first use (``build()``), into
``vsr_tpu_torch/_build/`` (git-ignored) under a name keyed by the hash of
the source and flags, as the CUDA kernels are (``_build.py``). There is no
fallback: a failed build or a failed decode raises (the JAX package's
reader falls back to Python quietly).
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

import numpy as np

from vsr_tpu_torch._build import BUILD_DIR
from vsr_tpu_torch.io.nifti import _open_maybe_gz, _parse_header

SOURCE = Path(__file__).resolve().parent.parent / "csrc_host" / "vsr_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
LIBS = ("-lz", "-lpthread")

_ERRORS = {1: "open/read", 2: "gunzip", 3: "header or truncated data",
           4: "dtype", 5: "capacity"}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvsr_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder into :func:`library_path` (atomically: a
    concurrent process never loads a half-written file); raises with the
    compiler's output when it fails."""
    out = library_path()
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native NIfTI decoder of "
                           "vsr_tpu_torch cannot be built (native_decode)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", lib, *LIBS],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building the "
                               f"native NIfTI decoder:\n{proc.stdout}")
        os.replace(lib, out)
    return out


@functools.cache
def _load_lib() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    lib.vsr_decode_nifti.restype = ctypes.c_int
    lib.vsr_decode_nifti.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vsr_decode_batch.restype = ctypes.c_int
    lib.vsr_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    return lib


def available() -> bool:
    """True when the decoder builds (or is built) and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _float_ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _empty_for(path: str | Path) -> np.ndarray:
    """An uninitialized float32 array of the file's shape, in the file's
    (Fortran) order, as ``io/nifti.load_nifti`` returns it: the decoder
    writes the voxels into it as they lie in the file, with no copy after.
    Reads the 352 bytes of the header only."""
    return np.empty(_nifti_shape(Path(path)), dtype=np.float32, order="F")


def _nifti_shape(path: Path) -> tuple[int, ...]:
    try:
        with _open_maybe_gz(path, "rb") as f:
            raw = f.read(352)
    except OSError as err:
        raise IOError(f"native NIfTI decode failed (open/read: {err}): "
                      f"{path}") from err
    try:
        header, _, _ = _parse_header(raw)
    except ValueError as err:
        raise IOError(f"native NIfTI decode failed (header: {err}): "
                      f"{path}") from err
    return header.shape


def _check(err: int, path) -> None:
    if err:
        raise IOError(f"native NIfTI decode failed "
                      f"({_ERRORS.get(err, err)}): {path}")


def load_nifti_native(path: str | Path) -> np.ndarray:
    """Decode one NIfTI into a float32 array (the Python reader's values,
    shape and order)."""
    lib = _load_lib()
    out = _empty_for(path)
    shape = (ctypes.c_int64 * 7)()
    ndim = ctypes.c_int()
    _check(lib.vsr_decode_nifti(str(path).encode(), _float_ptr(out),
                                out.size, shape, ctypes.byref(ndim)), path)
    return out


def load_nifti_batch(paths: list[str | Path],
                     n_threads: int = 8) -> list[np.ndarray]:
    """Decode a batch of NIfTI files on ``n_threads`` native threads."""
    lib = _load_lib()
    n = len(paths)
    outs = [_empty_for(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(*map(_float_ptr, outs))
    c_caps = (ctypes.c_int64 * n)(*[o.size for o in outs])
    c_shapes = (ctypes.c_int64 * (n * 7))()
    c_ndims = (ctypes.c_int * n)()
    err = lib.vsr_decode_batch(c_paths, n, c_outs, c_caps, c_shapes, c_ndims,
                               n_threads)
    if err:  # decode each alone: the error names its file
        for p in paths:
            load_nifti_native(p)
        _check(err, [str(p) for p in paths])
    return outs
