"""Minimal, dependency-free NIfTI-1 reader/writer.

A copy of ``vsr_tpu/io/nifti.py``: importing ``vsr_tpu`` pulls in its YAML
config module, and the port must import without ``yaml``.
``tests/test_torch_port_pipeline.py`` pins the two copies bit-equal.

It stands in for ``nibabel`` (``nib.load(...).get_data()`` /
``nib.save(nib.Nifti1Image(data, np.eye(4)), ...)``), which the project does
not depend on, by implementing the single-file NIfTI-1 format
(.nii / .nii.gz) directly:

- 348-byte header + 4-byte extension flag, voxel data at ``vox_offset``
  (352 for our files), magic ``n+1``.
- Data is stored x-fastest (Fortran order); arrays round-trip with the exact
  shape and values nibabel would produce.
- ``scl_slope``/``scl_inter`` scaling is applied on read when meaningful
  (slope not in {0, 1} or inter != 0), matching nibabel's ``get_data()``.

Only the subset of the spec exercised by this project is supported; unknown
datatypes raise.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_HEADER_SIZE = 348
_VOX_OFFSET = 352.0

# NIfTI-1 datatype codes.
_DTYPES: dict[int, np.dtype] = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
    1280: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


@dataclass
class NiftiHeader:
    shape: tuple[int, ...] = ()
    dtype: np.dtype = field(default_factory=lambda: np.dtype(np.float32))
    pixdim: tuple[float, ...] = ()
    scl_slope: float = 0.0
    scl_inter: float = 0.0
    affine: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


def _open_maybe_gz(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _parse_header(raw: bytes) -> tuple[NiftiHeader, str, float]:
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"Truncated NIfTI header ({len(raw)} bytes)")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != _HEADER_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HEADER_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"

    dim = struct.unpack_from(f"{endian}8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"Invalid ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])

    (datatype,) = struct.unpack_from(f"{endian}h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    dtype = _DTYPES[datatype].newbyteorder(endian)

    pixdim = struct.unpack_from(f"{endian}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{endian}f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(f"{endian}2f", raw, 112)

    srow = np.array(struct.unpack_from(f"{endian}12f", raw, 280), np.float32)
    affine = np.eye(4, dtype=np.float32)
    (sform_code,) = struct.unpack_from(f"{endian}h", raw, 254)
    if sform_code > 0:
        affine[:3, :] = srow.reshape(3, 4)

    magic = raw[344:348].split(b"\0")[0].decode("ascii", "replace")
    header = NiftiHeader(
        shape=shape,
        dtype=dtype,
        pixdim=tuple(float(p) for p in pixdim[1 : 1 + ndim]),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        affine=affine,
    )
    return header, magic, float(vox_offset)


def load_nifti(
    path: str | Path, with_header: bool = False
) -> np.ndarray | tuple[np.ndarray, NiftiHeader]:
    """Read a .nii/.nii.gz file into a numpy array (Fortran data order).

    Returns the array nibabel's ``get_data()`` would: raw on-disk dtype when no
    scaling is present, float32 scaled data otherwise.
    """
    path = Path(path)
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()
    header, magic, vox_offset = _parse_header(raw)
    if magic not in ("n+1", "ni1", "n+2"):
        raise ValueError(f"Unrecognized NIfTI magic {magic!r} in {path}")
    if magic == "ni1":
        raise ValueError(f"Two-file (.hdr/.img) NIfTI is not supported: {path}")

    count = int(np.prod(header.shape))
    offset = int(vox_offset) if vox_offset else int(_VOX_OFFSET)
    data = np.frombuffer(raw, dtype=header.dtype, count=count, offset=offset)
    data = data.reshape(header.shape, order="F")

    slope, inter = header.scl_slope, header.scl_inter
    # NIfTI-1 semantics (and nibabel's): scl_slope == 0 (or NaN) means NO
    # scaling at all — scl_inter is ignored, not applied with slope 1.
    has_slope = slope == slope and slope != 0.0
    if has_slope and (slope != 1.0 or (inter == inter and inter != 0.0)):
        inter = inter if inter == inter else 0.0
        data = data.astype(np.float32) * np.float32(slope) + np.float32(inter)
    else:
        # Return native-endian writable copy.
        data = np.asarray(data, dtype=header.dtype.newbyteorder("=")).copy(order="F")

    if with_header:
        return data, header
    return data


def save_nifti(
    data: np.ndarray,
    path: str | Path,
    affine: np.ndarray | None = None,
    pixdim: tuple[float, ...] | None = None,
) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz by extension)."""
    path = Path(path)
    data = np.asarray(data)
    if data.ndim < 1 or data.ndim > 7:
        raise ValueError(f"NIfTI supports 1..7 dims, got {data.ndim}")
    dtype = np.dtype(data.dtype).newbyteorder("=")
    if dtype not in _DTYPE_CODES:
        # Promote unsupported dtypes (e.g. float16, bool) to float32/uint8.
        dtype = np.dtype(np.uint8) if data.dtype == bool else np.dtype(np.float32)
        data = data.astype(dtype)
    datatype_code = _DTYPE_CODES[dtype]

    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    affine = np.asarray(affine, dtype=np.float32)

    header = bytearray(_HEADER_SIZE)
    struct.pack_into("<i", header, 0, _HEADER_SIZE)
    header[38] = ord("r")  # dim_info/regular, cosmetic

    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype_code)
    struct.pack_into("<h", header, 72, dtype.itemsize * 8)  # bitpix

    pd = [1.0] + list(pixdim or ()) + [1.0] * 7
    struct.pack_into("<8f", header, 76, *pd[:8])
    struct.pack_into("<f", header, 108, _VOX_OFFSET)
    struct.pack_into("<2f", header, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<2h", header, 252, 0, 2)  # qform_code=0, sform_code=2
    struct.pack_into("<12f", header, 280, *affine[:3, :].ravel().tolist())
    header[344:348] = b"n+1\0"

    payload = bytes(header) + b"\0\0\0\0" + np.asfortranarray(data).tobytes(order="F")
    path.parent.mkdir(parents=True, exist_ok=True)
    if str(path).endswith(".gz"):
        # mtime=0 => deterministic bytes for identical arrays.
        with open(path, "wb") as raw_f:
            with gzip.GzipFile(fileobj=raw_f, filename="", mode="wb", mtime=0) as f:
                f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
