"""Minimal DICOM reader + DSB15 DICOM->NIfTI conversion (port of
``vsr_tpu/io/dicom.py``, the JAX package's own reader).

The reference shells out to the external ``dcm2niix`` binary per short-axis
series. Neither dcm2niix nor pydicom is a dependency, so the port carries
the JAX package's reader for the subset of DICOM the DSB15 data uses:
single-frame, uncompressed (Implicit/Explicit VR Little Endian) grayscale
images, with the rescale slope and intercept applied. Frames of a series
are sorted by (InstanceNumber, TriggerTime), frames off the series'
majority shape are dropped, and the rest are stacked into the same
``(H, W, 1, T)`` NIfTI layout dcm2niix produces for these series.

Unsupported transfer syntaxes (compressed pixel data) raise with their UID.

Usage: ``python -m vsr_tpu_torch.io.dicom <dsb15_dir> <output_dir>``
"""

from __future__ import annotations

import argparse
import logging
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from vsr_tpu_torch.io.nifti import save_nifti

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}
_UNCOMPRESSED_SYNTAXES = {
    "1.2.840.10008.1.2",        # Implicit VR LE
    "1.2.840.10008.1.2.1",      # Explicit VR LE
}


@dataclass
class DicomImage:
    rows: int = 0
    cols: int = 0
    bits_allocated: int = 16
    pixel_representation: int = 0
    instance_number: int = 0
    trigger_time: float = 0.0
    slice_location: float = 0.0
    series_number: int = 0
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    pixel_spacing: tuple[float, float] = (1.0, 1.0)
    pixel_data: bytes = b""
    extra: dict = field(default_factory=dict)

    def array(self) -> np.ndarray:
        if self.bits_allocated == 16:
            dtype = np.int16 if self.pixel_representation else np.uint16
        elif self.bits_allocated == 8:
            dtype = np.int8 if self.pixel_representation else np.uint8
        else:
            raise ValueError(f"Unsupported BitsAllocated {self.bits_allocated}")
        arr = np.frombuffer(self.pixel_data, dtype=dtype, count=self.rows * self.cols)
        arr = arr.reshape(self.rows, self.cols)
        if self.rescale_slope != 1.0 or self.rescale_intercept != 0.0:
            arr = arr.astype(np.float32) * self.rescale_slope + self.rescale_intercept
        return arr


def _read_elements(buf: bytes, start: int, explicit: bool, stop_before_pixels: bool):
    """Generator of (group, elem, value_bytes) over a data-element stream."""
    pos = start
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit:
            vr = buf[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            vr = b"--"

        if length == 0xFFFFFFFF:
            # Undefined length (sequence): scan for SequenceDelimitationItem.
            end = buf.find(b"\xfe\xff\xdd\xe0", pos)
            if end < 0:
                return
            yield group, elem, None
            pos = end + 8
            continue

        value = buf[pos : pos + length]
        yield group, elem, value
        pos += length
        if stop_before_pixels and (group, elem) == (0x7FE0, 0x0010):
            return


def read_dicom(path: str | Path) -> DicomImage:
    with open(path, "rb") as f:
        buf = f.read()

    pos = 0
    explicit = True
    transfer_syntax = "1.2.840.10008.1.2.1"
    if len(buf) > 132 and buf[128:132] == b"DICM":
        # File meta group (always explicit VR LE): walk it to find the
        # TransferSyntaxUID and the dataset start.
        cursor = 132
        while cursor + 8 <= len(buf):
            group, elem = struct.unpack_from("<HH", buf, cursor)
            if group != 0x0002:
                break
            vr = buf[cursor + 4 : cursor + 6]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, cursor + 8)
                value_at = cursor + 12
            else:
                (length,) = struct.unpack_from("<H", buf, cursor + 6)
                value_at = cursor + 8
            if elem == 0x0010:
                transfer_syntax = (
                    buf[value_at : value_at + length]
                    .rstrip(b"\0 ")
                    .decode("ascii", "replace")
                )
            cursor = value_at + length
        pos = cursor
        if transfer_syntax not in _UNCOMPRESSED_SYNTAXES:
            raise ValueError(
                f"Unsupported (compressed?) transfer syntax {transfer_syntax} in {path}"
            )
        explicit = transfer_syntax != "1.2.840.10008.1.2"
    else:
        # Raw dataset without preamble: guess explicitness from first VR.
        vr = buf[4:6]
        explicit = vr.isalpha() and vr.isupper()

    img = DicomImage()

    def _s(v: bytes) -> str:
        return v.decode("ascii", "replace").strip("\0 ").strip()

    for group, elem, value in _read_elements(buf, pos, explicit, True):
        if value is None:
            continue
        tag = (group, elem)
        if tag == (0x0028, 0x0010):
            img.rows = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0011):
            img.cols = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0100):
            img.bits_allocated = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0028, 0x0103):
            img.pixel_representation = struct.unpack("<H", value[:2])[0]
        elif tag == (0x0020, 0x0013):
            try:
                img.instance_number = int(_s(value) or 0)
            except ValueError:
                pass
        elif tag == (0x0020, 0x0011):
            try:
                img.series_number = int(_s(value) or 0)
            except ValueError:
                pass
        elif tag == (0x0018, 0x1060):
            try:
                img.trigger_time = float(_s(value) or 0.0)
            except ValueError:
                pass
        elif tag == (0x0020, 0x1041):
            try:
                img.slice_location = float(_s(value) or 0.0)
            except ValueError:
                pass
        elif tag == (0x0028, 0x1052):
            img.rescale_intercept = float(_s(value) or 0.0)
        elif tag == (0x0028, 0x1053):
            img.rescale_slope = float(_s(value) or 1.0)
        elif tag == (0x0028, 0x0030):
            parts = _s(value).split("\\")
            if len(parts) == 2:
                img.pixel_spacing = (float(parts[0]), float(parts[1]))
        elif tag == (0x7FE0, 0x0010):
            img.pixel_data = value
    if not img.pixel_data:
        raise ValueError(f"No PixelData in {path}")
    return img


def series_to_array(paths: list[Path]) -> np.ndarray:
    """Stack a cine series into (H, W, 1, T) sorted by InstanceNumber.

    Frames whose matrix size differs from the series MAJORITY shape are
    dropped (keying on the first frame would throw away a whole valid
    series whenever instance 1 is the outlier)."""
    from collections import Counter

    images = [read_dicom(p) for p in paths]
    images.sort(key=lambda im: (im.instance_number, im.trigger_time))
    frames = [im.array() for im in images]
    majority = Counter(f.shape for f in frames).most_common(1)[0][0]
    frames = [f for f in frames if f.shape == majority]
    stack = np.stack(frames, axis=-1)  # (H, W, T)
    return stack[:, :, None, :]


def convert_dsb15(data_dir: Path, output_dir: Path) -> None:
    """DSB15 tree walk with dcm2niix-compatible output layout (the
    reference's ``dsb15_dicom2nifty.py``): ``<out>/<type>/<patient>/<case>/
    <case>.nii.gz``, int16, with ``validate`` renamed to ``valid``."""
    for type_ in ["train", "validate", "test"]:
        src = data_dir / type_
        if not src.is_dir():
            continue
        out_type = "valid" if type_ == "validate" else type_
        patient_dirs = sorted(d for d in src.iterdir() if d.is_dir())
        for patient_dir in patient_dirs:
            patient_id = patient_dir.parts[-1]
            for case in sorted(patient_dir.glob("*/sax*")):
                case_id = case.parts[-1]
                dcm_paths = sorted(case.glob("*.dcm")) or sorted(
                    p for p in case.iterdir() if p.is_file()
                )
                if not dcm_paths:
                    continue
                try:
                    data = series_to_array(dcm_paths)
                except ValueError as exc:
                    logging.warning(f"Skip {case}: {exc}")
                    continue
                out_path = output_dir / out_type / patient_id / case_id
                out_path.mkdir(parents=True, exist_ok=True)
                save_nifti(data.astype(np.int16), out_path / f"{case_id}.nii.gz")
            logging.info(f"Converted {patient_id}.")


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    parser = argparse.ArgumentParser(description="DSB15 DICOM -> NIfTI conversion.")
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    args = parser.parse_args(argv)
    convert_dsb15(args.data_dir, args.output_dir)


if __name__ == "__main__":
    main()
