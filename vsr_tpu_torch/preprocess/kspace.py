"""k-space truncation LR simulation (the serving pipeline's degrade step).

Orthonormal centered FFT -> zero all but the central ``(H//f, W//f)``
rectangle -> inverse FFT -> ``round(|.|)`` -> bicubic downscale by ``f`` ->
``clip(round(.), 0, 255)``, as ``vsr_tpu/preprocess/kspace.py``'s
``kspace_downscale_jax``. The frequency-domain chain is separable, so it is
``A_h @ img @ A_w.T`` with two dense complex matrices; here it runs as real
f32 matmuls, split into real and imaginary parts exactly as the JAX chain
does (the image is real, so the first product needs two real matmuls).

:func:`kspace_downscale` is the float64 numpy path of one frame (``vsr_tpu``'s:
numpy.fft, the reference's backend), which the offline pipeline's default
``numpy`` backend runs for reference parity. Where the factor divides both
sides (always in the pipeline, whose frames are cropped to multiples of 12)
its bicubic step runs as two float64 matmuls instead of ``vsr_tpu``'s
three-operand ``einsum``, which loops over every (output, input) pixel pair
(about 1 s a 216 x 252 frame on a CPU core): the source offsets are then
whole or half pixels, every weight is a multiple of 1/32, the low-passed
frame holds integers, so every partial sum is exact in float64 and neither
order of summation can change a bit. ``tests/test_torch_offline.py`` pins
the pipeline's files byte-equal to the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vsr_tpu_torch.preprocess.resize import (bicubic_resize_matrix,
                                             resize_bicubic,
                                             resize_bicubic_torch)


def kspace_truncation_mask(h: int, w: int, factor: int) -> np.ndarray:
    """The central-rectangle pass mask in fftshifted coordinates."""
    mask = np.zeros((h, w), dtype=np.float64)
    kx_max, ky_max = h // 2, w // 2
    lx, ly = h // factor, w // factor
    mask[
        kx_max - lx // 2 : kx_max + (lx - lx // 2),
        ky_max - ly // 2 : ky_max + (ly - ly // 2),
    ] = 1.0
    return mask


def kspace_lowpass(img: np.ndarray, factor: int) -> np.ndarray:
    """FFT -> truncate -> iFFT -> round(abs(.)) at the original resolution."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    kspace = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(img), norm="ortho"))
    mask = kspace_truncation_mask(img.shape[0], img.shape[1], factor)[..., None]
    lowpassed = np.fft.fftshift(np.fft.ifftn(np.fft.ifftshift(kspace * mask), norm="ortho"))
    out = np.around(np.abs(lowpassed))
    return out[..., 0] if squeeze else out


def kspace_downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """Full LR simulation for one (H, W) or (H, W, 1) frame, numpy path."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    low = kspace_lowpass(img, factor)
    h, w, _ = low.shape
    if h % factor or w % factor:
        lr = resize_bicubic(low[..., 0], h // factor, w // factor)
    else:  # exact: the same bits as the einsum (module docstring)
        lr = (bicubic_resize_matrix(h, h // factor) @ low[..., 0]
              @ bicubic_resize_matrix(w, w // factor).T)
    lr = np.clip(np.round(lr), 0, 255)[..., None]
    return lr[..., 0] if squeeze else lr


@functools.lru_cache(maxsize=64)
def kspace_lowpass_matrix(size: int, factor: int) -> np.ndarray:
    """The 1-D centered-FFT -> rect-truncate -> centered-iFFT pipeline as a
    dense complex matrix (copy of ``vsr_tpu``'s; the tests pin it equal)."""
    mask_1d = np.zeros(size)
    center = size // 2
    ext = size // factor
    mask_1d[center - ext // 2 : center + (ext - ext // 2)] = 1.0

    eye = np.eye(size)
    x = np.fft.ifftshift(eye, axes=0)
    x = np.fft.fft(x, axis=0, norm="ortho")
    x = np.fft.fftshift(x, axes=0)
    x = mask_1d[:, None] * x
    x = np.fft.ifftshift(x, axes=0)
    x = np.fft.ifft(x, axis=0, norm="ortho")
    a = np.fft.fftshift(x, axes=0)
    a.setflags(write=False)
    return a  # (size, size) complex128


def kspace_downscale_torch(imgs: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W) frames in [0, 255] -> (..., H//factor, W//factor) float32
    LR frames in [0, 255], on the frames' device.

    Full f32 matmuls: on the card ``torch.backends.cuda.matmul.allow_tf32``
    must be off (the JAX chain runs at ``Precision.HIGHEST``)."""
    h, w = imgs.shape[-2], imgs.shape[-1]
    a_h = kspace_lowpass_matrix(h, factor)
    a_w = kspace_lowpass_matrix(w, factor)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=imgs.device)

    rh, ih, rw, iw = t(a_h.real), t(a_h.imag), t(a_w.real), t(a_w.imag)
    x = imgs.float()
    y_r, y_i = torch.matmul(rh, x), torch.matmul(ih, x)
    z_r = torch.matmul(y_r, rw.T) - torch.matmul(y_i, iw.T)
    z_i = torch.matmul(y_r, iw.T) + torch.matmul(y_i, rw.T)
    low = torch.round(torch.sqrt(z_r * z_r + z_i * z_i))
    lr = resize_bicubic_torch(low, h // factor, w // factor)
    return torch.clamp(torch.round(lr), 0.0, 255.0)
