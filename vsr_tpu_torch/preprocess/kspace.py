"""k-space truncation LR simulation (the serving pipeline's degrade step).

Orthonormal centered FFT -> zero all but the central ``(H//f, W//f)``
rectangle -> inverse FFT -> ``round(|.|)`` -> bicubic downscale by ``f`` ->
``clip(round(.), 0, 255)``, as ``vsr_tpu/preprocess/kspace.py``'s
``kspace_downscale_jax``. The frequency-domain chain is separable, so it is
``A_h @ img @ A_w.T`` with two dense complex matrices; here it runs as real
f32 matmuls, split into real and imaginary parts exactly as the JAX chain
does (the image is real, so the first product needs two real matmuls).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vsr_tpu_torch.preprocess.resize import resize_bicubic_torch


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
