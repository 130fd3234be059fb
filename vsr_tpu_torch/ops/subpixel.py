"""Sub-pixel (phase-decomposed) transposed convolution, the port of
``vsr_tpu/ops/subpixel.py``.

``F.conv_transpose2d(x, W, stride=s, padding=p)`` with a ``(C_in, C_out, k,
k)`` weight is computed EXACTLY as one dense stride-1 convolution at the
input's resolution with ``s^2 * C_out`` output channels, followed by
``F.pixel_shuffle(., s)``. Same linear map, same parameters (the bank is
rebuilt from the live weight at every call, with slices and pads, so the
gradient reaches the transposed conv's weight).

Derivation, for torch's geometry (not the JAX function's, whose kernel is
flax's ``(k, k, In, Out)`` under ``lax.conv_transpose``). The transposed
conv scatters ``x[i]`` with tap ``a`` to output ``y = s*i - p + a``, so

    out[y] = sum_{a, i : s*i = y + p - a} x[i] * W[a].

Output phase ``r = y mod s`` (``y = s*j + r``) reads only the taps ``a =
a0_r + s*m`` with ``a0_r = (r + p) mod s``, and tap ``m`` reads input ``i =
j + c_r - m`` with ``c_r = (r + p - a0_r) / s``. As a correlation over a
window of input offsets ``d = c_r - m`` (common to all phases: ``d_min ..
d_max``), phase ``r``'s row holds its taps in reverse order at window
positions ``c_r - m - d_min``; the conv pads ``-d_min`` before and
``d_max`` after (the same number when ``k - 2p = s``). Phase ``(ry, rx)``
of output channel ``o`` is bank channel ``o*s^2 + ry*s + rx``: the order
``F.pixel_shuffle`` reads (the JAX bank orders its blocks ``(ry*s + rx)*Out
+ o`` for its own interleave).

The output is ``s`` times the input, which is what the transposed conv
gives when ``k - 2p + output_padding = s`` (every projection of the
feedback and DBPN ladders: k6 s2 p2, k7 s3 p2, k8 s4 p2, k12 s8 p2, k4 s2
p1; FRVSR's k3 s2 p1 with an output padding of 1 and k3 s3 p0); other
geometries are refused. Without an output padding the window is
symmetric (``d_min = -d_max``); with one the conv pads ``-d_min`` before and
``d_max`` after (:func:`phase_padding`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def phase_geometry(k: int, s: int, p: int, output_padding: int = 0):
    """Per output phase ``r``: ``(a0_r, taps_r, c_r)``, and the window's
    ``(d_min, d_max)``."""
    if k - 2 * p + output_padding != s:
        raise ValueError(
            f"the sub-pixel transposed conv computes outputs of stride x the "
            f"input (kernel - 2 * padding + output_padding == stride); got "
            f"kernel {k}, stride {s}, padding {p}, output padding "
            f"{output_padding}")
    phases = []
    for r in range(s):
        a0 = (r + p) % s
        taps = len(range(a0, k, s))
        phases.append((a0, taps, (r + p - a0) // s))
    d_min = min(c - taps + 1 for _, taps, c in phases)
    d_max = max(c for _, _, c in phases)
    return phases, d_min, d_max


def phase_padding(k: int, s: int, p: int,
                  output_padding: int = 0) -> tuple[int, int]:
    """The bank conv's zero padding of each spatial axis, ``(before,
    after)`` = ``(-d_min, d_max)``."""
    _, d_min, d_max = phase_geometry(k, s, p, output_padding)
    return -d_min, d_max


def subpixel_bank(weight: torch.Tensor, s: int, p: int,
                  output_padding: int = 0) -> torch.Tensor:
    """``(C_in, C_out, k, k)`` transposed-conv weight -> the ``(C_out*s*s,
    C_in, w, w)`` stride-1 conv weight, channel ``o*s^2 + ry*s + rx`` holding
    phase ``(ry, rx)`` of output channel ``o``. Only slices, flips and zero
    pads: an int8 weight gives the int8 bank."""
    c_in, c_out, k, _ = weight.shape
    phases, d_min, d_max = phase_geometry(k, s, p, output_padding)
    w = d_max - d_min + 1
    blocks = []
    for a0y, ty, cy in phases:
        for a0x, tx, cx in phases:
            # Taps in increasing m sit at decreasing window positions.
            block = weight[:, :, a0y::s, a0x::s].flip(2, 3)
            y0, x0 = cy - ty + 1 - d_min, cx - tx + 1 - d_min
            blocks.append(F.pad(block, (x0, w - x0 - tx, y0, w - y0 - ty)))
    bank = torch.stack(blocks).reshape(s, s, c_in, c_out, w, w)
    return bank.permute(3, 0, 1, 2, 4, 5).reshape(c_out * s * s, c_in, w, w)


def conv_transpose_subpixel(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None, s: int,
                            p: int) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, bias, s, p)`` as one stride-1 conv +
    ``F.pixel_shuffle``. x: ``(N, C_in, H, W)``; weight ``(C_in, C_out, k,
    k)``. Returns ``(N, C_out, s*H, s*W)``, in ``x``'s dtype (the weight
    and bias are used as given: cast them first)."""
    _, _, d_max = phase_geometry(weight.shape[-1], s, p)
    bank = subpixel_bank(weight, s, p)
    b = None if bias is None else bias.repeat_interleave(s * s)
    # With kernel - 2 * padding == stride the window is symmetric:
    # d_min == -d_max.
    return F.pixel_shuffle(F.conv2d(x, bank, b, padding=d_max), s)
