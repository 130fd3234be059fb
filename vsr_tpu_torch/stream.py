"""Online (streaming, causal) SR serving, one time point per push, with the
state in device memory (port of ``vsr_tpu/stream.py``).

The batch pipelines (:mod:`vsr_tpu_torch.infer`) take every frame of a
sequence at once. A live feed (a scanner, a video stream) pushes one time
point and wants its SR frames back, with the temporal context kept on the
device between calls: a push costs one host-to-device copy of the HR stack,
and the caller copies back the SR frames it needs.

The stream families:

- **recurrent** (DRFNet, FRVSRNet, Volume4DSRNet): the state is the frame
  loop's carry (hidden features / the previous LR frame and SR estimate /
  the hidden volume). Every push emits at once. The adapters call the
  net's own submodules (``in_block`` + ``step``, ``step``, ``head`` +
  ``step``), so a stream shares the net's weights and computes what the
  batch net computes, the carry crossing calls instead of loop iterations;
- **windowed** (DUF, TOFlow, RBPN, EDVR: any net served with circular MISR
  windows): the state is a ring of prepped frames on the device. Interior
  outputs come ``nf - 1 - shift`` pushes after their frame; the boundary
  outputs, whose windows wrap around the sequence, come from
  :meth:`WindowStream.flush` once the sequence has ended;
- **per-frame** (EDSR, MoE-EDSR and the other SISR nets, the feedback
  nets SRFBNet and DRFSISRNet through their last step) and
  **volumetric** (Volume3DSRNet: one push is one (D, H, W) volume, served
  as one 3D sample): stateless, through the batch pipeline itself.

Usage::

    stream = make_stream(net, factor=2, dataset="acdc")
    for hr_stack in time_points:      # (N, H, W) slice stack
        out = stream.push(hr_stack)   # (lr, sr), or (t, lr, sr) / None
    for t, lr, sr in stream.flush():  # windowed boundary frames
        ...

All pushes of a sequence share one geometry ``(N, H, W)``; ``reset()``
starts a new sequence. Outputs are tensors on the net's device: the LR
frames and the uint8-valued float32 SR frames of ``infer.make_pipeline``.
Eager: every push runs the net's modules as the batch pipeline does.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.data.datasets import misr_target_index
from vsr_tpu_torch.infer import (VOLUME_NETS, denormalize, make_pipeline,
                                 make_prep, net_device)


class _StreamBase:
    """Geometry bookkeeping shared by the families: a sequence's pushes keep
    one (N, H, W) between resets."""

    def __init__(self, net: nn.Module, factor: int, dataset: str):
        # Full float32 in cuDNN and cuBLAS, as infer.make_pipeline sets.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.net = net.eval()
        self.dataset = dataset
        self.device = net_device(net)
        self._prep = make_prep(factor, dataset)
        self._shape = None

    def _to_device(self, hr_frames) -> torch.Tensor:
        """Check the push's geometry; one host-to-device copy."""
        hr = torch.as_tensor(np.asarray(hr_frames, np.float32))
        if hr.dim() != 3:
            raise ValueError(
                f"push() takes one (N, H, W) HR slice stack per time point; "
                f"got shape {tuple(hr.shape)}")
        if self._shape is None:
            self._shape = tuple(hr.shape)
        elif tuple(hr.shape) != self._shape:
            raise ValueError(
                f"stream geometry changed mid-sequence: {tuple(hr.shape)} vs "
                f"{self._shape}; reset() first")
        return hr.to(self.device)

    def reset(self) -> None:
        self._shape = None

    def flush(self) -> list:
        """End the sequence; return the deferred boundary outputs (windowed
        streams only: recurrent and per-frame streams have none)."""
        return []

    def fork(self):
        """A stream with fresh state that shares this one's net (the
        daemon's stream sessions): only the per-sequence state is new."""
        new = copy.copy(self)
        new.reset()
        return new


class FrameStream(_StreamBase):
    """Stateless SR: push -> (lr, sr) at once, through the batch pipeline.
    ``volume=False``: the frames are items of the batch (SISR nets).
    ``volume=True``: the push is ONE (D, H, W) volume served as a single 3D
    sample (Volume3DSRNet)."""

    def __init__(self, net: nn.Module, factor: int, dataset: str,
                 volume: bool = False):
        super().__init__(net, factor, dataset)
        self._pipeline = make_pipeline(net, factor, dataset,
                                       volume=("3d", 1) if volume else None)

    def push(self, hr_frames):
        return self._pipeline(self._to_device(hr_frames))


class Volume3DStream(FrameStream):
    """Stateless volumetric SR (Volume3DSRNet): each push is one (D, H, W)
    time-point volume served as one 3D sample, the batch volume pipeline's
    math with one time point per batch row."""

    def __init__(self, net: nn.Module, factor: int, dataset: str):
        super().__init__(net, factor, dataset, volume=True)


# step_builder(net) -> apply_step(state, z) -> (state, sr); state None on the
# first push of a sequence; z the prepped (N, 1, h, w) time point; sr the
# net's (N, C, H, W) output for it.
StepBuilder = Callable[[nn.Module], Callable]


class RecurrentStream(_StreamBase):
    """Streaming for the recurrent nets: the batch net's frame loop becomes
    one step per push, its carry kept on the device in between. The
    adapter (``step_builder``: :func:`_drf_stream`, :func:`_frvsr_stream`,
    :func:`_vol4d_stream`) runs the net's own step module on the net's own
    weights."""

    def __init__(self, net: nn.Module, factor: int, dataset: str,
                 step_builder: StepBuilder):
        nf = getattr(net, "upscale_factor", factor)
        if nf != factor:
            raise ValueError(
                f"recurrent stream carry geometry is derived from the "
                f"net's upscale_factor ({nf}), which must equal the "
                f"degradation factor ({factor})")
        super().__init__(net, factor, dataset)
        self._apply_step = step_builder(net)
        self._state = None

    def reset(self) -> None:
        self._shape = None
        self._state = None

    @torch.inference_mode()
    def push(self, hr_frames):
        lr, z = self._prep(self._to_device(hr_frames))
        self._state, sr = self._apply_step(self._state, z)
        return lr, denormalize(sr, self.dataset)


def _drf_stream(net: nn.Module):
    """DRFNet: the carry is the hidden FBlock features; frame 0's hidden is
    its own input features (``models/drf.py``). Under ``carry_f32`` the
    in-block emits float32 and the carry stays float32, as in the batch
    net."""

    def apply_step(hidden, z):
        in_feat = net.in_block(z)
        return net.step(in_feat if hidden is None else hidden, in_feat)

    return apply_step


def _frvsr_stream(net: nn.Module):
    """FRVSRNet: the carry is (previous LR frame, previous SR estimate);
    frame 0 warps against itself and a zero SR (``models/frvsr.py``)."""
    f = net.upscale_factor

    def apply_step(carry, z):
        if carry is None:
            n, c, h, w = z.shape
            carry = (z, z.new_zeros(n, c, h * f, w * f))
        sr, _warped_lr = net.step(carry[0], carry[1], z)
        return (z, sr.to(z.dtype)), sr

    return apply_step


def _vol4d_stream(net: nn.Module):
    """Volume4DSRNet: the carry is the hidden (1, F, D, h, w) volume; frame
    0's hidden is its own input features (``models/vol4d.py``). One push is
    one (D, H, W) time-point volume: one sample of depth D."""

    def apply_step(hidden, z):
        in_feat = net.head(z.permute(1, 0, 2, 3)[None])  # (1, F, D, h, w)
        hidden, out = net.step(in_feat if hidden is None else hidden,
                               in_feat, "full")
        return hidden, out[0].transpose(0, 1)  # (D, C, H, W)

    return apply_step


#: net class name -> recurrent stream adapter
RECURRENT_STREAMS = {"DRFNet": _drf_stream, "FRVSRNet": _frvsr_stream,
                     "Volume4DSRNet": _vol4d_stream}


class WindowStream(_StreamBase):
    """Streaming for circular-window MISR serving (DUF, TOFlow, RBPN, EDVR).

    Reproduces the batch window pipeline: output frame ``t`` of a
    ``T``-frame sequence sees window ``(t + arange(nf) - shift) % T``
    (``infer.make_prep``; ``shift = misr_target_index(nf)`` for ``order =
    'middle'``, ``nf - 1`` for ``'last'``). So:

    - interior outputs (no wrap) come ``e = nf - 1 - shift`` pushes after
      their frame arrives;
    - the first ``shift`` outputs wrap to the sequence's end and the last
      ``e`` to its head: :meth:`flush` emits them, in frame order, once the
      sequence length is known.

    Only the head ``nf - 1`` prepped frames and a rolling tail of ``nf`` are
    kept, on the device."""

    def __init__(self, net: nn.Module, factor: int, dataset: str, nf: int,
                 order: str = "middle"):
        if order not in ("middle", "last"):
            raise ValueError(f"order must be 'middle' or 'last': {order!r}")
        super().__init__(net, factor, dataset)
        self.nf = nf
        self.shift = misr_target_index(nf) if order == "middle" else nf - 1
        self.e = nf - 1 - self.shift
        self.reset()

    def reset(self) -> None:
        self._shape = None
        self._head: list = []  # the first nf - 1 prepped frames, (t, z)
        self._tail: list = []  # the last nf prepped frames, (t, z)
        self._lr: dict = {}    # t -> LR frames awaiting their output
        self._t = 0            # frames received

    def _apply(self, zs: list[torch.Tensor]) -> torch.Tensor:
        """nf prepped (N, 1, h, w) frames -> SR (N, H, W)."""
        out = self.net(torch.stack(zs, dim=1))
        if isinstance(out, tuple):
            out = out[0]
        if out.dim() == 5:  # a feedback net's steps: the last one
            out = out[-1]
        return denormalize(out, self.dataset)

    @torch.inference_mode()
    def push(self, hr_frames):
        """Returns ``(t, lr, sr)`` for the output frame this push completes,
        or None while the window context is still filling."""
        lr, z = self._prep(self._to_device(hr_frames))
        t = self._t
        self._t += 1
        if len(self._head) < self.nf - 1:
            self._head.append((t, z))
        self._tail.append((t, z))
        if len(self._tail) > self.nf:
            self._tail.pop(0)
        self._lr[t] = lr
        # Output t - e: its window is exactly the last nf frames pushed.
        t_out = t - self.e
        if t_out < self.shift:
            return None
        sr = self._apply([z for _, z in self._tail])
        return t_out, self._lr.pop(t_out), sr

    @torch.inference_mode()
    def flush(self) -> list:
        """The boundary outputs (head wraps, then tail wraps) as ``(t, lr,
        sr)`` in frame order; then reset for the next sequence."""
        total = self._t
        if total < self.nf:
            raise ValueError(
                f"sequence of {total} frames is shorter than the window "
                f"({self.nf}); circular windows need T >= nf")
        frames = dict(self._head) | dict(self._tail)
        pending = sorted(set(range(self.shift))
                         | set(range(total - self.e, total)))
        outs = []
        for t_out in pending:
            zs = [frames[(t_out + j - self.shift) % total]
                  for j in range(self.nf)]
            outs.append((t_out, self._lr.pop(t_out), self._apply(zs)))
        self.reset()
        return outs


def make_stream(net: nn.Module, factor: int, dataset: str = "acdc",
                windows: int = 0, order: str = "middle") -> _StreamBase:
    """The stream family for ``net`` (a built port net, on its serving
    device). ``windows > 0``: a :class:`WindowStream` of that many frames
    (the MISR serving protocol); otherwise the recurrent nets stream
    through their carry, Volume3DSRNet per volume and every other net per
    frame."""
    name = type(net).__name__
    if name in VOLUME_NETS and windows:
        raise ValueError(
            "the volumetric nets stream one (D, H, W) volume per push — "
            "circular windows do not apply")
    if windows:
        return WindowStream(net, factor, dataset, windows, order=order)
    if name == "Volume3DSRNet":
        return Volume3DStream(net, factor, dataset)
    if name in RECURRENT_STREAMS:
        return RecurrentStream(net, factor, dataset, RECURRENT_STREAMS[name])
    return FrameStream(net, factor, dataset)
