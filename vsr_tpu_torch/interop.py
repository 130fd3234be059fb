"""Load a JAX (flax) net's variables into its counterpart in the port, by
flax path.

``load_jax_params(net, variables)`` takes the flax variables tree as nested
dicts of numpy arrays (``{"params": {...}}``, plus ``"batch_stats"`` for the
BatchNorm nets) and fills every parameter and buffer of the port's net. It
is strict: every flax leaf must be used, every torch parameter and buffer
filled, every shape match. Layouts:

- conv ``(kh, kw, C_in, C_out)`` -> ``(C_out, C_in, kh, kw)``;
- 3D conv ``(kd, kh, kw, C_in, C_out)`` -> ``(C_out, C_in, kd, kh, kw)``;
- fused squeeze ``.../Conv_k/Conv_0/kernel (1, 1, sum C, F)`` -> ``(F, sum C)``
  (the flax path is the plain conv's, so one checkpoint serves both);
- deconv ``(kh, kw, C_in, C_out)`` -> ``(C_in, C_out, kh, kw)`` with both
  spatial axes flipped (flax's transposed conv correlates, torch's
  convolves);
- PReLU ``alpha (1,)`` -> ``weight (1,)``;
- a deformable conv pack's ``weight (kh, kw, C_in, C_out)`` -> ``(C_out,
  C_in, kh, kw)``, and its offset conv like any conv (its output channels
  keep the stored order, see ``models/edvr.py``);
- BatchNorm ``params scale, bias`` -> ``weight, bias`` and ``batch_stats
  mean, var`` -> ``running_mean, running_var`` (TOFlow's SpyNet, DUF);
- the MoE leaves ``router (d, e)``, ``expert_wi (e, d, hid)``, ``expert_bi``,
  ``expert_wo``, ``expert_bo`` keep their shapes.

Numbered flax children (``Conv_i``, ``_ResBlock_i``, ``Conv3D_i``, ...)
follow flax's creation order, which the port's module lists keep. The
volumetric nets' tails continue the ``Conv3D_k`` numbering of their parent
(``Volume3DSRNet``: head 0, body end 1, then the tail; ``Volume4DSRNet``'s
``step``: the squeeze 0, then the tail), folded or not.

``from_jax_tree(net, tree)`` reads the same slot table the other way: it
lays a flax-shaped tree of numpy arrays (gradients, or updated parameters)
onto the port's parameter names, in the port's layouts, so tests can hold
``param.grad`` and trained parameters against ``jax.grad`` and optax.

``kernel_leaves(net)`` reads it for quantization (``quantize.py``): every
kernel leaf with its flax module path, the port module that owns it, its
flax shape and the port axis that holds flax's output-channel axis;
``SCAN_BODIES`` names the module paths that flax runs inside a scan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.models.common import (Conv, Conv3D, ConvTranspose,
                                         FusedSqueezeConv, ShuffleConv)
from vsr_tpu_torch.models.drf import DRFNet, DRFSISRNet, _DRFStep, _OutBlock
from vsr_tpu_torch.models.duf import DUFNet, _DenseBackbone, _DenseBlock
from vsr_tpu_torch.models.edsr import EDSRNet, _ResBlock, _UpBlock
from vsr_tpu_torch.models.edvr import (DeformConvPack, EDVRNet, PCDAlign,
                                       PredeblurPyramid, ResidualBlockNoBN)
from vsr_tpu_torch.models.feedback import FBlock, InBlock, PReLU
from vsr_tpu_torch.models.frvsr import FNet, FRVSRNet, SRNet
from vsr_tpu_torch.models.moe import ExpertChoiceMoE, MoEEDSRNet
from vsr_tpu_torch.models.rbpn import (DBPNet, RBPNet, _ConvP, _DeconvP,
                                       _ResChain)
from vsr_tpu_torch.models.srfbn import SRFBNet, _RBlock
from vsr_tpu_torch.models.toflow import SpyNet, TOFlowNet
from vsr_tpu_torch.models.vol3d import Volume3DSRNet, VolumeTail, _ResBlock3D
from vsr_tpu_torch.models.vol4d import Volume4DSRNet, _Vol4DStep

Slot = tuple[tuple[str, ...], torch.Tensor, Callable[[np.ndarray], np.ndarray]]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _squeeze_kernel(k: np.ndarray) -> np.ndarray:
    return k.reshape(k.shape[-2], k.shape[-1]).T


def _deconv_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _conv3d_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(4, 3, 0, 1, 2)


def _conv_slots(path: tuple[str, ...], conv: nn.Module) -> Iterator[Slot]:
    if isinstance(conv, FusedSqueezeConv):
        kernel = _squeeze_kernel
    elif isinstance(conv, ConvTranspose):
        kernel = _deconv_kernel
    elif isinstance(conv, Conv3D):
        kernel = _conv3d_kernel
    else:
        kernel = _conv_kernel
    yield ("params", *path, "kernel"), conv.weight, kernel
    yield ("params", *path, "bias"), conv.bias, _same


def _numbered_slots(prefix: tuple[str, ...], block: nn.Module) -> Iterator[Slot]:
    """A block's ``convs`` / ``deconvs`` / ``prelus`` / ``norms`` lists as
    flax's ``Conv_i/Conv_0`` (``Conv3D_i/Conv_0`` for 3D convs),
    ``ConvTranspose_i/ConvTranspose_0``, ``PReLU_i/alpha``,
    ``BatchNorm_i``."""
    for i, conv in enumerate(getattr(block, "convs", ())):
        name = "Conv3D" if isinstance(conv, Conv3D) else "Conv"
        yield from _conv_slots(prefix + (f"{name}_{i}", "Conv_0"), conv)
    for i, norm in enumerate(getattr(block, "norms", ())):
        yield from _norm_slots(prefix + (f"BatchNorm_{i}",), norm)
    for i, deconv in enumerate(getattr(block, "deconvs", ())):
        yield from _conv_slots(
            prefix + (f"ConvTranspose_{i}", "ConvTranspose_0"), deconv)
    for i, act in enumerate(getattr(block, "prelus", ())):
        yield ("params", *prefix, f"PReLU_{i}", "alpha"), act.weight, _same


def _norm_slots(path: tuple[str, ...], norm: nn.Module) -> Iterator[Slot]:
    yield ("params", *path, "scale"), norm.weight, _same
    yield ("params", *path, "bias"), norm.bias, _same
    yield ("batch_stats", *path, "mean"), norm.running_mean, _same
    yield ("batch_stats", *path, "var"), norm.running_var, _same


def _moe_slots(prefix: tuple[str, ...], moe: ExpertChoiceMoE) -> Iterator[Slot]:
    for leaf in ("router", "expert_wi", "expert_bi", "expert_wo", "expert_bo"):
        yield ("params", *prefix, leaf), getattr(moe, leaf), _same


def _edsr_slots(net: EDSRNet | MoEEDSRNet) -> Iterator[Slot]:
    """EDSRNet and MoEEDSRNet share the trunk: ``Conv_0`` head,
    ``_ResBlock_i``, ``Conv_1`` after the body, ``_UpBlock_0``,
    ``ShuffleConv_0``; the MoE net adds ``ExpertChoiceMoE_j`` in order."""
    yield from _conv_slots(("Conv_0", "Conv_0"), net.head)
    for i, block in enumerate(net.blocks):
        yield from _numbered_slots((f"_ResBlock_{i}",), block)
    for j, moe in enumerate(getattr(net, "moes", {}).values()):
        yield from _moe_slots((f"ExpertChoiceMoE_{j}",), moe)
    yield from _conv_slots(("Conv_1", "Conv_0"), net.body_end)
    yield from _numbered_slots(("_UpBlock_0",), net.up)
    yield from _conv_slots(("ShuffleConv_0", "FoldableConv_0"), net.tail.conv)


def _backbone_slots(prefix: tuple[str, ...],
                    backbone: _DenseBackbone) -> Iterator[Slot]:
    for i, block in enumerate(backbone.blocks):
        yield from _numbered_slots(prefix + (f"_DenseBlock_{i}",), block)
    yield from _norm_slots(prefix + ("BatchNorm_0",), backbone.norm)
    yield from _conv_slots(prefix + ("Conv3D_0", "Conv_0"), backbone.conv)


def _duf_slots(net: DUFNet) -> Iterator[Slot]:
    yield from _conv_slots(("Conv_0", "Conv_0"), net.head)
    yield from _backbone_slots(("_DenseBackbone_0",), net.backbone)
    for i, conv in enumerate([*net.filter_convs, *net.residual_convs]):
        yield from _conv_slots((f"Conv3D_{i}", "Conv_0"), conv)


def _out_block_slots(prefix: tuple[str, ...], block: _OutBlock) -> Iterator[Slot]:
    yield from _numbered_slots(prefix, block)
    yield from _conv_slots(prefix + ("ShuffleConv_0", "FoldableConv_0"),
                           block.tail.conv)


def _drf_step_slots(prefix: tuple[str, ...], step: _DRFStep) -> Iterator[Slot]:
    """A DRF step: ``FBlock_0``, ``ExpertChoiceMoE_0`` (with experts),
    ``_OutBlock_0``."""
    yield from _numbered_slots(prefix + ("FBlock_0",), step.fblock)
    if step.moe is not None:
        yield from _moe_slots(prefix + ("ExpertChoiceMoE_0",), step.moe)
    yield from _out_block_slots(prefix + ("_OutBlock_0",), step.out_block)


def _plain_slots(path: tuple[str, ...], conv: nn.Module,
                 kernel: Callable = _conv_kernel) -> Iterator[Slot]:
    """A flax ``nn.Conv`` / ``nn.ConvTranspose`` used directly (its kernel
    and bias at ``path``, no wrapping module)."""
    yield ("params", *path, "kernel"), conv.weight, kernel
    yield ("params", *path, "bias"), conv.bias, _same


def _spynet_slots(prefix: tuple[str, ...], spy: SpyNet) -> Iterator[Slot]:
    for i, block in enumerate(spy.blocks):
        yield from _numbered_slots(prefix + (f"_SpyNetBlock_{i}",), block)


def _convp_slots(prefix: tuple[str, ...],
                 m: _ConvP | _DeconvP) -> Iterator[Slot]:
    """RBPN's conv / deconv + PReLU: ``Conv_0/Conv_0`` or
    ``ConvTranspose_0/ConvTranspose_0``, and ``_PReLU_0/alpha``."""
    name = "ConvTranspose_0" if isinstance(m, _DeconvP) else "Conv_0"
    yield from _conv_slots(prefix + (name, name), m.conv)
    if m.act is not None:
        yield ("params", *prefix, "_PReLU_0", "alpha"), m.act.weight, _same


def _reschain_slots(prefix: tuple[str, ...],
                    chain: _ResChain) -> Iterator[Slot]:
    for i, block in enumerate(chain):
        path = prefix + (f"_ResnetBlock_{i}",)
        yield ("params", *path, "_PReLU_0", "alpha"), block.act.weight, _same
        yield from _numbered_slots(path, block)


def _dbpn_slots(prefix: tuple[str, ...], net: DBPNet) -> Iterator[Slot]:
    yield from _convp_slots(prefix + ("_ConvP_0",), net.head)
    for i, up in enumerate(net.ups):
        path = prefix + (f"_UpBlock_{i}",)
        yield from _convp_slots(path + ("_DeconvP_0",), up.deconvs[0])
        yield from _convp_slots(path + ("_ConvP_0",), up.conv)
        yield from _convp_slots(path + ("_DeconvP_1",), up.deconvs[1])
    for i, down in enumerate(net.downs):
        path = prefix + (f"_DownBlock_{i}",)
        yield from _convp_slots(path + ("_ConvP_0",), down.convs[0])
        yield from _convp_slots(path + ("_DeconvP_0",), down.deconv)
        yield from _convp_slots(path + ("_ConvP_1",), down.convs[1])
    yield from _convp_slots(prefix + ("_ConvP_1",), net.tail)


def _rbpn_slots(net: RBPNet) -> Iterator[Slot]:
    for name, m in (("_ConvP_0", net.feat0), ("_ConvP_1", net.feat1),
                    ("_DeconvP_0", net.res1_up), ("_ConvP_2", net.res2_conv),
                    ("_ConvP_3", net.res3_down), ("_ConvP_4", net.output)):
        yield from _convp_slots((name,), m)
    yield from _dbpn_slots(("DBPNet_0",), net.dbpn)
    for i, chain in enumerate((net.res1_chain, net.res2_chain,
                               net.res3_chain)):
        yield from _reschain_slots((f"_ResChain_{i}",), chain)


def _fnet_slots(prefix: tuple[str, ...], fnet: FNet) -> Iterator[Slot]:
    for i, conv in enumerate(fnet.convs):
        yield from _plain_slots(prefix + (f"Conv_{i}",), conv)


def _srnet_slots(prefix: tuple[str, ...], srnet: SRNet) -> Iterator[Slot]:
    for i, conv in enumerate(srnet.convs):
        yield from _plain_slots(prefix + (f"Conv_{i}",), conv)
    for i, block in enumerate(srnet.blocks):
        for j, conv in enumerate(block.convs):
            yield from _plain_slots(prefix + (f"_ResBlock_{i}", f"Conv_{j}"),
                                    conv)
    for i, deconv in enumerate(srnet.deconvs):
        yield from _plain_slots(prefix + (f"ConvTranspose_{i}",), deconv,
                                _deconv_kernel)


def _rb_slots(prefix: tuple[str, ...],
              block: ResidualBlockNoBN) -> Iterator[Slot]:
    for j, conv in enumerate(block.convs):
        yield from _plain_slots(prefix + (f"Conv_{j}",), conv)


def _dcn_slots(prefix: tuple[str, ...],
               pack: DeformConvPack) -> Iterator[Slot]:
    yield from _plain_slots(prefix + ("Conv_0",), pack.offset_conv)
    yield ("params", *prefix, "weight"), pack.weight, _conv_kernel
    yield ("params", *prefix, "bias"), pack.bias, _same


def _pcd_slots(prefix: tuple[str, ...], pcd: PCDAlign) -> Iterator[Slot]:
    yield from _numbered_slots(prefix, pcd)
    for i, dcn in enumerate(pcd.dcns):
        yield from _dcn_slots(prefix + (f"ModulatedDeformConvPack_{i}",), dcn)


def _predeblur_slots(prefix: tuple[str, ...],
                     pyr: PredeblurPyramid) -> Iterator[Slot]:
    yield from _numbered_slots(prefix, pyr)
    for i, block in enumerate(pyr.blocks):
        yield from _rb_slots(prefix + (f"ResidualBlockNoBN_{i}",), block)


def _edvr_slots(net: EDVRNet) -> Iterator[Slot]:
    yield from _numbered_slots((), net)  # the top-level convs
    for i, block in enumerate([*net.front, *net.back]):
        yield from _rb_slots((f"ResidualBlockNoBN_{i}",), block)
    if net.predeblur is not None:
        yield from _predeblur_slots(("PredeblurPyramid_0",), net.predeblur)
    yield from _pcd_slots(("PCDAlign_0",), net.pcd)
    if net.tsa is not None:
        yield from _numbered_slots(("TSAFusion_0",), net.tsa)
    yield from _conv_slots(("FoldableConv_0",), net.hr_conv)
    yield from _conv_slots(("FoldableConv_1",), net.last_conv)


def _volume_tail_slots(prefix: tuple[str, ...], tail: VolumeTail,
                       first: int) -> Iterator[Slot]:
    """A volumetric tail's convs continue the ``Conv3D_k`` numbering of the
    module that holds them at ``first``; a folded last conv keeps the plain
    conv's leaves."""
    for k, conv in enumerate([*tail.ups, tail.last], start=first):
        yield from _conv_slots(prefix + (f"Conv3D_{k}", "Conv_0"), conv)


def _vol4d_step_slots(prefix: tuple[str, ...],
                      step: _Vol4DStep) -> Iterator[Slot]:
    yield from _conv_slots(prefix + ("Conv3D_0", "Conv_0"), step.squeeze)
    for i, block in enumerate(step.blocks):
        yield from _numbered_slots(prefix + (f"_ResBlock3D_{i}",), block)
    yield from _volume_tail_slots(prefix, step.tail, 1)


def module_slots(module: nn.Module) -> Iterator[Slot]:
    """(flax path from the collection down, torch parameter or buffer,
    layout transform) for one of the port's nets or blocks, each against the
    variables of its own flax counterpart."""
    if isinstance(module, (EDSRNet, MoEEDSRNet)):
        yield from _edsr_slots(module)
    elif isinstance(module, DUFNet):
        yield from _duf_slots(module)
    elif isinstance(module, _DenseBackbone):
        yield from _backbone_slots((), module)
    elif isinstance(module, ExpertChoiceMoE):
        yield from _moe_slots((), module)
    elif isinstance(module, (DRFNet, DRFSISRNet)):
        # The scanned step's parameters are broadcast over the frames /
        # feedback steps: DRFNet names its scan "step", DRFSISRNet's is
        # flax's default name for a scan of _DRFStep.
        yield from _numbered_slots(("InBlock_0",), module.in_block)
        yield from _drf_step_slots((SCAN_BODIES[type(module)].rstrip("/"),),
                                   module.step)
    elif isinstance(module, _DRFStep):
        yield from _drf_step_slots((), module)
    elif isinstance(module, SRFBNet):
        # flax names the scanned step after its class; its parameters are
        # broadcast over the steps, so there is one set.
        step = ("Scan_SRFBStep_0",)
        yield from _numbered_slots(("InBlock_0",), module.in_block)
        yield from _numbered_slots(step + ("FBlock_0",), module.step.fblock)
        yield from _numbered_slots(step + ("_RBlock_0",), module.step.rblock)
    elif isinstance(module, TOFlowNet):
        yield from _numbered_slots((), module)  # the fusion head
        yield from _spynet_slots(("SpyNet_0",), module.spynet)
    elif isinstance(module, RBPNet):
        yield from _rbpn_slots(module)
    elif isinstance(module, DBPNet):
        yield from _dbpn_slots((), module)
    elif isinstance(module, FRVSRNet):
        # The scanned step's parameters are broadcast over the frames.
        yield from _fnet_slots(("step", "FNet_0"), module.step.fnet)
        yield from _srnet_slots(("step", "SRNet_0"), module.step.srnet)
    elif isinstance(module, EDVRNet):
        yield from _edvr_slots(module)
    elif isinstance(module, Volume3DSRNet):
        yield from _conv_slots(("Conv3D_0", "Conv_0"), module.head)
        for i, block in enumerate(module.blocks):
            yield from _numbered_slots((f"_ResBlock3D_{i}",), block)
        yield from _conv_slots(("Conv3D_1", "Conv_0"), module.body_end)
        yield from _volume_tail_slots((), module.tail, 2)
    elif isinstance(module, Volume4DSRNet):
        # The scanned step's parameters are broadcast over the frames (and
        # ``nn.remat`` leaves the tree as it is).
        yield from _conv_slots(("Conv3D_0", "Conv_0"), module.head)
        yield from _vol4d_step_slots(("step",), module.step)
    elif isinstance(module, _Vol4DStep):
        yield from _vol4d_step_slots((), module)
    elif isinstance(module, DeformConvPack):
        yield from _dcn_slots((), module)
    elif isinstance(module, (InBlock, FBlock, _RBlock, _ResBlock, _UpBlock,
                             _DenseBlock, _ResBlock3D)):
        yield from _numbered_slots((), module)
    elif isinstance(module, _OutBlock):
        yield from _out_block_slots((), module)
    elif isinstance(module, ShuffleConv):
        yield from _conv_slots(("FoldableConv_0",), module.conv)
    elif isinstance(module, ConvTranspose):
        yield from _conv_slots(("ConvTranspose_0",), module)
    elif isinstance(module, (Conv, Conv3D, FusedSqueezeConv)):
        yield from _conv_slots(("Conv_0",), module)
    elif isinstance(module, PReLU):
        yield ("params", "alpha"), module.weight, _same
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")


# Kernel layouts: the port axis of flax's last (output-channel) axis, and the
# flax shape of a port kernel.
_KERNEL_LAYOUTS: dict[Callable, tuple[int, Callable[[tuple], tuple]]] = {
    _conv_kernel: (0, lambda s: (*s[2:], s[1], s[0])),
    _conv3d_kernel: (0, lambda s: (*s[2:], s[1], s[0])),
    _squeeze_kernel: (0, lambda s: (1, 1, s[1], s[0])),
    _deconv_kernel: (1, lambda s: (*s[2:], s[0], s[1])),
}

# Module paths under a flax ``nn.scan`` body, by net: the frame / feedback
# step of DRFNet (``vsr_tpu/models/drf.py:237``), DRFSISRNet (``drf.py:160``),
# SRFBNet (``srfbn.py:109``), FRVSRNet (``frvsr.py:208``) and Volume4DSRNet
# (``vol4d.py:160``).
SCAN_BODIES: dict[type, str] = {DRFNet: "step/",
                                DRFSISRNet: "Scan_DRFStep_0/",
                                SRFBNet: "Scan_SRFBStep_0/",
                                FRVSRNet: "step/", Volume4DSRNet: "step/"}


@dataclass(frozen=True)
class KernelLeaf:
    """One ``kernel`` / ``weight`` leaf of rank >= 2 of the flax tree."""

    path: str             # flax module path, e.g. "InBlock_0/Conv_1/Conv_0"
    module: nn.Module     # the port module whose ``weight`` it is
    name: str             # the port parameter name
    tensor: torch.Tensor  # the port parameter
    out_axis: int         # the port axis of flax's output-channel axis
    flax_shape: tuple


def kernel_leaves(net: nn.Module) -> Iterator[KernelLeaf]:
    """Every kernel leaf of ``net``'s flax counterpart, in slot order."""
    names = {id(p): name for name, p in net.named_parameters()}
    owners = {id(m.weight): m for m in net.modules()
              if isinstance(getattr(m, "weight", None), torch.Tensor)}
    for path, tensor, transform in module_slots(net):
        if (path[0] == "params" and path[-1] in ("kernel", "weight")
                and tensor.dim() >= 2):
            axis, shape = _KERNEL_LAYOUTS[transform]
            yield KernelLeaf("/".join(path[1:-1]), owners[id(tensor)],
                             names[id(tensor)], tensor, axis,
                             shape(tuple(tensor.shape)))


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple[str, ...], Any]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = value
    return flat


def _as_f32(leaf: Any) -> np.ndarray:
    """A leaf as float32 numpy: a numpy array, or a ``torch.bfloat16``
    tensor (how ``utils/msgpack.py`` reads a bfloat16 leaf)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, dtype=np.float32)


def load_jax_params(net: nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill ``net``'s parameters and buffers from a flax variables tree
    (strict). Leaves are numpy arrays or, for bfloat16 ones, torch
    tensors."""
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if "params" not in variables or extra:
        raise ValueError(f"expected the 'params' collection (and "
                         f"'batch_stats' for BatchNorm nets), got "
                         f"{sorted(variables)}")
    leaves = _flatten(variables)
    slots = list(module_slots(net))
    paths = [path for path, _, _ in slots]
    unused = sorted(set(leaves) - set(paths))
    missing = sorted(set(paths) - set(leaves))
    if unused or missing:
        raise ValueError(f"flax tree and port disagree: unused flax leaves "
                         f"{['/'.join(p) for p in unused]}, missing "
                         f"{['/'.join(p) for p in missing]}")
    filled = {id(tensor) for _, tensor, _ in slots}
    targets = [*net.named_parameters(), *net.named_buffers()]
    unfilled = [name for name, t in targets if id(t) not in filled]
    if unfilled or len(filled) != len(slots):
        raise ValueError(f"port parameters and buffers not mapped "
                         f"one-to-one: unfilled {unfilled}")
    with torch.no_grad():
        for path, tensor, transform in slots:
            value = transform(_as_f32(leaves[path]))
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape "
                                 f"{value.shape} vs port {tuple(tensor.shape)}")
            tensor.copy_(torch.tensor(np.ascontiguousarray(value)))


def from_jax_tree(net: nn.Module, tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A flax-shaped tree (``{"params": {...}}``, or the params collection
    itself) of numpy arrays -> ``{port parameter name: array in the port's
    layout}``, for every parameter and buffer of ``net`` the tree holds."""
    if "params" not in tree:
        tree = {"params": tree}
    leaves = _flatten(tree)
    names = {id(t): name for name, t in
             [*net.named_parameters(), *net.named_buffers()]}
    out = {}
    for path, tensor, transform in module_slots(net):
        if path in leaves:
            value = transform(np.asarray(leaves[path], dtype=np.float32))
            out[names[id(tensor)]] = np.ascontiguousarray(value)
    return out
