"""Load a JAX (flax) DRFNet's variables into the port's DRFNet, by flax path.

``load_jax_params(net, variables)`` takes the flax variables tree as nested
dicts of numpy arrays (``{"params": {...}}``) and fills every parameter of
the port's net. It is strict: every flax leaf must be used, every torch
parameter filled, every shape match. Layouts:

- conv ``(kh, kw, C_in, C_out)`` -> ``(C_out, C_in, kh, kw)``;
- fused squeeze ``.../Conv_k/Conv_0/kernel (1, 1, sum C, F)`` -> ``(F, sum C)``
  (the flax path is the plain conv's, so one checkpoint serves both);
- deconv ``(kh, kw, C_in, C_out)`` -> ``(C_in, C_out, kh, kw)`` with both
  spatial axes flipped (flax's transposed conv correlates, torch's
  convolves);
- PReLU ``alpha (1,)`` -> ``weight (1,)``.

FBlock's ``Conv_i`` indices follow flax's creation order, which the port's
``convs`` lists keep (models/feedback.py).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from vsr_tpu_torch.models.common import (Conv, ConvTranspose,
                                         FusedSqueezeConv, ShuffleConv)
from vsr_tpu_torch.models.drf import DRFNet, _OutBlock
from vsr_tpu_torch.models.feedback import FBlock, InBlock, PReLU

Slot = tuple[tuple[str, ...], torch.Tensor, Callable[[np.ndarray], np.ndarray]]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _squeeze_kernel(k: np.ndarray) -> np.ndarray:
    return k.reshape(k.shape[-2], k.shape[-1]).T


def _deconv_kernel(k: np.ndarray) -> np.ndarray:
    return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _conv_slots(path: tuple[str, ...], conv: nn.Module) -> Iterator[Slot]:
    if isinstance(conv, FusedSqueezeConv):
        kernel = _squeeze_kernel
    elif isinstance(conv, ConvTranspose):
        kernel = _deconv_kernel
    else:
        kernel = _conv_kernel
    yield path + ("kernel",), conv.weight, kernel
    yield path + ("bias",), conv.bias, _same


def _numbered_slots(prefix: tuple[str, ...], block: nn.Module) -> Iterator[Slot]:
    """A block's ``convs`` / ``deconvs`` / ``prelus`` lists as flax's
    ``Conv_i/Conv_0``, ``ConvTranspose_i/ConvTranspose_0``,
    ``PReLU_i/alpha``."""
    for i, conv in enumerate(getattr(block, "convs", ())):
        yield from _conv_slots(prefix + (f"Conv_{i}", "Conv_0"), conv)
    for i, deconv in enumerate(getattr(block, "deconvs", ())):
        yield from _conv_slots(
            prefix + (f"ConvTranspose_{i}", "ConvTranspose_0"), deconv)
    for i, act in enumerate(getattr(block, "prelus", ())):
        yield prefix + (f"PReLU_{i}", "alpha"), act.weight, _same


def _out_block_slots(prefix: tuple[str, ...], block: _OutBlock) -> Iterator[Slot]:
    yield from _numbered_slots(prefix, block)
    yield from _conv_slots(prefix + ("ShuffleConv_0", "FoldableConv_0"),
                           block.tail.conv)


def module_slots(module: nn.Module) -> Iterator[Slot]:
    """(flax path under ``params``, torch parameter, layout transform) for
    the port's DRFNet or one of its blocks, each against the variables of
    its own flax counterpart."""
    if isinstance(module, DRFNet):
        yield from _numbered_slots(("InBlock_0",), module.in_block)
        yield from _numbered_slots(("step", "FBlock_0"), module.step.fblock)
        yield from _out_block_slots(("step", "_OutBlock_0"),
                                    module.step.out_block)
    elif isinstance(module, (InBlock, FBlock)):
        yield from _numbered_slots((), module)
    elif isinstance(module, _OutBlock):
        yield from _out_block_slots((), module)
    elif isinstance(module, ShuffleConv):
        yield from _conv_slots(("FoldableConv_0",), module.conv)
    elif isinstance(module, ConvTranspose):
        yield from _conv_slots(("ConvTranspose_0",), module)
    elif isinstance(module, (Conv, FusedSqueezeConv)):
        yield from _conv_slots(("Conv_0",), module)
    elif isinstance(module, PReLU):
        yield ("alpha",), module.weight, _same
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple[str, ...], Any]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (str(key),)))
        else:
            flat[prefix + (str(key),)] = value
    return flat


def load_jax_params(net: nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill ``net``'s parameters from a flax variables tree (strict)."""
    if set(variables) != {"params"}:
        raise ValueError(f"expected exactly the 'params' collection, got "
                         f"{sorted(variables)}")
    leaves = _flatten(variables["params"])
    slots = list(module_slots(net))
    paths = [path for path, _, _ in slots]
    unused = sorted(set(leaves) - set(paths))
    missing = sorted(set(paths) - set(leaves))
    if unused or missing:
        raise ValueError(f"flax tree and port disagree: unused flax leaves "
                         f"{['/'.join(p) for p in unused]}, missing "
                         f"{['/'.join(p) for p in missing]}")
    filled = {id(param) for _, param, _ in slots}
    unfilled = [name for name, p in net.named_parameters()
                if id(p) not in filled]
    if unfilled or len(filled) != len(slots):
        raise ValueError(f"port parameters not mapped one-to-one: unfilled "
                         f"{unfilled}")
    with torch.no_grad():
        for path, param, transform in slots:
            value = transform(np.asarray(leaves[path], dtype=np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape "
                                 f"{value.shape} vs port {tuple(param.shape)}")
            param.copy_(torch.tensor(np.ascontiguousarray(value)))
