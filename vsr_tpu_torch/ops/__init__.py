"""Ops of the port: weight transforms and the hand-written CUDA kernels'
wrappers (each beside its plain PyTorch twin).

Importing the package registers the kernels' custom ops
(``torch.ops.vsr_tpu_torch.*``), which a saved ``torch.export`` program
names: load such a program after this import."""

from vsr_tpu_torch.ops import (duf_filter, fused_squeeze,  # noqa: F401
                               rank, w8a8_conv)
