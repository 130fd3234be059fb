"""vsr_tpu_torch — the PyTorch / CUDA port of ``vsr_tpu`` for NVIDIA Hopper.

The JAX package ``vsr_tpu`` is the reference; this package mirrors its module
and function names. It imports torch and numpy only: nothing from ``jax``,
``flax``, ``yaml`` or ``vsr_tpu``, so it runs where those are absent.

Slice 1 (this package today) is whole-sequence DRFNet x2 serving
(``python -m vsr_tpu_torch.infer ... --video``): k-space LR simulation,
normalize, DRFNet with the hand-written CUDA fused concat + 1x1 squeeze
(``ops/fused_squeeze.py``, ``csrc/fused_squeeze.cu``), denormalize.

Importing the package never compiles a kernel: ``_build.load`` runs
``nvcc`` at the first launch on a CUDA tensor.
"""
