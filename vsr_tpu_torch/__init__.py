"""vsr_tpu_torch — the PyTorch / CUDA port of ``vsr_tpu`` for NVIDIA Hopper.

The JAX package ``vsr_tpu`` is the reference; this package mirrors its module
and function names. It imports torch and numpy only: nothing from ``jax``,
``flax``, ``optax``, ``yaml``, ``PIL``, ``msgpack``, ``tqdm`` or ``vsr_tpu``,
so it runs where those are absent.

Serving, through ``python -m vsr_tpu_torch.infer`` (k-space LR simulation,
normalize, net, denormalize):

- whole-sequence DRFNet x2 serving (``--video``), with the hand-written CUDA
  fused concat + 1x1 squeeze (``ops/fused_squeeze.py``,
  ``csrc/fused_squeeze.cu``);
- frame-mode serving of EDSRNet and MoEEDSRNet, whose expert-choice router
  ranks with the hand-written CUDA pairwise rank (``ops/rank.py``,
  ``csrc/pairwise_rank.cu``);
- window-mode serving of DUFNet (``--windows N [--chunk M]``), whose dynamic
  filters are applied by the hand-written CUDA fused softmax + filter +
  pixel shuffle (``ops/duf_filter.py``, ``csrc/duf_filter.cu``).

Training, through ``python -m vsr_tpu_torch.main <config.yaml>`` on the JAX
package's YAML schema: the trainer core with the SISR and VSR trainers
(``runner/trainers.py``), datasets, transforms and loader (``data/``), losses,
metrics, optimizers and schedulers, monitor and loggers (``callbacks/``),
checkpoints and preemption recovery (``utils/``). The fused squeeze is
differentiable (its ``dx`` runs through the same CUDA kernel, its ``dW`` and
``db`` through ``csrc/fused_squeeze_dw.cu``), so DRFNet trains with the
kernel on. ``mesh_axes: {data: n}`` trains one model across ``n`` processes
(``parallel/``: DDP, ZeRO-1, FSDP, sharded checkpoints), and ``python -m
vsr_tpu_torch.convert --consolidate`` stitches a sharded checkpoint.

Importing the package never compiles a kernel: ``_build.load`` runs
``nvcc`` at the first launch on a CUDA tensor.
"""
