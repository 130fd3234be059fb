"""Ops of the port: weight transforms and the hand-written CUDA kernels'
wrappers (each beside its plain PyTorch twin)."""
