"""The port's nets (NCHW ``nn.Module``s); importing registers them."""

from vsr_tpu_torch.models.drf import DRFNet

__all__ = ["DRFNet"]
