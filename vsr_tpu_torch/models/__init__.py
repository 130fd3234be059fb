"""The port's nets (NCHW ``nn.Module``s); importing registers them."""

from vsr_tpu_torch.models.drf import DRFNet
from vsr_tpu_torch.models.duf import DUFNet
from vsr_tpu_torch.models.edsr import EDSRNet
from vsr_tpu_torch.models.moe import MoEEDSRNet

__all__ = ["DRFNet", "DUFNet", "EDSRNet", "MoEEDSRNet"]
