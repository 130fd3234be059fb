"""The port's nets (NCHW ``nn.Module``s); importing registers them."""

from vsr_tpu_torch.models.bicubic import Bicubic
from vsr_tpu_torch.models.drf import DRFNet
from vsr_tpu_torch.models.duf import DUFNet
from vsr_tpu_torch.models.edsr import EDSRNet
from vsr_tpu_torch.models.moe import MoEEDSRNet
from vsr_tpu_torch.models.srfbn import SRFBNet

__all__ = ["Bicubic", "DRFNet", "DUFNet", "EDSRNet", "MoEEDSRNet", "SRFBNet"]
