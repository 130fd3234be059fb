"""The port's nets (NCHW ``nn.Module``s); importing registers them."""

from vsr_tpu_torch.models.bicubic import Bicubic
from vsr_tpu_torch.models.drf import DRFNet, DRFSISRNet
from vsr_tpu_torch.models.duf import DUFNet
from vsr_tpu_torch.models.edsr import EDSRNet
from vsr_tpu_torch.models.edvr import EDVRNet
from vsr_tpu_torch.models.frvsr import FRVSRNet
from vsr_tpu_torch.models.moe import MoEEDSRNet
from vsr_tpu_torch.models.rbpn import RBPNet
from vsr_tpu_torch.models.srfbn import SRFBNet
from vsr_tpu_torch.models.toflow import TOFlowNet
from vsr_tpu_torch.models.vol3d import Volume3DSRNet
from vsr_tpu_torch.models.vol4d import Volume4DSRNet

__all__ = ["Bicubic", "DRFNet", "DRFSISRNet", "DUFNet", "EDSRNet", "EDVRNet", "FRVSRNet",
           "MoEEDSRNet", "RBPNet", "SRFBNet", "TOFlowNet", "Volume3DSRNet",
           "Volume4DSRNet"]
