"""Training losses of the port (counterpart of :mod:`emip_tpu.losses`)."""

from emip_tpu_torch.losses.flow import (
    UnsupFlowLossConfig,
    ssim_distance,
    unsup_flow_loss,
)
from emip_tpu_torch.losses.seg import hybrid_e_loss

__all__ = ["UnsupFlowLossConfig", "hybrid_e_loss", "ssim_distance",
           "unsup_flow_loss"]
