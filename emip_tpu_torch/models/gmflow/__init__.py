"""GMFlow flow engine of the port."""

from emip_tpu_torch.models.gmflow.gmflow import GMFlow, GMFlowConfig

__all__ = ["GMFlow", "GMFlowConfig"]
