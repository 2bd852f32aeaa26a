"""Hand-written CUDA kernels of the port, one module per TPU kernel.

Each public function takes the JAX package's layout, runs its plain
PyTorch version on CPU tensors and its CUDA kernel on CUDA tensors, and
counts its kernel launches in :data:`LAUNCHES`. Kernels A-D and F-J
are ``torch.autograd.Function``s whose CUDA backward is a kernel too; E is
forward only. The kernels are built from ``emip_tpu_torch/csrc`` at first
use (:func:`library`).
"""

from emip_tpu_torch.kernels._build import KernelBuildError, library
from emip_tpu_torch.kernels._common import LAUNCHES, reset_launches
from emip_tpu_torch.kernels.convex_upsample import (
    convex_upsample,
    convex_upsample_reference,
)
from emip_tpu_torch.kernels.dwconv_gelu import (
    fused_dwconv_gelu,
    fused_dwconv_gelu_reference,
)
from emip_tpu_torch.kernels.flow_attention import (
    fused_flow_attention,
    fused_flow_attention_reference,
)
from emip_tpu_torch.kernels.memory_attention import (
    masked_memory_attention,
    masked_memory_attention_reference,
)
from emip_tpu_torch.kernels.softmax_expectation import (
    softmax_expectation,
    softmax_expectation_reference,
)
from emip_tpu_torch.kernels.splat import splat_density, splat_density_reference
from emip_tpu_torch.kernels.sr_attention import (
    fused_sr_attention,
    fused_sr_attention_reference,
)
from emip_tpu_torch.kernels.window_attention import (
    fused_window_attention_block,
    fused_window_attention_block_reference,
    fused_window_attention_ffn_layer,
    fused_window_attention_ffn_layer_reference,
    fused_window_attention_layer,
    fused_window_attention_layer_reference,
)

__all__ = [
    "KernelBuildError",
    "LAUNCHES",
    "convex_upsample",
    "convex_upsample_reference",
    "fused_dwconv_gelu",
    "fused_dwconv_gelu_reference",
    "fused_flow_attention",
    "fused_flow_attention_reference",
    "fused_sr_attention",
    "fused_sr_attention_reference",
    "fused_window_attention_block",
    "fused_window_attention_block_reference",
    "fused_window_attention_ffn_layer",
    "fused_window_attention_ffn_layer_reference",
    "fused_window_attention_layer",
    "fused_window_attention_layer_reference",
    "library",
    "masked_memory_attention",
    "masked_memory_attention_reference",
    "reset_launches",
    "softmax_expectation",
    "softmax_expectation_reference",
    "splat_density",
    "splat_density_reference",
]
