"""The compute dtype of a model: fp32 or the bf16 band (inference and
training of the short model, the long model and the static segmentation
network).

The JAX package's models take a ``dtype`` (``compute_dtype`` of the YAML,
bfloat16 by default) under flax's rule: parameters stay fp32, and each
layer casts its input and its weights to ``dtype`` where it uses them,
except the normalisations, whose statistics (and every ``BatchNorm``)
stay fp32. The port follows the same rule. :func:`set_compute_dtype`
gives a module tree its dtype and each module reads it with
:func:`compute_dtype`; the layers below (drop-in subclasses of torch's,
with the same parameters and ``state_dict`` keys, and in fp32 the same
computation) cast their input and weights where flax casts them. Weights
are cast with :func:`cast`, which keeps one bf16 copy per weight for calls
without autograd, so inference on the card does not launch one cast per
weight per call. Rounding fp32 to bf16 is deterministic: the copy holds
the numbers flax's cast at use would give, and the fp32 parameters stay
what the state dict holds. Under autograd (training) :func:`cast` casts at
each use, as flax does, so that the cast's backward hands each fp32
parameter the fp32 sum of its bf16 grads: the parameters, the optimizer
and the checkpoints stay fp32 (no autocast, no loss scaling, as in the JAX
package).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from emip_tpu_torch.parallel import all_reduce_mean, world

__all__ = ["COMPUTE_DTYPES", "dtype_named", "cast", "set_compute_dtype",
           "compute_dtype", "Linear", "Conv2d", "ConvTranspose2d", "LayerNorm",
           "BatchNorm2d"]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_named(name: str) -> torch.dtype:
    """``compute_dtype`` of a YAML -> torch dtype; raises on other names."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """``p`` in ``dtype``. Without autograd the cast is made once and kept
    beside ``p`` until ``p`` changes (in place, or by moving), so repeated
    inference calls reuse it; with autograd it is made at every call."""
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled():
        return p.to(dtype)
    key = (dtype, p.device, p.data_ptr(), p._version)
    kept = getattr(p, "_emip_cast", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    out = p.detach().to(dtype)
    p._emip_cast = (key, out)
    return out


def set_compute_dtype(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """Give ``module`` and every submodule the compute dtype ``dtype``."""
    for m in module.modules():
        m.compute_dtype = dtype


def compute_dtype(module: torch.nn.Module) -> torch.dtype:
    """The compute dtype of ``module`` (fp32 unless it was given one)."""
    return getattr(module, "compute_dtype", torch.float32)


class Linear(nn.Linear):
    """``nn.Linear`` in its module's compute dtype (flax's ``Dense``):
    input, weight and bias cast to it."""

    def forward(self, x):
        dt = compute_dtype(self)
        if dt == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dt), cast(self.weight, dt), cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its module's compute dtype (flax's ``Conv``):
    input, weight and bias cast to it."""

    def forward(self, x):
        dt = compute_dtype(self)
        if dt == torch.float32:
            return super().forward(x)
        return self._conv_forward(x.to(dt), cast(self.weight, dt),
                                  cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its module's compute dtype (flax's
    ``ConvTranspose``): input, weight and bias cast to it."""

    def forward(self, x):
        dt = compute_dtype(self)
        if dt == torch.float32:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), cast(self.weight, dt),
                                  cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with fp32 statistics and parameters, returned in the
    input's dtype (flax's ``LayerNorm`` with a bf16 ``dtype``)."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that computes and returns fp32 whatever its input
    (flax's ``BatchNorm(dtype=float32)`` in the JAX package's bf16 model).

    In train mode it normalises with the batch statistics, as torch's does,
    and updates ``running_var`` with the biased batch variance, as flax's
    does (torch's own update takes the unbiased one, larger by n / (n - 1)
    for n elements a channel). ``momentum`` is torch's: flax's 0.9 is 0.1.

    With a process group of more than one rank (data parallelism), the
    statistics in train mode are those of the whole batch, as JAX computes
    them over the global batch inside ``jit``: the per-channel fp32 sums
    of x and x^2 and the element counts, reduced over the ranks with
    gradient (:func:`emip_tpu_torch.parallel.all_reduce_mean`), give the
    mean and the variance as flax computes it, max(E[x^2] - E[x]^2, 0),
    whatever rows each rank holds. The reduction is a collective: every
    rank must run each train-mode forward. With one process the path
    above runs and keeps its bits.
    """

    def forward(self, x):
        x = x.float()
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if world()[1] > 1:
            return self._synced_forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        # torch's update goes to a copy (which autograd keeps, so it must
        # not change after the call); it adds momentum * var * n / (n - 1),
        # which exceeds flax's momentum * var by (its addition) / n
        torch_var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, torch_var, self.weight,
                           self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(torch_var - (
                torch_var - (1.0 - self.momentum) * self.running_var) / n)
        return out

    def _synced_forward(self, x):
        self._check_input_dim(x)
        dims = (0, 2, 3)
        count = x.new_full((x.shape[1],), x.numel() // x.shape[1])
        sums = all_reduce_mean(torch.stack([x.sum(dims), (x * x).sum(dims),
                                            count]))
        mean, mean_sq = sums[0] / sums[2], sums[1] / sums[2]
        var = torch.clamp_min(mean_sq - mean ** 2, 0.0)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        y = (x - mean[:, None, None]) * scale[:, None, None]
        return y if self.bias is None else y + self.bias[:, None, None]
