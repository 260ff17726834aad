"""BatchNorm with flax's train-mode statistics.

In train mode flax's ``nn.BatchNorm(momentum=0.9)`` normalizes with the
batch mean and the *biased* batch variance and updates
``ra = 0.9 * ra + 0.1 * batch`` with those same two statistics.
``torch.nn.BatchNorm2d`` normalizes the same way but updates its running
variance with the *unbiased* one, so a port held to the JAX package cannot
use it as it is. ``BatchNorm2d`` here keeps torch's module (its names and
state dict, and its eval mode) and replaces the running update: one
``F.batch_norm`` call normalizes and returns the batch mean and unbiased
variance in scratch buffers (momentum 1), and the variance is scaled back
to the biased one before it enters the running average.

The synced train form (``data_axis`` set, by ``parallel/sharding.py::
on_mesh``): flax's BatchNorm under jit sees the whole batch, so on a mesh
the statistics are those of the global batch. Each rank sums x and x^2 over
its rows, the sums are all-reduced over the data axis (differentiably, so
that gradients cross the ranks), and flax's formulas follow: mean = E[x],
var = max(E[x^2] - mean^2, 0) (biased), y = (x - mean) * (rsqrt(var + eps)
* scale) + bias, the same momentum. It runs on a mesh of one rank too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.1  # torch's convention for flax's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    data_axis = None  # a mesh's data axis: the synced train form

    def __init__(self, channels: int, eps: float):
        super().__init__(channels, eps=eps, momentum=MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.data_axis is not None:
            return self._synced(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - MOMENTUM).add_(mean, alpha=MOMENTUM)
            self.running_var.mul_(1 - MOMENTUM).add_(
                var, alpha=MOMENTUM * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1] * self.data_axis.size  # shards are equal
        sums = self.data_axis.sum(torch.cat([xf.sum(dims), xf.square().sum(dims)]))
        mean, mean2 = (sums / n).chunk(2)
        var = (mean2 - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self.running_mean.mul_(1 - MOMENTUM).add_(mean, alpha=MOMENTUM)
            self.running_var.mul_(1 - MOMENTUM).add_(var, alpha=MOMENTUM)
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)
