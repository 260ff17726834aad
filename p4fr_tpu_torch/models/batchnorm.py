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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.1  # torch's convention for flax's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, channels: int, eps: float):
        super().__init__(channels, eps=eps, momentum=MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
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
