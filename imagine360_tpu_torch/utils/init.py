"""Weight initialisation for runs without checkpoints."""
from __future__ import annotations

import torch


@torch.no_grad()
def zero_init_(model: torch.nn.Module) -> None:
    """Every parameter zero: the dev mode of the CLI, as the JAX package's
    CLI initialises when no checkpoint is configured."""
    for p in model.parameters():
        p.zero_()


@torch.no_grad()
def seeded_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Every parameter drawn from `gen` (on the parameters' device): weights
    of rank >= 2 ~ N(0, 1/fan_in), norm weights 1 + N(0, 0.1), the rest
    N(0, 0.1). All nonzero, so no zero-initialised projection hides a
    path."""
    for name, p in model.named_parameters():
        x = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
        if p.dim() >= 2 and not name.endswith("latents"):
            x /= (p[0].numel()) ** 0.5
        elif name.endswith("weight") and p.dim() == 1:
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        p.copy_(x.to(p.dtype))
