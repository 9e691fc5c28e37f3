"""The port's training step on its own, on the CPU: gradients with remat
equal those without, and twenty steps lower the loss. They share the micro
set-up of tests/test_torch_training.py (`_torch_setup`), and sit in a file
of their own so that `pytest -n --dist loadfile` runs them beside that
file's one jitted JAX train step rather than after it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from imagine360_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from imagine360_tpu_torch.presets import micro_unet_config as t_micro_unet
from imagine360_tpu_torch.training import train as ttrain
from imagine360_tpu_torch.utils.init import seeded_init_

from test_torch_training import _torch_setup


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_remat_gradients_match():
    """Gradients with remat equal those without (tests/test_training.py:
    test_remat_grads_match), for one branch and for the dual walk."""
    gen = torch.Generator().manual_seed(1)
    cfg0 = t_micro_unet()
    m0, m1 = TUNet(cfg0), TUNet(dataclasses.replace(cfg0, remat=True))
    seeded_init_(m0, gen)
    m1.load_state_dict(m0.state_dict())
    x = torch.randn(1, 2, 8, 16, 9, generator=gen)
    args = (x, torch.tensor([10.0]), torch.randn(1, 7, 32, generator=gen), torch.tensor([8.0]),
            torch.randn(1, 16, 16, 8, generator=gen))

    def grads(m):      # no rel_pos is given, so the adapter's weights get no gradient
        return torch.autograd.grad(m(*args).pow(2).mean(), list(m.parameters()),
                                   allow_unused=True)

    g0, g1 = grads(m0), grads(m1)
    assert sum(g is not None for g in g0) > 100
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        assert a is None or float((a - b).abs().max()) < 1e-5

    tc = ttrain.TrainConfig(lr=1e-3, antipodal_prob=0.0)
    losses = []
    for remat in (False, True):
        model, batch, step, opt = _torch_setup(tc, remat=remat)
        state, metrics = step(ttrain.TrainState.create(model, opt), batch,
                              torch.Generator().manual_seed(4))
        losses.append((metrics["loss"].item(), metrics["grad_norm"].item(),
                       [p.detach().clone() for p in model.parameters()]))
    assert losses[0][0] == pytest.approx(losses[1][0], rel=1e-6)
    assert losses[0][1] == pytest.approx(losses[1][1], rel=1e-5)
    for a, b in zip(losses[0][2], losses[1][2]):
        assert float((a - b).abs().max()) < 1e-6


def test_train_loss_decreases():
    """The same draws every step (a fresh generator with one seed): 20 steps
    lower the loss by 10% (tests/test_training.py:test_train_loss_decreases)."""
    model, batch, step, opt = _torch_setup(ttrain.TrainConfig(lr=2e-3, antipodal_prob=0.0))
    state = ttrain.TrainState.create(model, opt)
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch, torch.Generator().manual_seed(9))
        losses.append(metrics["loss"].item())
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
