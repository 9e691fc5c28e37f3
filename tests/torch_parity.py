"""Helpers shared by the tests/test_torch_*.py parity tests: nonzero random
parameters for a Flax module, made with numpy and loaded into the PyTorch
port through from_jax_params."""
import numpy as np
import jax
import torch

from imagine360_tpu.utils.convert import flatten_params, unflatten

from imagine360_tpu_torch.utils.convert import from_jax_params


def random_flat_params(model, init_args, seed, method=None):
    """Flat {'a.b.c': array} parameters of a Flax module, all nonzero:
    kernels ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.1), the rest
    N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *init_args,
                                               **({"method": method} if method else {})))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                            shapes["params"])).items():
        leaf = k.split(".")[-1]
        x = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            x = x / np.sqrt(int(np.prod(s.shape[:-1])))
        elif leaf in ("scale", "weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        flat[k] = x
    return flat


def jax_params(flat):
    return {"params": unflatten(flat)}


def load_into(torch_model, flat):
    """Load flat JAX parameters into the port's module, strictly."""
    res = torch_model.load_state_dict(from_jax_params(flat), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return torch_model.eval()


def max_abs_err(got, want):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    return float(np.abs(got.astype(np.float32) - np.asarray(want, np.float32)).max())


def random_state_dict(module, seed):
    """Nonzero random float32 tensors under a torch module's own names:
    weights of two or more dims ~ N(0, 1/fan_in), other weights
    1 + N(0, 0.1), the rest N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape))
        if v.dim() >= 2:
            x = x / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith(".weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd
