"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages: the JAX package on the CPU is the reference, the port runs its
plain PyTorch versions on the CPU.
"""

import numpy as np
import torch

# tier-1 runs several xdist workers on few cores
torch.set_num_threads(2)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def random_variables(module, *args, seed: int = 0, **kwargs):
    """A variable tree of numpy arrays with ``module``'s structure (shapes
    from jax.eval_shape, so nothing compiles) and weights drawn from numpy:
    fan-in scaled kernels, small biases, near-unit norm scales, layer-scales
    in [0.1, 0.5] so every ConvNeXt block moves the output, unit-normal
    rel-pos tables so no window softmax is uniform, BatchNorm running means
    near 0 and variances in [0.5, 1.5], and normal prototypes and classifier
    mats."""
    import jax

    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs),
                            *args)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        elif name == "gamma":
            v = rng.uniform(0.1, 0.5, shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("w1", "w2", "w3"):
            v = rng.randn(*shape) / np.sqrt(shape[0])
        else:
            v = rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_port(module, variables, prefix: str = ""):
    """Load a JAX variable tree into a port module through
    ``from_jax_variables``; ``prefix`` selects one subtree's keys."""
    from segland_tpu_torch.ckpt import from_jax_variables

    sd = {k[len(prefix):]: t(v) for k, v in from_jax_variables(variables).items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module


def near_tie_pixels(logits_up: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """Mask of pixels whose top-2 classes lie within ``tol`` of each other."""
    top2 = np.sort(logits_up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol
