"""K1 made differentiable (``ops/fused_mlp.py:LnMlp``) against the JAX
package's custom VJP: ``jax.grad`` through ``segland_tpu.ops.pallas_mlp.
fused_ln_mlp(interpret=True)``, whose forward is the Pallas kernel and whose
backward is the VJP of its XLA reference.  On the CPU the Function's forward
is K1's plain version and its backward the plain version's autograd.  fp32:
every gradient within 1e-5 of the largest |gradient| of its tensor; bf16 (JAX
differentiates its erf reference, the port its tanh one, as each forward
runs): a cosine of at least 0.999 per tensor.  Then the guard that stops a
kernel without a backward from handing back a detached result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops.pallas_mlp import _tile_m, fused_ln_mlp as j_fused
from segland_tpu_torch.ops import forward_only
from segland_tpu_torch.ops.fused_mlp import LnMlp, fused_ln_mlp

NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2", "res", "ls")


def _inputs(c, hid, m, with_res, with_ls, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    a = dict(x=f(m, c), gamma=1.0 + 0.1 * f(c), beta=0.1 * f(c), w1=0.05 * f(c, hid),
             b1=0.05 * f(hid), w2=0.05 * f(hid, c), b2=0.05 * f(c))
    a["res"] = f(m, c) if with_res else None
    a["ls"] = rng.uniform(0.1, 1.0, c).astype(np.float32) if with_ls else None
    return a, f(m, c)  # the inputs and the output's cotangent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_res,with_ls", [(False, False), (True, False), (True, True)])
def test_gradients_match_the_jax_custom_vjp(dtype, with_res, with_ls):
    c, hid = 96, 384
    m = _tile_m(c, hid, 4 if dtype == "float32" else 2)
    a, cot = _inputs(c, hid, m, with_res, with_ls)
    keys = [k for k in NAMES if a[k] is not None]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def jloss(*vals):
        kw = dict(zip(keys, vals))
        x = kw.pop("x").astype(jdt)
        res = kw.pop("res", None)
        out = j_fused(x, **kw, res=None if res is None else res.astype(jdt), eps=1e-6,
                      interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(jloss, argnums=tuple(range(len(keys))))(*[jnp.asarray(a[k]) for k in keys])
    leaves = {k: t(a[k]).requires_grad_(True) for k in keys}
    x = leaves["x"].to(tdt)
    res = leaves["res"].to(tdt) if with_res else None
    out = fused_ln_mlp(x, leaves["gamma"], leaves["beta"], leaves["w1"], leaves["b1"],
                       leaves["w2"], leaves["b2"], res=res, ls=leaves.get("ls"), eps=1e-6)
    assert out.dtype == tdt and out.grad_fn is not None
    (out.float() * t(cot)).sum().backward()
    for k, w in zip(keys, want):
        g, w = leaves[k].grad.numpy().astype(np.float64), np.asarray(w, np.float64)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
        else:
            cos = (g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum())
            assert cos >= 0.999, (k, cos)


def test_a_weight_transpose_gets_its_gradient():
    """ConvNeXtBlock hands K1 ``pwconv1.weight.T``: the gradient reaches the
    weight through the view, equal to autograd through the plain version."""
    lin1, lin2 = torch.nn.Linear(8, 32), torch.nn.Linear(32, 8)
    x = torch.randn(2, 5, 8, requires_grad=True)
    g, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    grads = []
    for fn in (fused_ln_mlp, None):
        for p in (x, g, b, *lin1.parameters(), *lin2.parameters()):
            p.grad = None
        if fn is None:
            from segland_tpu_torch.ops.fused_mlp import ln_mlp_reference as fn
        out = fn(x, g, b, lin1.weight.T, lin1.bias, lin2.weight.T, lin2.bias)
        out.pow(2).sum().backward()
        grads.append([p.grad.clone() for p in (x, g, b, *lin1.parameters(),
                                                *lin2.parameters())])
    for a, w in zip(*grads):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_inference_takes_the_direct_call():
    """No grad asked: no Function node; under grad with nothing requiring it,
    none either."""
    a, _ = _inputs(8, 32, 4, True, True)
    args = [t(a[k]) for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
    for ctx in (torch.no_grad(), torch.enable_grad()):
        with ctx:
            out = fused_ln_mlp(*args, res=t(a["res"]), ls=t(a["ls"]))
        assert out.grad_fn is None
    args[3].requires_grad_(True)
    out = fused_ln_mlp(*args)
    assert type(out.grad_fn).__name__ == "ViewBackward0"
    assert type(out.grad_fn.next_functions[0][0]).__name__ == LnMlp.__name__ + "Backward"


def test_forward_only_raises_where_a_gradient_is_asked_for():
    """The guard every kernel without a backward runs before it launches."""
    plain, needs = torch.zeros(3), torch.zeros(3, requires_grad=True)
    forward_only("k", plain, None)
    with pytest.raises(RuntimeError, match="upsample_argmax: this CUDA kernel has no backward"):
        forward_only("upsample_argmax", plain, None, needs)
    with torch.no_grad():
        forward_only("k", needs)
    with torch.inference_mode():
        forward_only("k", needs)


LAUNCHERS = [("fused_mlp", "ln_mlp", "ln_mlp"),
             ("fused_attn", "attn_section", "attn_section"),
             ("fused_attn", "attn_section_v1", "attn_section_v1"),
             ("fused_attn", "swin_block", "swin_block"),
             ("fused_attn", "window_attention", "window_attention"),
             ("fused_bottleneck", "bottleneck_int8", "bottleneck_int8"),
             ("fused_bottleneck", "conv3_residual", "conv3_residual"),
             ("hg_attn", "_launch_hg", "hg_section"),
             ("hg_attn", "_launch_hg2", "hg2_section"),
             ("section_variants", "_launch", "section")]


@pytest.mark.parametrize("module,fn,op", LAUNCHERS, ids=[l[2] for l in LAUNCHERS])
def test_every_kernel_launcher_refuses_an_input_that_needs_grad(module, fn, op):
    """Each launcher (K1 and K3-K11; K2's guard sits in its dispatch, after the
    device test) runs the guard before anything else, so a tensor that
    requires grad raises, naming the op, before any check of the device."""
    import importlib
    import inspect

    launch = getattr(importlib.import_module(f"segland_tpu_torch.ops.{module}"), fn)
    n = sum(p.default is p.empty for p in inspect.signature(launch).parameters.values())
    x = torch.zeros(2, 49, 96, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"^{op}: this CUDA kernel has no backward"):
        launch(x, *[None] * (n - 1))
