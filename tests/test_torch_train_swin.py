"""Base training of ``swin_pop`` in the port against the JAX package on the
CPU, fp32:

* the attention-section and whole-block autograd Functions
  (``ops/fused_attn.py:AttnSection``, ``SwinBlockFn``; their forwards the
  plain versions here, their backwards the stock-torch recompute) against
  ``jax.grad`` of the JAX references, every differentiable input (the
  rel-pos bias's included): each gradient within 2e-5 of its tensor's
  largest |value| (seen: 9.6e-7);
* the train-mode swin backbone by route (unfused, fused, whole-block,
  ``attn_group=2``), each against the JAX backbone's references: the
  gradients of one scalar loss at DropPath rate 0, and at rate 0.3 with the
  JAX modules' masks handed to the port's DropPaths, within 5e-5 of their
  tensor's largest |value| (seen: 1.8e-6), the outputs within the repo's
  5e-4 (seen: 3.8e-6); the window-resident switch stays off in train mode;
* the ``swin_pop`` step (narrow ``swin-t``, ``tests/ft_helpers.py``)
  against the JAX step over 3 steps, DropPath and dropout at rate 0 on both
  sides, one JAX run against the port fused and unfused, with the bars of
  ``tests/test_torch_train_step.py`` (seen: loss dicts 2.2e-7, grad norm
  4.2e-5, weights 6.0e-5 of their scale);
* ``cli.train_base`` on ``swin_pop`` end to end (narrow ``swin-t``,
  ``--fused``, DropPath at 0.2 and dropout at 0.1 live): snapshots,
  ``best.pth`` through ``eval_base``, and a run resumed from
  ``epoch_2.pth`` drawing the masks of the straight run, so that both end
  on bit-equal weights."""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft_helpers import narrow_backbones
from torch_helpers import inject_masks, load_port, one_torch_thread, random_variables, t
from train_helpers import batches, check_log, check_weights, port_pair
from segland_tpu.models import build_model as j_build
from segland_tpu.models import decoders as jdec
from segland_tpu.models.backbones import swin as jswin
from segland_tpu.models.backbones.droppath import DropPath as JDropPath
from segland_tpu.ops import pallas_attn as J
from segland_tpu.train import create_optimizer as j_create
from segland_tpu.train import create_train_state, make_base_train_step as j_make_step
from segland_tpu_torch.ckpt import from_jax_variables
from segland_tpu_torch.models import decoders as pdec
from segland_tpu_torch.models.backbones import swin as pswin
from segland_tpu_torch.ops import fused_attn as P

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WS, N = 7, 49
GRAD_TOL = 2e-5
NET_TOL = 5e-5
CFG = dict(depths=(2, 2), num_heads=(2, 4), embed_dim=32)
FUSED = dict(fused_mlp=True, fused_attn=True)
ROUTES = {"unfused": {}, "fused": FUSED, "fused_block": dict(fused_block_stages=(0, 1), **FUSED),
          "attn_group2": dict(attn_group=2, **FUSED)}
SECTION = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj", "bias")
BLOCK = SECTION + ("gamma2", "beta2", "w1", "b1", "w2", "b2")


def _inputs(seed, nw, c, nh):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    hid = 4 * c
    return dict(x=f(nw, N, c) * 0.5, gamma=rng.rand(c).astype(np.float32) + 0.5,
                beta=f(c) * 0.1, wqkv=f(c, 3 * c) * 0.1, bqkv=f(3 * c) * 0.1,
                wproj=f(c, c) * 0.1, bproj=f(c) * 0.1, bias=f(1, nh, N, N) * 0.3,
                gamma2=rng.rand(c).astype(np.float32) + 0.5, beta2=f(c) * 0.1,
                w1=f(c, hid) / c ** 0.5, b1=f(hid) * 0.1, w2=f(hid, c) / hid ** 0.5,
                b2=f(c) * 0.1)


def _check_grads(got, want, names, tol):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=name)


GEOMS = {"aligned-0": (14, 14, 14, 14, WS, 0), "aligned-3": (14, 14, 14, 14, WS, 3),
         "padded-0": (12, 9, 14, 14, WS, 0), "padded-3": (12, 9, 14, 14, WS, 3)}
CASES = ([(which, geom, 1) for which in ("section", "block") for geom in GEOMS]
         + [("section", "padded-3", 2)])  # the whole block has no super-window groups


@pytest.mark.parametrize("which,geom,group", CASES,
                         ids=[f"{w}-{g}" + ("-group2" if n == 2 else "") for w, g, n in CASES])
def test_function_gradients_match_jax(which, geom, group):
    """A batch of 2 maps (4 windows each), 2 heads at C = 64; ``group=2`` is
    K5's dispatch (no geom).  The cotangent is random."""
    geom = GEOMS[geom]
    h, w, hp, wp, ws, shift = geom
    c, nh = 64, 2
    nw = 2 * (hp // ws) * (wp // ws)
    a = _inputs(11 + shift + h, nw, c, nh)
    names = SECTION if which == "section" else BLOCK
    mask = jswin._pad_token_mask(*geom)
    regions = jswin._shift_regions(hp, wp, ws, shift) if shift else None
    cot = np.random.RandomState(5).randn(nw, N, c).astype(np.float32)

    jref = J.attn_section_reference if which == "section" else J.block_reference

    def loss(*args):
        out = jref(args[0], jnp.asarray(mask), *args[1:], nh,
                   regions=None if regions is None else jnp.asarray(regions))
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=tuple(range(len(names))))(*(jnp.asarray(a[k]) for k in names))
    ins = [t(a[k]).requires_grad_() for k in names]
    kw = dict(regions=None if regions is None else t(regions),
              geom=geom if group == 1 else None)
    if which == "section":
        out = P.swin_attn_section_fused(ins[0], t(mask), *ins[1:], nh, group=group, **kw)
        assert type(out.grad_fn).__name__ == "AttnSectionBackward"
    else:
        out = P.swin_block_fused(ins[0], t(mask), *ins[1:], nh, **kw)
        assert type(out.grad_fn).__name__ == "SwinBlockFnBackward"
    got = torch.autograd.grad((out * t(cot)).sum(), ins)
    _check_grads(got, want, names, GRAD_TOL)


def test_the_function_differentiates_through_the_models_views():
    """The block hands the section ``qkv.weight.T``, ``proj.weight.T`` and a
    cast of the gathered rel-pos table: their gradients reach the fp32
    parameters, the table's included, as autograd through the plain version
    gives them."""
    blk = pswin.SwinBlock(64, 2, shift_size=3, fused_attn=True)
    x = torch.randn(2, 12, 9, 64)
    grads = {}
    for fused in (True, False):
        blk.zero_grad()
        blk.fused_attn = fused
        if fused:
            out = blk(x)
        else:  # autograd through the plain version of the same section
            args, kw, _ = blk._section_args(x, 12, 9, 14, 14)
            wins = P.attn_section_reference(blk._windows(x, 2, 5), *args, 2, **kw)
            out = blk._unwindows(wins, 2, 12, 9, 14, 14)
            out = out + blk.mlp(torch.nn.functional.layer_norm(out, (64,), blk.norm2.weight,
                                                               blk.norm2.bias, 1e-5))
        out.square().sum().backward()
        grads[fused] = {n: p.grad.clone() for n, p in blk.named_parameters()}
    table = "attn.relative_position_bias_table"
    assert float(grads[True][table].abs().max()) > 0
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=0, atol=GRAD_TOL * float(g.abs().max()),
                                   msg=n)


class _RecordingDropPath(fnn.Module):
    """The JAX package's DropPath inside, recording which samples it kept."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, train: bool = False):
        y = JDropPath(self.rate, name="inner")(x, train)
        if train and self.rate > 0.0:
            self.sow("intermediates", "kept", jnp.any(y != 0, axis=tuple(range(1, x.ndim))))
        return y


def _jax_masks(rec, depths):
    """The recorded masks in the port's draw order: a block's drop_path1 then
    its drop_path2, blocks in forward order; a block at rate 0 draws none."""
    out = []
    for i, depth in enumerate(depths):
        for j in range(depth):
            for k in ("drop_path1", "drop_path2"):
                kept = rec.get(f"layers_{i}_blocks_{j}", {}).get(k)
                if kept is not None:
                    out.append(t(np.asarray(kept["kept"][0])).reshape(-1, 1, 1, 1))
    assert len(out) == 2 * (sum(depths) - 1)
    return out


@functools.lru_cache(maxsize=None)
def _jax_backbone(hw, rate):
    """The JAX side of ``_backbone_both``, once per (hw, rate) for every port
    route (the JAX package's routes all run its references on the CPU): the
    input, the loss's weights, the pyramid, the gradients by port name and the
    masks its DropPaths drew, in the port's draw order."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jswin, "DropPath", _RecordingDropPath)
        jm = jswin.SwinTransformer(drop_path_rate=rate, **CFG)
        x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
        v = random_variables(jm, jnp.zeros((1, *hw, 3)), seed=2)
        outs = jm.apply(v, jnp.asarray(x))
        rs = [np.random.RandomState(10 + i).randn(*o.shape).astype(np.float32)
              for i, o in enumerate(outs)]

        def loss(params):
            outs, rec = jm.apply({"params": params}, jnp.asarray(x), train=True,
                                 rngs={"dropout": jax.random.PRNGKey(9)},
                                 mutable=["intermediates"])
            return sum(jnp.sum(o * r) for o, r in zip(outs, rs)), (outs, rec)

        jgrads, (want, rec) = jax.jit(jax.grad(loss, has_aux=True))(v["params"])
    grads = {k[len("backbone."):]: w for k, w in from_jax_variables(
        {"params": {"backbone": jax.tree_util.tree_map(np.asarray, jgrads)}}).items()}
    masks = _jax_masks(rec["intermediates"], CFG["depths"]) if rate > 0 else []
    return x, v, rs, [np.asarray(w) for w in want], grads, masks


def _backbone_both(route, hw, rate, monkeypatch):
    """(port pyramid, JAX pyramid, port grads, JAX grads) of one scalar loss of
    the train-mode backbone; at ``rate`` > 0 the port draws the JAX masks."""
    x, v, rs, want, want_g, masks = _jax_backbone(hw, rate)
    queue = inject_masks(monkeypatch, masks)
    port = load_port(pswin.SwinTransformer(**CFG, drop_path_rate=rate, **ROUTES[route]),
                     {"params": {"backbone": v["params"]}}, prefix="backbone.").train()
    got = port(t(x).permute(0, 3, 1, 2))
    sum((g.permute(0, 2, 3, 1) * t(r)).sum() for g, r in zip(got, rs)).backward()
    assert not queue
    got_g = {n: p.grad for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    return got, want, got_g, want_g


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("hw", [(56, 56), (45, 30)], ids=["aligned", "padded"])
def test_train_mode_backbone_gradients_match_jax(route, hw, monkeypatch):
    """DropPath rate 0: each route's gradients; the fused routes through the
    Functions (a recompute a block in the backward, counted)."""
    calls = []
    recompute = P._recompute_grads
    monkeypatch.setattr(P, "_recompute_grads",
                        lambda ctx, n, *a: calls.append(n) or recompute(ctx, n, *a))
    got, want, got_g, want_g = _backbone_both(route, hw, 0.0, monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(), w, rtol=0,
                                   atol=5e-4)
    names = sorted(want_g)
    _check_grads([got_g[n] for n in names], [want_g[n] for n in names], names, NET_TOL)
    blocks = sum(CFG["depths"])
    assert calls == {"unfused": [], "fused": [8] * blocks, "fused_block": [14] * blocks,
                     "attn_group2": [8] * blocks}[route]


@pytest.mark.parametrize("route", ["unfused", "fused", "fused_block"])
def test_droppath_in_the_backbone_matches_jax_given_its_masks(route, monkeypatch):
    """Rate 0.3 over 4 blocks (0, 0.1, 0.2, 0.3), 45x30 (padded windows): the
    fused section route recovers each branch as (output - shortcut); the
    whole-block route falls back to the section and K1 where DropPath is
    active, as in the JAX package, and keeps the whole block at rate 0."""
    seen = []
    block_fused = pswin.swin_block_fused
    monkeypatch.setattr(pswin, "swin_block_fused", lambda *a, **k: seen.append(1) or
                        block_fused(*a, **k))
    got, want, got_g, want_g = _backbone_both(route, (45, 30), 0.3, monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(), w, rtol=0,
                                   atol=5e-4)
    names = sorted(want_g)
    _check_grads([got_g[n] for n in names], [want_g[n] for n in names], names, NET_TOL)
    assert len(seen) == (1 if route == "fused_block" else 0)  # the first block's rate is 0


def test_window_resident_stays_off_in_train_mode(monkeypatch):
    seen = []
    resident = pswin.SwinBlock._win_resident
    monkeypatch.setattr(pswin.SwinBlock, "_win_resident",
                        lambda self, *a: seen.append(1) or resident(self, *a))
    monkeypatch.setenv("SEGLAND_SWIN_WR", "1")
    model = pswin.SwinTransformer(**CFG, drop_path_rate=0.0, **FUSED).train()
    model(torch.zeros(1, 3, 40, 40))
    assert seen == []


# ---- the step -------------------------------------------------------------------------


def _rate_zero(monkeypatch):
    """DropPath and the decoder's dropout at rate 0 in both packages."""
    zeros = lambda rate, depths: [0.0] * sum(depths)
    monkeypatch.setattr(jswin, "drop_path_rates", zeros)
    monkeypatch.setattr(pswin, "drop_path_rates", zeros)
    proxy = types.ModuleType("nn")
    proxy.__getattr__ = lambda k: getattr(fnn, k)
    proxy.Dropout = lambda rate, **kw: fnn.Dropout(0.0, **kw)
    monkeypatch.setattr(jdec, "nn", proxy)
    monkeypatch.setattr(pdec.PSPModuleV2, "DROP", 0.0)


def test_swin_step_matches_jax_fused_and_unfused(monkeypatch):
    narrow_backbones(monkeypatch)
    _rate_zero(monkeypatch)
    jm = j_build("swin_pop", backbone="swin-t", n_base=7)
    v = random_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=1)
    kw = dict(base_lr=1e-3, num_epochs=4, steps_per_epoch=1, optimizer="sgd")
    jstate = create_train_state(jm, v, j_create(v["params"], **kw))
    jstep = jax.jit(j_make_step(jm, "orth", seed=3))
    data = batches(3, 32, seed=7)
    jlog = []
    for img, mask in data:
        jstate, jld, jgn = jstep(jstate, jnp.asarray(img), jnp.asarray(mask))
        jlog.append(({k: float(x) for k, x in jld.items()}, float(jgn)))
    for fused in (True, False):
        state, step = port_pair("swin_pop", "swin-t", v, "sgd", fused, seed=3)
        log = []
        for (img, mask), (jld, jgn) in zip(data, jlog):
            ld, gn = step(state, t(img), t(mask))
            log.append((jld, jgn, {k: float(x) for k, x in ld.items()}, float(gn)))
        check_log(log, 1e-5, 5e-3)
        check_weights(jstate, state.model, 5e-4)
        assert state.step == 3


# ---- the entry point ------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Four 40x40 tiles, labels following the image; two train (one step an
    epoch at batch 2), two validate."""
    from segland_tpu_torch.data.geotiff import write_tiff

    root = tmp_path_factory.mktemp("oem_swin")
    for d in ("images", "labels", "list"):
        (root / d).mkdir()
    rng = np.random.RandomState(8)
    ids = [f"tile_{i}" for i in range(4)]
    for tid in ids:
        img = rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
        lab = (img[..., 0] // 32).astype(np.uint8)
        lab[:2] = 255
        write_tiff(str(root / "images" / f"{tid}.tif"), img)
        write_tiff(str(root / "labels" / f"{tid}.tif"), lab)
    (root / "list" / "train.txt").write_text("\n".join(ids[:2]) + "\n")
    (root / "list" / "val.txt").write_text("\n".join(ids[2:]) + "\n")
    return root


def _args(root, snap, *extra):
    return ["--data-dir", str(root), "--train-list", str(root / "list" / "train.txt"),
            "--val-list", str(root / "list" / "val.txt"), "--model", "swin_pop",
            "--backbone", "swin-t", "--device", "cpu", "--fused", "--input-size", "32,32",
            "--base-size", "40,40", "--batch-size", "2", "--num-epoch", "3",
            "--snapshot-frequency", "1", "--val-start", "0", "--val-frequency", "1",
            "--print-frequency", "1", "--num-workers", "0", "--snapshot-dir", str(snap), *extra]


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        narrow_backbones(mp)
        from segland_tpu_torch.cli import train_base

        snap = tmp_path_factory.mktemp("snap_swin")
        best = train_base.main(_args(root, snap))
        resumed = tmp_path_factory.mktemp("snap_swin_resumed")
        train_base.main(_args(root, resumed, "--resume-from", str(snap / "epoch_2.pth")))
    return snap, resumed, best


def test_train_base_trains_swin_pop(root, trained, tmp_path, monkeypatch):
    from segland_tpu_torch.cli import eval_base

    snap, _, best = trained
    for name in ("epoch_1.pth", "epoch_2.pth", "epoch_3.pth", "best.pth"):
        assert (snap / name).exists(), name
    assert 0.0 <= best <= 1.0
    start = torch.load(snap / "epoch_1.pth", weights_only=False)["state_dict"]
    end = torch.load(snap / "epoch_3.pth", weights_only=False)["state_dict"]
    table = "backbone.layers.0.blocks.1.attn.relative_position_bias_table"
    assert not torch.equal(start[table], end[table])  # the bias gradient trains it
    narrow_backbones(monkeypatch)
    res = eval_base.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                          "--model", "swin_pop", "--backbone", "swin-t", "--fused",
                          "--restore-from", str(snap / "best.pth"), "--device", "cpu",
                          "--base-size", "40,40", "--num-workers", "0",
                          "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= res[123][2] <= 1.0


def test_a_resumed_run_draws_the_same_masks(trained):
    """DropPath and dropout are live (rate 0.2 at the last block, 0.1): the
    resumed run's third step draws from (seed, step 2) as the straight run's
    did, so the weights end bit-equal; a run drawing other masks would not."""
    snap, resumed, _ = trained
    want = torch.load(snap / "epoch_3.pth", weights_only=False)
    got = torch.load(resumed / "epoch_3.pth", weights_only=False)
    assert got["epoch"] == 3 and got["optimizer"]["count"] == want["optimizer"]["count"] == 3
    for k, v in want["state_dict"].items():
        torch.testing.assert_close(got["state_dict"][k], v, rtol=0, atol=0, msg=k)
