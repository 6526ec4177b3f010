"""The port over two processes (gloo on the CPU, ``tests/torch_dist_worker.py``)
against one process on the global batch, and the train step against the JAX
step with the batch sharded over a 2-device data mesh
(``segland_tpu/dist/mesh.py``).

One pair of worker processes runs every scenario (module fixture, a hard
time limit: a hung rendezvous kills the pair and fails).  The global batch
is 4 (2 a rank) of 32^2 crops, pspnet_pop / resnet10 in fp32 with SGD; rank
0's rows have 60% of their pixels ignored and rank 1's almost none, so a
per-rank mean CE would weight the ranks wrongly (``losses.py``).

Bars: the ranks agree with each other exactly (the gradients are all-reduced
before anyone reads them); against one process 1e-5 (loss dicts relative,
weights of each tensor's largest |value|; the grad norm GRAD_NORM_RTOL): the
sums run in another order.  Against JAX the bars of
tests/test_torch_train_step.py."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import load_port, meta_build, one_torch_thread, random_variables, t
from train_helpers import check_log, check_weights
from segland_tpu_torch.data.geotiff import write_tiff

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
TIME_LIMIT = 180  # seconds for the pair of workers
# The grad norm against one process: a ReLU whose input lies within rounding of 0
# takes the other branch when the sums run in another order (test_torch_train_step.py),
# and the norm moves with it: permuting the rows within the two ranks moves the
# two-rank norm of the first step by 1.8e-5 (seen), as far as the ranks are from one
# process (2.2e-5).  The loss dicts and the weights stay within 1e-5.
GRAD_NORM_RTOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _uneven_batch(rng):
    img = rng.randn(4, HW, HW, 3).astype(np.float32)
    mask = rng.randint(0, 8, (4, HW, HW)).astype(np.int32)
    mask[:2][rng.rand(2, HW, HW) < 0.6] = 255  # rank 0's rows: 60% ignored
    mask[2:, :1] = 255
    return img, mask


def _write_inputs(d):
    """The scenarios' inputs: weights from numpy through the JAX variable
    tree, batches, raw tiles and an eval data dir of 5 tiles (2 unlabelled,
    which eval_base exports)."""
    from segland_tpu.models import build_model as j_build
    from segland_tpu_torch.models import build_model

    jm = j_build("pspnet_pop", backbone="resnet10", n_base=7)
    v = random_variables(jm, jnp.zeros((1, HW, HW, 3)), seed=1)
    model = load_port(meta_build(build_model, "pspnet_pop", "resnet10", n_base=7), v)
    torch.save(model.state_dict(), os.path.join(d, "base.pth"))
    jft = j_build("pspnet_pop", backbone="resnet10", n_base=7, n_novel=4, is_ft=True)
    vft = random_variables(jft, jnp.zeros((1, HW, HW, 3)), seed=2)
    ft_model = load_port(meta_build(build_model, "pspnet_pop", "resnet10", n_base=7, n_novel=4,
                                    is_ft=True),
                         vft)
    torch.save(ft_model.state_dict(), os.path.join(d, "ft.pth"))
    rng = np.random.RandomState(0)
    (img0, mask0), (img1, mask1) = _uneven_batch(rng), _uneven_batch(rng)
    np.savez(os.path.join(d, "batches.npz"), img0=img0, mask0=mask0, img1=img1, mask1=mask1)
    np.savez(os.path.join(d, "bn.npz"), x=(2.0 + 3.0 * rng.randn(4, 6, 5, 5)).astype(np.float32),
             cot=rng.randn(4, 6, 5, 5).astype(np.float32),
             weight=rng.uniform(0.5, 1.5, 6).astype(np.float32),
             bias=rng.randn(6).astype(np.float32),
             running_mean=rng.randn(6).astype(np.float32),
             running_var=rng.uniform(0.5, 1.5, 6).astype(np.float32))
    mask_b = rng.randint(0, 8, (2, HW, HW)).astype(np.int32)
    mask_b[0, :8] = 0
    np.savez(os.path.join(d, "ft.npz"), img=rng.randn(2, HW, HW, 3).astype(np.float32),
             mask=rng.randint(0, 2, (2, HW, HW)).astype(np.int32),
             img_b=rng.randn(2, HW, HW, 3).astype(np.float32), mask_b=mask_b)
    lab = rng.randint(0, 8, (4, 40, 40)).astype(np.int32)
    lab[0, :, :30] = 255
    np.savez(os.path.join(d, "tiles.npz"), img=rng.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8),
             mask=lab)
    data = os.path.join(d, "data")
    for sub in ("images", "labels", "list"):
        os.makedirs(os.path.join(data, sub))
    ids = [f"t{i}" for i in range(5)]
    for i, tid in enumerate(ids):
        write_tiff(os.path.join(data, "images", tid + ".tif"),
                   rng.randint(0, 256, (HW, HW, 3)).astype(np.uint8))
        if i >= 2:
            write_tiff(os.path.join(data, "labels", tid + ".tif"),
                       rng.randint(0, 12, (HW, HW)).astype(np.uint8))
    for name, some in (("val.txt", ids), ("val4.txt", ids[:4]), ("labelled.txt", ids[2:])):
        with open(os.path.join(data, "list", name), "w") as f:
            f.write("\n".join(some) + "\n")
    return v, vft


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(dir, [rank 0's results, rank 1's], the JAX variables of base.pth and
    ft.pth): the pair of workers run to their end within TIME_LIMIT."""
    d = str(tmp_path_factory.mktemp("dist"))
    variables = _write_inputs(d)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"), d], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIME_LIMIT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the two ranks did not end within {TIME_LIMIT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    out = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    assert [o["world"] for o in out] == [2, 2]
    return d, out, variables


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _same_state(a, b, tol=1e-5):
    assert set(a) == set(b)
    for k in a:
        if not k.endswith("num_batches_tracked"):
            _close(a[k].numpy(), b[k].numpy(), tol)


def _port_state(d, name="base.pth", **kw):
    """The port in one process: the model of ``name`` and its SGD state."""
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.train import TrainState, create_optimizer, ft_trainable

    model = meta_build(build_model, "pspnet_pop", "resnet10", n_base=7, **kw)
    model.load_state_dict(torch.load(os.path.join(d, name)))
    return model, TrainState(model, create_optimizer(
        model, base_lr=1e-3, num_epochs=4, steps_per_epoch=1, optimizer="sgd",
        trainable_fn=ft_trainable if kw.get("is_ft") else None))


def test_batch_norm_over_processes_equals_one_process(ranks):
    """Output, running statistics and gradients (input and parameters) of the
    cross-process batch_norm equal one process on the concatenated batch."""
    from segland_tpu_torch.ops.layers import batch_norm

    d, out, _ = ranks
    z = np.load(os.path.join(d, "bn.npz"))
    m = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, name).copy_(t(z[name]))
    x = t(z["x"]).requires_grad_(True)
    y = batch_norm(m, x)
    (y * t(z["cot"])).sum().backward()
    for r, o in enumerate(o["bn"] for o in out):
        rows = slice(2 * r, 2 * r + 2)
        _close(o["y"].numpy(), y.detach()[rows].numpy(), 1e-6)
        _close(o["x_grad"].numpy(), x.grad[rows].numpy(), 1e-5)
        _close(o["mean"].numpy(), m.running_mean.numpy(), 1e-6)
        _close(o["var"].numpy(), m.running_var.numpy(), 1e-6)
        _close(o["weight_grad"].numpy(), m.weight.grad.numpy(), 1e-5)
        _close(o["bias_grad"].numpy(), m.bias.grad.numpy(), 1e-5)


def test_train_steps_over_processes_match_one_process_and_jax(ranks):
    """Two steps (the second after both ranks resumed from rank 0's
    epoch_1.pth): the ranks agree exactly, match the port in one process
    within 1e-5 and the JAX step over a 2-device data mesh within
    test_torch_train_step.py's bars."""
    from segland_tpu.dist import make_mesh, replicate, shard_batch
    from segland_tpu.models import build_model as j_build
    from segland_tpu.train import create_optimizer as j_create, create_train_state
    from segland_tpu.train import make_base_train_step as j_make_step
    from segland_tpu_torch.train import make_base_train_step

    d, out, (v, _) = ranks
    a, b = out[0]["train"], out[1]["train"]
    assert a["log"] == b["log"]
    for k in a["after1"]:
        assert torch.equal(a["after1"][k], b["after1"][k]), k
    assert a["step"] == b["step"] == 2 and a["epoch"] == 1
    z = np.load(os.path.join(d, "batches.npz"))
    model, state = _port_state(d)
    step = make_base_train_step(model, "orth")
    mesh = make_mesh(2)
    jm = j_build("pspnet_pop", backbone="resnet10", n_base=7)
    jstate = replicate(mesh, create_train_state(jm, v, j_create(
        v["params"], base_lr=1e-3, num_epochs=4, steps_per_epoch=1, optimizer="sgd")))
    jstep = jax.jit(j_make_step(jm, "orth"))
    jlog = []
    for i in range(2):
        img, mask = z[f"img{i}"], z[f"mask{i}"]
        ld, gn = step(state, t(img), t(mask))
        for key in ld:
            np.testing.assert_allclose(a["log"][i][0][key], float(ld[key]), rtol=1e-5)
        np.testing.assert_allclose(a["log"][i][1], float(gn), rtol=GRAD_NORM_RTOL)
        _same_state(a["after0" if i == 0 else "after1"], model.state_dict())
        jstate, jld, jgn = jstep(jstate, *shard_batch(mesh, (jnp.asarray(img), jnp.asarray(mask))))
        jlog.append(({k: float(x) for k, x in jld.items()}, float(jgn)) + a["log"][i])
    check_log(jlog, 1e-5, 5e-3)
    check_weights(jstate, _load(a["after1"]), 5e-4)


def _load(sd):
    from segland_tpu_torch.models import build_model

    model = meta_build(build_model, "pspnet_pop", "resnet10", n_base=7)
    model.load_state_dict(sd)
    return model


def test_the_loss_is_the_global_batch_mean(ranks):
    """With rank 0's rows 60% ignored, the reported seg loss is the global
    pixel mean: it equals one process's, not the mean of the two ranks'
    means (which the ignored pixels would pull away from it)."""
    from segland_tpu_torch.losses import cross_entropy
    from segland_tpu_torch.ops.resize import resize_bilinear

    d, out, _ = ranks
    z = np.load(os.path.join(d, "batches.npz"))
    model, _ = _port_state(d)
    model.train()
    with torch.no_grad():
        logits, _ = model.forward_base(t(z["img0"]).permute(0, 3, 1, 2), train=True)
        up = resize_bilinear(logits.permute(0, 2, 3, 1), (HW, HW), align_corners=True)
    mask = t(z["mask0"])
    whole = float(cross_entropy(up, mask))
    halves = [float(cross_entropy(up[r:r + 2], mask[r:r + 2])) for r in (0, 2)]
    got = out[0]["train"]["log"][0][0]["seg_loss"]
    assert abs(got - whole) <= 1e-6 * whole < abs(np.mean(halves) - whole) / 10


def test_ft_step_over_processes_matches_one_process(ranks):
    from segland_tpu_torch.train import ft_trainable, make_ft_train_step

    d, out, _ = ranks
    a, b = out[0]["ft"], out[1]["ft"]
    assert a["ld"] == b["ld"] and a["gn"] == b["gn"]
    z = np.load(os.path.join(d, "ft.npz"))
    model, state = _port_state(d, "ft.pth", n_novel=4, is_ft=True)
    ld, gn = make_ft_train_step(model, 7, skip_nonfinite=True)(
        state, *(t(z[k]) for k in ("img", "mask", "img_b", "mask_b")))
    for key in ld:
        np.testing.assert_allclose(a["ld"][key], float(ld[key]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(a["gn"], float(gn), rtol=1e-5)
    head = {k: v for k, v in model.state_dict().items() if ft_trainable(k)}
    _same_state(a["head"], head)
    for k in head:
        assert torch.equal(a["head"][k], b["head"][k]), k


def test_device_augment_step_over_processes_matches_one_process(ranks):
    """Each rank draws the global batch's crops, flips and rotations and takes
    its rows: the step equals one process's on the whole uint8 batch."""
    import functools

    from segland_tpu_torch.ops.device_aug import base_train_augment
    from segland_tpu_torch.train import make_base_train_step

    d, out, _ = ranks
    a, b = out[0]["devaug"], out[1]["devaug"]
    assert a["ld"] == b["ld"]
    z = np.load(os.path.join(d, "tiles.npz"))
    model, state = _port_state(d)
    step = make_base_train_step(model, "orth", seed=5, augment_fn=functools.partial(
        base_train_augment, crop_size=(32, 32)))
    ld, gn = step(state, t(z["img"]), t(z["mask"]))
    assert set(ld) == set(a["ld"]) and "aug_fallback" in ld
    for key in ld:
        np.testing.assert_allclose(a["ld"][key], float(ld[key]), rtol=1e-5)
    np.testing.assert_allclose(a["gn"], float(gn), rtol=GRAD_NORM_RTOL)
    _same_state(a["after"], model.state_dict())


def test_eval_over_processes_equals_one_process(ranks):
    """cli.eval_base over two ranks on 5 tiles in batches of 2 (the last
    batch leaves rank 1 nothing): the confusion matrix rank 0 saved, and each
    unlabelled tile's GTiff and .mat export, equal one process's."""
    from segland_tpu_torch.cli import eval_base
    from segland_tpu_torch.data.tileio import read_label

    d, _, _ = ranks
    one = os.path.join(d, "eval_one")
    eval_base.main(["--data-dir", os.path.join(d, "data"), "--val-list",
                    os.path.join(d, "data", "list", "val.txt"), "--model", "pspnet_pop",
                    "--backbone", "resnet10", "--restore-from", os.path.join(d, "base.pth"),
                    "--device", "cpu", "--base-size", "32,32", "--eval-batch", "2",
                    "--num-workers", "0", "--save-path", one])
    two = os.path.join(d, "eval_ranks")
    cm = np.load(os.path.join(two, "cmatrix_123.npy"))
    np.testing.assert_array_equal(cm, np.load(os.path.join(one, "cmatrix_123.npy")))
    assert cm.sum() == 3 * HW * HW
    from scipy.io import loadmat

    for tid in ("t0", "t1"):
        np.testing.assert_array_equal(read_label(os.path.join(two, tid + ".tif")),
                                      read_label(os.path.join(one, tid + ".tif")))
        got, want = (loadmat(os.path.join(p, "prob", tid + ".mat")) for p in (two, one))
        key = [k for k in want if not k.startswith("__")][0]
        _close(got[key], want[key], 1e-5)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))


def _one_process(d, out, **kw):
    """cli.eval_base in this process as the ranks ran it: the scales of its
    Evaluator (int8 flags in ``flags``)."""
    from torch_dist_worker import eval_args, recorded_scales
    from segland_tpu_torch.cli import eval_base

    flags = kw.pop("flags", [])
    return recorded_scales(lambda: eval_base.main(eval_args(d, out, **kw) + flags))[0]


def _same_scales(got, want, rtol=1e-6):
    assert set(got) == set(want) and len(want) == 22
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)


def _global_batch_scales(inputs, estimator):
    """One process's running scales over calibration batches whose layer inputs
    are the ranks' ``inputs`` (per rank, one {name: input} a batch) joined in
    rank order: each estimate is the port's one-process code on the global
    batch's rows."""
    from segland_tpu_torch.quant import QuantConfig, quant_interceptor

    one = quant_interceptor(None, "calibrate", QuantConfig(act_estimator=estimator), {})
    scales = {}
    for batch in zip(*inputs):
        for name in batch[0]:
            rows = torch.cat([r[name] for r in batch if name in r])
            est = float(one._estimate(rows, rows.dim() == 4))
            scales[name] = max(scales.get(name, est), est)
    return scales


@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_int8_eval_over_processes_equals_one_process(ranks, estimator):
    """cli.eval_base --int8 over two ranks on 5 tiles in batches of 2: the last
    calibration batch leaves rank 1 no rows, and it still takes part in the
    calibration's collectives (else rank 0 would wait for it).  Both ranks
    hold the same scales: bit for bit what one process's calibration gives on
    the global batches of the activations the ranks computed; within 1e-5 of
    cli.eval_base in one process at the global batch (seen: 10 of 22 part, by
    at most 9.6e-7), whose fp32 convs round otherwise at a batch of 2.  The
    confusion matrix and the GTiffs are one process's but where int8 carries
    those roundings into a pixel's class (seen: 7 and 20 of 3,072 pixels, on
    random weights whose classes lie close): at most 1% of the pixels."""
    from torch_dist_worker import INT8
    from segland_tpu_torch.data.tileio import read_label

    d, out, _ = ranks
    (a, inputs0), (b, inputs1) = (o["int8"][estimator] for o in out)
    assert a == b and len(inputs0) == len(inputs1) == 3 and inputs1[-1] == {}
    assert a == _global_batch_scales([inputs0, inputs1], estimator)
    _same_scales(a, _one_process(d, f"int8_{estimator}_one", flags=INT8[estimator]), 1e-5)
    two, one = (os.path.join(d, f"int8_{estimator}{x}") for x in ("", "_one"))
    cm2, cm1 = (np.load(os.path.join(p, "cmatrix_123.npy")) for p in (two, one))
    assert cm2.sum() == cm1.sum() == 3 * HW * HW
    assert np.abs(cm2 - cm1).sum() / 2 <= 0.01 * cm1.sum()
    for tid in ("t0", "t1"):
        p2, p1 = (read_label(os.path.join(p, tid + ".tif")) for p in (two, one))
        assert (p2 != p1).mean() <= 0.01


@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_int8_over_processes_matches_the_jax_mesh(ranks, estimator):
    """On 4 tiles (full calibration batches: the JAX mesh pads none) the
    ranks' scales equal the JAX Evaluator's (int8) over a 2-device CPU mesh,
    which calibrates on each global batch, at test_torch_quant.py's bar."""
    from segland_tpu.data import Loader as JLoader, OEMValDataset as JValDataset
    from segland_tpu.dist import make_mesh
    from segland_tpu.evallib import Evaluator as JEvaluator
    from segland_tpu.models import build_model as j_build
    from segland_tpu.quant import QuantConfig as JQuantConfig
    from segland_tpu_torch.ckpt import quant_from_jax

    d, out, (v, _) = ranks
    data = os.path.join(d, "data")
    ev = JEvaluator(j_build("pspnet_pop", backbone="resnet10", n_base=7), v, num_classes=12,
                    mesh=make_mesh(2), int8=True, fused_epilogue=False,
                    quant_cfg=JQuantConfig(act_estimator=estimator))
    ev.run(JLoader(JValDataset(data, os.path.join(data, "list", "val4.txt"), base_size=(HW, HW),
                               use_novel=True, use_base=True), 2, shuffle=False))
    want = {k: float(a) for k, a in quant_from_jax(jax.tree_util.tree_map(
        np.asarray, ev._quant)).items()}
    for o in out:
        _same_scales(o["int8"][estimator + "_full"], want)


def test_eval_ft_over_processes_equals_one_process(ranks):
    """cli.eval_ft over the two ranks: the confusion matrix and the GTiffs of
    the unlabelled tiles equal one process's."""
    from torch_dist_worker import eval_args
    from segland_tpu_torch.cli import eval_ft
    from segland_tpu_torch.data.tileio import read_label

    d, _, _ = ranks
    eval_ft.main(eval_args(d, "eval_ft_one", ckpt="ft.pth"))
    two, one = (os.path.join(d, f"eval_ft_{x}") for x in ("ranks", "one"))
    cm = np.load(os.path.join(two, "cmatrix_123.npy"))
    np.testing.assert_array_equal(cm, np.load(os.path.join(one, "cmatrix_123.npy")))
    assert cm.sum() == 3 * HW * HW
    for tid in ("t0", "t1"):
        np.testing.assert_array_equal(read_label(os.path.join(two, tid + ".tif")),
                                      read_label(os.path.join(one, tid + ".tif")))
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))  # no .mat from eval_ft


def test_ensemble_eval_over_processes_equals_one_process(ranks):
    """cli.ensemble_eval over the two ranks on the 3 labelled tiles (the last
    batch leaves rank 1 nothing): every rank's mIoU and rank 0's confusion
    matrix equal one process's."""
    from torch_dist_worker import ensemble_args
    from segland_tpu_torch.cli import ensemble_eval

    d, out, _ = ranks
    want = ensemble_eval.main(ensemble_args(d, "ens_one"))
    for o in out:
        assert {k: o["ensemble"][k] for k in ("base", "novel", "total")} == {
            k: want[k] for k in ("base", "novel", "total")}
    cm = np.load(os.path.join(d, "ens_ranks", "cmatrix_ensemble.npy"))
    np.testing.assert_array_equal(cm, np.load(os.path.join(d, "ens_one", "cmatrix_ensemble.npy")))
    assert cm.sum() == 3 * HW * HW


def test_an_export_error_on_one_rank_ends_both(ranks):
    """Rank 1's .mat write raises: rank 1 raises that error and rank 0 an error
    naming the failed rank, both after the confusion matrices' all-reduce (the
    pair ended within its time limit: no rank was left in a collective), and
    neither leaves an export thread behind."""
    _, out, _ = ranks
    (err0, alive0), (err1, alive1) = (o["export_error"] for o in out)
    assert err1 == ("OSError", "no room for t1.mat")
    assert err0 == ("RuntimeError", "the exports of 1 of 2 ranks failed")
    assert alive0 == alive1 == []
