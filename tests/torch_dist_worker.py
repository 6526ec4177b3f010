"""One rank of the two-process runs of tests/test_torch_dist.py (gloo on the
CPU): ``python tests/torch_dist_worker.py DIR`` with torchrun's environment.
It imports the port alone, reads the inputs the test wrote into DIR, runs
every scenario in turn and saves what it saw to DIR/rank<r>.pt:

  bn      ops.layers.batch_norm in train mode on this rank's rows: output,
          running statistics, the input's gradient and the parameters'
          gradients summed over the ranks;
  train   two base train steps of pspnet_pop (SGD, fp32), rank 0 saving an
          epoch_N.pth between them that both ranks resume from;
  ft      one fine-tune step;
  devaug  one base train step on raw uint8 tiles with --device-augment's
          augmentation;
  eval    cli.eval_base over the ranks (its outputs go to DIR/eval_ranks);
  int8    cli.eval_base --int8, abs-max and --calib-percentile 99.9, on the 5
          tiles (outputs to DIR/int8_<estimator>; the scales and the quantized
          layers' inputs of each calibration forward) and on 4 (full
          calibration batches; the scales);
  ft_eval cli.eval_ft with ft.pth (outputs to DIR/eval_ft_ranks);
  ensemble cli.ensemble_eval on the labelled tiles (outputs to DIR/ens_ranks):
          its result;
  export_error  cli.eval_base with rank 1's .mat writes raising: the error
          each rank raised and the export threads left alive.
"""

import contextlib
import copy
import functools
import os
import sys
import threading

import numpy as np
import torch

from segland_tpu_torch import dist
from segland_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from segland_tpu_torch.models import build_model
from segland_tpu_torch.ops.device_aug import base_train_augment
from segland_tpu_torch.ops.layers import batch_norm
from segland_tpu_torch.train import (TrainState, create_optimizer, ft_trainable,
                                     make_base_train_step, make_ft_train_step)

LR = dict(base_lr=1e-3, num_epochs=4, steps_per_epoch=1, optimizer="sgd")


def rows(a, n_local):
    lo, hi = dist.shard_rows(n_local)
    return torch.from_numpy(np.ascontiguousarray(a[lo:hi]))


def floats(ld):
    return {k: float(v) for k, v in ld.items()}


def bn(d):
    z = np.load(os.path.join(d, "bn.npz"))
    m = torch.nn.BatchNorm2d(z["weight"].shape[0], eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, name).copy_(torch.from_numpy(z[name]))
    n = z["x"].shape[0] // dist.world()
    x = rows(z["x"], n).requires_grad_(True)
    y = batch_norm(m, x)
    (y * rows(z["cot"], n)).sum().backward()
    grads = [dist.all_reduce_sum(p.grad.clone()) for p in (m.weight, m.bias)]
    return dict(y=y.detach(), x_grad=x.grad, mean=m.running_mean.clone(),
                var=m.running_var.clone(), weight_grad=grads[0], bias_grad=grads[1])


def loaded(path, **kw):
    """pspnet_pop / resnet10 with the weights in ``path``, built on the meta
    device (no init drawn) and given CPU storage for them."""
    with torch.device("meta"):
        model = build_model("pspnet_pop", "resnet10", n_base=7, device="meta", **kw)
    model = model.to_empty(device="cpu")
    model.load_state_dict(torch.load(path))
    return model


def base_model(d):
    return loaded(os.path.join(d, "base.pth"))


def train(d, model):
    z = np.load(os.path.join(d, "batches.npz"))
    n = z["img0"].shape[0] // dist.world()
    fresh = copy.deepcopy(model)
    state = TrainState(model, create_optimizer(model, **LR))
    ld0, gn0 = make_base_train_step(model, "orth")(state, rows(z["img0"], n),
                                                   rows(z["mask0"], n))
    state.epoch = 1
    save_checkpoint(os.path.join(d, "epoch_1.pth"), state)
    after0 = {k: v.clone() for k, v in model.state_dict().items()}
    # every rank resumes from rank 0's snapshot into a fresh model and optimizer
    resumed = TrainState(fresh, create_optimizer(fresh, **LR))
    load_checkpoint(os.path.join(d, "epoch_1.pth"), resumed)
    ld1, gn1 = make_base_train_step(fresh, "orth")(resumed, rows(z["img1"], n),
                                                   rows(z["mask1"], n))
    return dict(log=[(floats(ld0), float(gn0)), (floats(ld1), float(gn1))], after0=after0,
                after1=fresh.state_dict(), step=resumed.step, epoch=resumed.epoch)


def ft(d):
    z = np.load(os.path.join(d, "ft.npz"))
    model = loaded(os.path.join(d, "ft.pth"), n_novel=4, is_ft=True)
    state = TrainState(model, create_optimizer(model, trainable_fn=ft_trainable, **LR))
    n = z["img"].shape[0] // dist.world()
    ld, gn = make_ft_train_step(model, 7, skip_nonfinite=True)(
        state, *(rows(z[k], n) for k in ("img", "mask", "img_b", "mask_b")))
    return dict(ld=floats(ld), gn=float(gn),
                head={k: v for k, v in model.state_dict().items() if ft_trainable(k)})


def devaug(d, model):
    z = np.load(os.path.join(d, "tiles.npz"))
    n = z["img"].shape[0] // dist.world()
    state = TrainState(model, create_optimizer(model, **LR))
    step = make_base_train_step(model, "orth", seed=5, augment_fn=functools.partial(
        base_train_augment, crop_size=(32, 32)))
    ld, gn = step(state, rows(z["img"], n), rows(z["mask"], n))
    return dict(ld=floats(ld), gn=float(gn), after=model.state_dict())


def eval_args(d, out, ckpt="base.pth", lst="val.txt"):
    """cli.eval_base's arguments as tests/test_torch_dist.py runs it in one process."""
    return ["--data-dir", os.path.join(d, "data"), "--val-list",
            os.path.join(d, "data", "list", lst), "--model", "pspnet_pop", "--backbone",
            "resnet10", "--restore-from", os.path.join(d, ckpt), "--device", "cpu",
            "--base-size", "32,32", "--eval-batch", "2", "--num-workers", "0", "--save-path",
            os.path.join(d, out)]


def ensemble_args(d, out):
    """cli.ensemble_eval's, on the labelled tiles with base.pth as its member."""
    return ["--data-dir", os.path.join(d, "data"), "--val-list",
            os.path.join(d, "data", "list", "labelled.txt"), "--members",
            "pspnet_pop:resnet10:" + os.path.join(d, "base.pth"), "--device", "cpu",
            "--base-size", "32,32", "--eval-batch", "2", "--num-workers", "0", "--save-path",
            os.path.join(d, out)]


@contextlib.contextmanager
def layer_inputs(into):
    """Every quantized layer's input of the calibration forwards run while
    open, into ``into`` ({module name: input})."""
    from segland_tpu_torch.quant import ptq

    plain = ptq.quant_interceptor._layer

    def layer(self, name, m, x):
        if self.mode == "calibrate":
            into[name] = x.clone()
        return plain(self, name, m, x)

    ptq.quant_interceptor._layer = layer
    try:
        yield
    finally:
        ptq.quant_interceptor._layer = plain


def recorded_scales(fn):
    """fn() with cli.eval_base's Evaluator recorded: (the scales of the last one
    made, as floats; its calibration forwards' layer inputs, one dict a
    calibration batch, empty where this rank's share was)."""
    from segland_tpu_torch.cli import eval_base

    made = []

    class Recorded(eval_base.Evaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.calib_inputs = []
            made.append(self)

        def _calibrate(self, x):
            self.calib_inputs.append({})
            with layer_inputs(self.calib_inputs[-1]):
                super()._calibrate(x)

    plain, eval_base.Evaluator = eval_base.Evaluator, Recorded
    try:
        fn()
    finally:
        eval_base.Evaluator = plain
    return {k: float(v) for k, v in made[-1]._quant.items()}, made[-1].calib_inputs


INT8 = {"absmax": ["--int8"], "percentile": ["--int8", "--calib-percentile", "99.9"]}


def int8(d):
    from segland_tpu_torch.cli import eval_base

    out = {}
    for est, flags in INT8.items():
        out[est] = recorded_scales(lambda: eval_base.main(eval_args(d, f"int8_{est}") + flags))
        out[est + "_full"] = recorded_scales(lambda: eval_base.main(
            eval_args(d, f"int8_{est}_full", lst="val4.txt") + flags))[0]
    return out


def export_error(d):
    """cli.eval_base with rank 1's .mat writes raising: (the error's type and
    message, or None, the export threads alive after) a rank."""
    from segland_tpu_torch.cli import eval_base
    from segland_tpu_torch.data import tileio

    def refuse(path, probs):
        raise OSError(f"no room for {os.path.basename(path)}")

    plain = tileio.write_prob_mat
    if dist.rank() == 1:
        tileio.write_prob_mat = refuse
    try:
        eval_base.main(eval_args(d, "export_error"))
        err = None
    except Exception as e:
        err = (type(e).__name__, str(e))
    finally:
        tileio.write_prob_mat = plain
    alive = [t.name for t in threading.enumerate() if t.name.startswith("segland-export")]
    return err, alive


def main(d):
    from segland_tpu_torch.cli import ensemble_eval, eval_base, eval_ft

    dist.init_from_env("cpu")
    out = {"world": dist.world(), "bn": bn(d)}
    model = base_model(d)
    out["devaug"] = devaug(d, copy.deepcopy(model))
    out["train"] = train(d, model)
    out["ft"] = ft(d)
    eval_base.main(eval_args(d, "eval_ranks"))
    out["int8"] = int8(d)
    eval_ft.main(eval_args(d, "eval_ft_ranks", ckpt="ft.pth"))
    out["ensemble"] = ensemble_eval.main(ensemble_args(d, "ens_ranks"))
    out["export_error"] = export_error(d)
    torch.save(out, os.path.join(d, f"rank{dist.rank()}.pt"))
    dist.barrier()
    dist.destroy()


if __name__ == "__main__":
    torch.set_num_threads(1)  # as the test module runs (one_torch_thread)
    main(sys.argv[1])
