"""The fine-tune CLI on the last registry models, on the CPU, on
tests/test_torch_ft_cli.py's tiles: ``pspplus_pop`` / ``resnet10``,
``lsk_pop`` / ``lsk-t`` and ``vggunet_pop`` fine-tune from a base ``.pth``
for an epoch (the frozen tensors bit-equal to the base's, the novel head
moved; ``best_123.pth`` through ``eval_ft``).  The plain ``pspnet`` has no
POP head: the JAX package's ft step cannot be built for it (its
``make_ft_train_step`` reads the model class's ``forward_novel``), and the
port's ``ft_pop`` refuses it with a ValueError; a fine-tuned plain pspnet
(``is_ft``: its ``classifier_n`` logits after the base ones) evaluates
through ``eval_ft``."""

import pytest
import torch

from test_torch_ft_cli import _args, root  # noqa: F401  (root is a fixture)
from segland_tpu_torch.ckpt import save_params
from segland_tpu_torch.cli import eval_ft, ft_pop
from segland_tpu_torch.models import build_model
from segland_tpu_torch.train import ft_trainable

NOVEL_HEAD = {"novel_emb", "classifier_n.0.weight", "classifier_n.2.weight",
              "classifier_n.4.weight"}


@pytest.mark.parametrize("name,backbone", [("pspplus_pop", "resnet10"), ("lsk_pop", "lsk-t"),
                                           ("vggunet_pop", "vgg16bn-unet")])
def test_fine_tunes_one_epoch(root, tmp_path, name, backbone):  # noqa: F811
    base_path = tmp_path / "base.pth"
    save_params(str(base_path), build_model(name, backbone, n_base=7,
                                            generator=torch.Generator().manual_seed(0)))
    snap = tmp_path / "snap"
    model = ["--model", name, "--backbone", backbone, "--restore-from", str(base_path),
             "--num-epoch", "1"]
    res = ft_pop.main(_args(root, snap) + model)
    assert set(res) == {123} and res[123]["epoch"] == 1
    base = torch.load(base_path, weights_only=False)
    best = torch.load(snap / "best_123.pth", weights_only=False)
    assert set(best) == set(base) | NOVEL_HEAD
    for k, v in base.items():
        assert torch.equal(best[k], v), k
    fresh = build_model(name, backbone, n_base=7, n_novel=4, is_ft=True,
                        generator=torch.Generator().manual_seed(123)).state_dict()
    for k in NOVEL_HEAD:
        assert ft_trainable(k)
        init = base[k.replace("classifier_n", "classifier")] if "classifier" in k else fresh[k]
        assert not torch.equal(best[k], init), k
    got = eval_ft.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                        "--model", name, "--backbone", backbone, "--device", "cpu",
                        "--restore-from", str(snap / "best.pth"), "--base-size", "48,48",
                        "--num-workers", "0", "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= got[123][2] <= 1.0


def test_plain_pspnet_does_not_fine_tune(root, tmp_path):  # noqa: F811
    """As in the JAX package, where the ft step reads ``forward_novel``."""
    from segland_tpu.models import build_model as j_build
    from segland_tpu.train.ft import make_ft_train_step as j_make_ft_step

    jm = j_build("pspnet", "resnet10", n_base=7, n_novel=4, is_ft=True)
    with pytest.raises(AttributeError, match="forward_novel"):
        j_make_ft_step(jm, 7)
    with pytest.raises(ValueError, match="forward_novel"):
        ft_pop.main(_args(root, tmp_path) + ["--model", "pspnet"])


def test_eval_ft_of_a_fine_tuned_plain_pspnet(root, tmp_path):  # noqa: F811
    """is_ft: 1 + 7 base and 4 novel logits from the two classifiers, 12
    classes scored; the file's keys load with nothing missing."""
    path = tmp_path / "pspnet_ft.pth"
    model = build_model("pspnet", "resnet10", n_base=7, n_novel=4, is_ft=True,
                        generator=torch.Generator().manual_seed(0))
    assert model.classifier_n.weight.shape == (4, 512, 1, 1) and not hasattr(model, "aux")
    save_params(str(path), model)
    with torch.no_grad():
        assert model(torch.randn(1, 3, 32, 32)).shape == (1, 12, 4, 4)
    got = eval_ft.main(["--data-dir", str(root), "--val-list", str(root / "list" / "val.txt"),
                        "--model", "pspnet", "--backbone", "resnet10", "--device", "cpu",
                        "--restore-from", str(path), "--base-size", "48,48", "--num-workers",
                        "0", "--save-path", str(tmp_path / "eval")])
    assert 0.0 <= got[123][0] <= 1.0 and 0.0 <= got[123][2] <= 1.0
