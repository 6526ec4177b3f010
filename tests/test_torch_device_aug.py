"""``ops/device_aug.py`` (--device-augment) against the JAX package's
``segland_tpu/ops/device_aug.py`` and the port's host pipeline
(``data/augment.py``): the checks of tests/test_device_aug.py, and the rows a
rank draws under a process group.  The draws come from torch generators, so
the stream differs from the JAX key's; a forced draw is bitwise equal."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import t
from segland_tpu.ops import device_aug as J
from segland_tpu_torch.data import augment as A
from segland_tpu_torch.ops import device_aug as D


def _tile(rs, h=40, w=40, ignore_frac=0.0):
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    lab = rs.randint(0, 12, (h, w)).astype(np.int32)
    if ignore_frac:
        lab[rs.rand(h, w) < ignore_frac] = A.IGNORE_LABEL
    return img, lab


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_fixed_draw_matches_jax_and_host_pipeline_bitwise():
    """For a forced (offset, flip, k) the output equals the JAX
    ``_augment_one_forced`` and the host chain bit for bit in float32."""
    rs = np.random.RandomState(7)
    img, lab = _tile(rs)
    crop = (16, 16)
    draws = [(0, 0, False, 0), (5, 9, True, 1), (24, 24, False, 2), (11, 3, True, 3)]
    got_i, got_l = D.augment_forced(t(np.stack([img] * 4)), t(np.stack([lab] * 4)), crop,
                                    [d[:2] for d in draws], [d[2] for d in draws],
                                    [d[3] for d in draws])
    assert got_i.dtype == torch.float32 and got_l.dtype == torch.int32
    for i, (oy, ox, flip, k) in enumerate(draws):
        hi, hl = A.pad(crop, img[oy:oy + crop[0], ox:ox + crop[1]],
                       lab[oy:oy + crop[0], ox:ox + crop[1]])
        if flip:
            hi, hl = np.flip(hi, 1), np.flip(hl, 1)
        hi, hl = np.rot90(hi, k, (0, 1)), np.rot90(hl, k, (0, 1))
        hi = A.normalize(hi, A.OEM_TRAIN_MEAN, A.OEM_TRAIN_STD)
        ji, jl = J._augment_one_forced(jnp.asarray(img), jnp.asarray(lab), crop, (oy, ox),
                                       flip, k)
        np.testing.assert_array_equal(got_l[i].numpy(), hl)
        np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(got_i[i].numpy(), hi)
        np.testing.assert_array_equal(got_i[i].numpy(), np.asarray(ji))


def test_batch_shapes_dtypes_and_determinism():
    rs = np.random.RandomState(1)
    tiles = [_tile(rs) for _ in range(4)]
    imgs, labs = t(np.stack([a for a, _ in tiles])), t(np.stack([b for _, b in tiles]))
    x1, y1, f1 = D.base_train_augment(_gen(3), imgs, labs, (16, 16))
    x2, y2, _ = D.base_train_augment(_gen(3), imgs, labs, (16, 16))
    assert x1.shape == (4, 16, 16, 3) and x1.dtype == torch.float32
    assert y1.shape == (4, 16, 16) and y1.dtype == torch.int32
    assert f1.shape == () and float(f1) == 0.0
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    x3, _, _ = D.base_train_augment(_gen(4), imgs, labs, (16, 16))
    assert not torch.equal(x1, x3)
    with pytest.raises(ValueError, match="square"):
        D.base_train_augment(_gen(3), imgs, labs, (16, 8))


def test_crop_retry_avoids_all_ignore_windows():
    """Only a left stripe is labelled: with 16 candidates nearly every drawn
    crop holds labelled pixels; a tile whose every candidate misses counts as
    a fallback."""
    h = w = 64
    lab = np.full((h, w), A.IGNORE_LABEL, np.int32)
    lab[:, :24] = 3
    img = np.zeros((h, w, 3), np.uint8)
    n_valid = fallbacks = 0
    for s in range(24):
        _, y, fb = D.base_train_augment(_gen(s), t(img[None]), t(lab[None]), (16, 16),
                                        retries=16)
        n_valid += int(bool((y != A.IGNORE_LABEL).any()))
        fallbacks += int(fb)
    assert n_valid >= 23 and fallbacks == 24 - n_valid
    one = np.full((h, w), A.IGNORE_LABEL, np.int32)
    one[63, 63] = 1  # one labelled pixel: one candidate in 49^2 finds it
    fb = sum(float(D.base_train_augment(_gen(s), t(img[None]), t(one[None]), (16, 16),
                                        retries=1)[2]) for s in range(8))
    assert fb >= 6


def test_all_ignore_tile_still_yields_a_crop():
    lab = np.full((32, 32), A.IGNORE_LABEL, np.int32)
    img = np.zeros((32, 32, 3), np.uint8)
    x, y, fb = D.base_train_augment(_gen(0), t(img[None]), t(lab[None]), (16, 16))
    assert x.shape == (1, 16, 16, 3)
    assert bool((y == A.IGNORE_LABEL).all()) and float(fb) == 0.0  # no labelled pixel: no fallback


def test_crop_larger_than_tile_pads_image_zero_label_ignore():
    rs = np.random.RandomState(2)
    img, lab = _tile(rs, 20, 20)
    lab[:] = 1
    x, y, _ = D.base_train_augment(_gen(5), t(img[None]), t(lab[None]), (32, 32))
    y = y[0].numpy()
    assert (y == A.IGNORE_LABEL).sum() == 32 * 32 - 20 * 20
    assert np.allclose(x[0].numpy()[y == A.IGNORE_LABEL], -1.0)  # (0/255 - .5) / .5


def test_distribution_of_flip_and_rot():
    """A marked corner pixel lands in each corner about a quarter of the time
    over 400 draws (flip p 0.5, k uniform)."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[0, 0] = 255
    lab = np.ones((8, 8), np.int32)
    corners = {(0, 0): 0, (0, 7): 0, (7, 7): 0, (7, 0): 0}
    x, _, _ = D.base_train_augment(_gen(9), t(np.stack([img] * 400)), t(np.stack([lab] * 400)),
                                   (8, 8))
    for xi in x[..., 0].numpy():
        pos = np.unravel_index(np.argmax(xi), xi.shape)
        corners[pos] += 1
    assert sum(corners.values()) == 400
    for c, n in corners.items():
        assert 50 <= n <= 150, (c, n, corners)


def test_ranks_take_their_rows_of_the_global_draw():
    """Under a process group a rank draws the global batch's draws and takes
    its rows: the two ranks' outputs are the rows of one process's."""
    rs = np.random.RandomState(3)
    tiles = [_tile(rs, ignore_frac=0.3) for _ in range(4)]
    imgs, labs = t(np.stack([a for a, _ in tiles])), t(np.stack([b for _, b in tiles]))
    x, y, fb = D.base_train_augment(_gen(11), imgs, labs, (24, 24))
    parts = [D.base_train_augment(_gen(11), imgs[2 * r:2 * r + 2], labs[2 * r:2 * r + 2],
                                  (24, 24), shard=(r, 2)) for r in range(2)]
    assert torch.equal(torch.cat([p[0] for p in parts]), x)
    assert torch.equal(torch.cat([p[1] for p in parts]), y)
    assert float(parts[0][2] + parts[1][2]) == float(fb)


def test_train_step_on_a_uint8_batch():
    """make_base_train_step(augment_fn=...) on raw uint8 tiles: the loss is
    finite, 'aug_fallback' reported, and the dropout stream is the one the
    step draws without augmentation (a stream of its own for the draws)."""
    from segland_tpu_torch.models import build_model
    from segland_tpu_torch.models.backbones.droppath import step_seed
    from segland_tpu_torch.train import TrainState, create_optimizer, make_base_train_step

    model = build_model("pspnet_pop", "resnet10", n_base=7, generator=_gen(0))
    state = TrainState(model, create_optimizer(model, 1e-3, 1, 2))
    step = make_base_train_step(model, augment_fn=functools.partial(
        D.base_train_augment, crop_size=(32, 32)))
    rs = np.random.RandomState(0)
    tiles = rs.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    labs = rs.randint(0, 8, (2, 48, 48)).astype(np.int32)
    ld, gn = step(state, t(tiles), t(labs))
    assert np.isfinite(float(ld["total_loss"])) and np.isfinite(float(gn))
    assert float(ld["aug_fallback"]) == 0.0 and state.step == 1
    assert D.aug_seed(0, 0) != step_seed(0, 0)
