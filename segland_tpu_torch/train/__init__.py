"""Training (port of segland_tpu/train): the state, the optimizer, the base
step and the few-shot fine-tune step."""

from .state import TrainState, create_optimizer, param_labels, poly_lr_schedule
from .base import make_base_train_step, make_eval_step
from .ft import FT_FROZEN_PREFIXES, ft_trainable, init_cls_n, make_ft_train_step, pseudo_label
