"""Base training (port of segland_tpu/train): the state, the optimizer and
the steps.  The fine-tune step is ROADMAP A5."""

from .state import TrainState, create_optimizer, param_labels, poly_lr_schedule
from .base import make_base_train_step, make_eval_step
