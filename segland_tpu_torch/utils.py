"""Logging and experiment prep (reference utils/pyt_utils.py:28-76,
logger.py).  Own copy of segland_tpu/utils.py."""

import json
import logging
import os
import sys
import time
from datetime import datetime


def get_logger(name: str = "segland", log_dir: str | None = None, rank: int = 0) -> logging.Logger:
    """Rank-0 console+file logger; non-zero ranks log errors only."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir and rank == 0:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Experiment scalar writer, the analog of the tensorboardX ``SummaryWriter``
    the reference plumbs but ships disabled (utils/pyt_utils.py:71-75,
    train_base.py:139).  Scalars append to one JSONL file, a line each
    (``{"step": n, "tag": "...", "value": v, "time": unix}``), line buffered.
    On a rank other than 0 its methods do nothing."""

    def __init__(self, log_dir: str, rank: int = 0, filename: str = "metrics.jsonl"):
        self._f = None
        if rank == 0:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, filename), "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int):
        if self._f is not None:
            self._f.write(json.dumps({"step": int(step), "tag": tag, "value": float(value),
                                      "time": time.time()}) + "\n")

    def add_scalars(self, prefix: str, scalars: dict, step: int):
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}/{k}" if prefix else k, v, step)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def prep_experiment(snapshot_dir: str, argv=None, rank: int = 0, need_writer: bool = False):
    """Create the experiment dir, write argv to <date>.txt (reference
    prep_experiment, utils/pyt_utils.py:55-76) and return the logger, or
    ``(writer, logger)`` with ``need_writer``."""
    if rank == 0:
        os.makedirs(snapshot_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        with open(os.path.join(snapshot_dir, f"{stamp}.txt"), "w") as f:
            f.write(" ".join(argv or sys.argv) + "\n")
    logger = get_logger(log_dir=snapshot_dir, rank=rank)
    if need_writer:
        return MetricsWriter(snapshot_dir, rank=rank), logger
    return logger


def format_loss_dict(loss_dict, lr: float, grad_norm: float, prefix: str) -> str:
    s = f"{prefix} lr={lr:.2e} grad_norm={float(grad_norm):.4f}"
    for k, v in loss_dict.items():
        s += f" {k}={float(v):.4f}"
    return s
