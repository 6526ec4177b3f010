"""Logging (reference utils/pyt_utils.py:28-53).  Own copy of what the eval
entry points use from segland_tpu/utils.py."""

import logging
import os
import sys


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
