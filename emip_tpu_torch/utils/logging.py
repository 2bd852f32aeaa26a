"""File logging and the scalar sink of the training loops.

Counterpart of :mod:`emip_tpu.utils.logging`: :func:`setup_logging`
attaches a file handler (``train_log.log``, ``train_long_log.log``,
``train_static_log.log``) to the port's logger, and :class:`ScalarLogger`
appends one JSON record per scalar to ``scalars.jsonl`` under the JAX
package's tag names (``loss/loss``, ``val/MAE``, ``loss/long``,
``val_long/Sm``, ``loss/static``, ``time/epoch_s``, ...). Under data
parallelism the first rank alone writes them (``enabled``), as the JAX
package's process 0 does; TensorBoard events are not written.
"""

from __future__ import annotations

import json
import logging
import os
import time

__all__ = ["LOGGER_NAME", "setup_logging", "ScalarLogger"]

LOGGER_NAME = "emip_tpu_torch"


def setup_logging(save_path: str, filename: str = "train_log.log"
                  ) -> logging.Logger:
    """Point the port's logger (level INFO) at ``<save_path>/<filename>``.

    A file handler that an earlier call attached is closed and replaced,
    so a process that trains twice does not write the second run's lines
    into the first run's log.
    """
    os.makedirs(save_path, exist_ok=True)
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO)
    for h in [h for h in logger.handlers if getattr(h, "_emip_run", False)]:
        logger.removeHandler(h)
        h.close()
    handler = logging.FileHandler(os.path.join(save_path, filename),
                                  mode="a")
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s-%(filename)s-%(levelname)s:%(message)s]",
        datefmt="%Y-%m-%d %I:%M:%S %p"))
    handler._emip_run = True
    logger.addHandler(handler)
    return logger


class ScalarLogger:
    """Scalars as JSON lines ``{"tag", "value", "step", "time"}`` in
    ``<save_path>/scalars.jsonl`` (the JAX package's record); with
    ``enabled`` off (a rank other than the first) it writes nothing."""

    def __init__(self, save_path: str, enabled: bool = True):
        self._jsonl = None
        if enabled:
            os.makedirs(save_path, exist_ok=True)
            self._jsonl = open(os.path.join(save_path, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(dict(
            tag=tag, value=float(value), step=int(step),
            time=time.time())) + "\n")
        self._jsonl.flush()

    def scalars(self, tag_values: dict, step: int) -> None:
        for tag, value in tag_values.items():
            self.scalar(tag, value, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
