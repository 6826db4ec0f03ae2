"""Logging: stdout and a file, in the reference's format.

Counterpart of turkish_asr_tpu/utils/logger.py (reference
utils/logger.py:5-36). The port's trainer passes a file inside its
checkpoint directory, so a run writes nothing outside the paths it is given.
"""

import logging
import sys


def get_logger(name, log_file="train.log"):
    """A logger writing to both stdout and ``log_file``.

    Idempotent: handlers are attached once per logger name.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        formatter = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        stream_handler = logging.StreamHandler(sys.stdout)
        stream_handler.setFormatter(formatter)
        logger.addHandler(stream_handler)
        file_handler = logging.FileHandler(log_file, mode="a", encoding="utf-8")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    return logger
