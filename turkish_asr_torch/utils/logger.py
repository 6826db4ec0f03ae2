"""Logging: stdout and a file, in the reference's format.

Counterpart of turkish_asr_tpu/utils/logger.py (reference
utils/logger.py:5-36). The port's trainer passes a file inside its
checkpoint directory, so a run writes nothing outside the paths it is given.
"""

import logging
import os
import sys

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name, log_file="train.log"):
    """A logger writing to both stdout and ``log_file`` (stdout alone for
    None).

    The stdout handler is attached once per logger name. The file handler
    follows ``log_file``: a later run in the same process (another
    ``--checkpoint_dir``) logs into its own directory, not the first run's.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(_FORMAT)
    if not logger.handlers:
        stream_handler = logging.StreamHandler(sys.stdout)
        stream_handler.setFormatter(formatter)
        logger.addHandler(stream_handler)
    want = None if log_file is None else os.path.abspath(log_file)
    for handler in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if handler.baseFilename != want:
            logger.removeHandler(handler)
            handler.close()
    if want is not None and not any(isinstance(h, logging.FileHandler)
                                    for h in logger.handlers):
        file_handler = logging.FileHandler(want, mode="a", encoding="utf-8")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    return logger
