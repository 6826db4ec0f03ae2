"""Config, logging, metrics, the weight bridge, device checks and shared
error types."""

from turkish_asr_torch.utils.config import get_config
from turkish_asr_torch.utils.logger import get_logger

__all__ = [
    "get_config",
    "get_logger",
]
