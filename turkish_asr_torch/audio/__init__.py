"""Host audio I/O (copied from the JAX package), the log-mel front-end and
``AudioPreprocessor``, and the augmentation."""

from turkish_asr_torch.audio.augment import NoisePerturbation, SpecAugment, SpeedPerturbation
from turkish_asr_torch.audio.features import AudioPreprocessor, log_mel_spectrogram, mel_filterbank
from turkish_asr_torch.audio.wavio import (
    TARGET_SAMPLE_RATE,
    load_audio,
    read_wav,
    resample,
    write_wav,
)

__all__ = [
    "load_audio",
    "read_wav",
    "write_wav",
    "resample",
    "AudioPreprocessor",
    "mel_filterbank",
    "log_mel_spectrogram",
    "TARGET_SAMPLE_RATE",
    "SpecAugment",
    "SpeedPerturbation",
    "NoisePerturbation",
]
