"""The host C++ library (``csrc/host/asr_native.cpp``, built with g++ at
first use): WAV and FLAC decoding, resampling and edit distance, each None
when the library is unavailable."""

from turkish_asr_torch.native.loader import (
    flac_decode_native,
    get_lib,
    levenshtein_native,
    native_available,
    resample_native,
    wav_decode_native,
)

__all__ = [
    "get_lib",
    "native_available",
    "wav_decode_native",
    "flac_decode_native",
    "resample_native",
    "levenshtein_native",
]
