"""Decoding: greedy CTC collapse, prefix beam search, LM shallow fusion."""

from turkish_asr_torch.decode.beam import CTCBeamDecoder, beam_search_batch
from turkish_asr_torch.decode.factory import DeviceBeamDecoder, FlashlightDecoder, create_decoder
from turkish_asr_torch.decode.greedy import GreedyDecoder, greedy_collapse_batch
from turkish_asr_torch.decode.lm import ArpaLanguageModel, KenLMModel, NGramLanguageModel

# The reference's export name for its beam decoder.
CTCDecoder = CTCBeamDecoder

__all__ = [
    "GreedyDecoder",
    "greedy_collapse_batch",
    "CTCBeamDecoder",
    "beam_search_batch",
    "DeviceBeamDecoder",
    "KenLMModel",
    "NGramLanguageModel",
    "ArpaLanguageModel",
    "create_decoder",
    "FlashlightDecoder",
    "CTCDecoder",
]
