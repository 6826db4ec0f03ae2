"""Tokenizers (copied from the JAX package), the data pipeline and the static
waveform buckets."""

from turkish_asr_torch.data.buckets import bucket_table
from turkish_asr_torch.data.dataset import (
    ASRDataset,
    BucketingSampler,
    PrefetchLoader,
    collate_batch,
    create_datasets,
    find_files,
)
from turkish_asr_torch.data.tokenizer import CharTokenizer, TurkishTokenizer

__all__ = [
    "TurkishTokenizer",
    "CharTokenizer",
    "ASRDataset",
    "BucketingSampler",
    "find_files",
    "create_datasets",
    "collate_batch",
    "bucket_table",
    "PrefetchLoader",
]
