"""Data pipeline: discovery, split, bucketed batching, host prefetch.

Copied from turkish_asr_tpu/data/dataset.py (the JAX module imports jax
through its feature front-end, so it cannot be imported here): ``find_files``,
``ASRDataset``, ``BucketingSampler``, ``create_datasets``, the static
bucket tables, ``collate_batch`` (with its dummy-row contract:
``wav_lengths = min(S, 640)``, ``target_lengths = 0``) and
``PrefetchLoader``. The training feed carries padded waveforms; log-mel and
SpecAugment run on the device inside the train step. ``ASRDataset.__getitem__``
(the reference's feature item) uses the port's log-mel on the CPU. The
sampler's process slicing (``process_index``/``process_count``) gives each
"data" rank of a mesh its interleaved slice of every global batch
(``turkish_asr_torch/main.py``).
"""

import glob
import os
import queue
import random
import threading

import numpy as np

import torch

from turkish_asr_torch.audio.augment import NoisePerturbation, SpecAugment, SpeedPerturbation
from turkish_asr_torch.audio.features import log_mel_spectrogram
from turkish_asr_torch.audio.wavio import TARGET_SAMPLE_RATE, load_audio
from turkish_asr_torch.data.buckets import DEFAULT_WAVEFORM_BUCKETS, bucket_table


def find_files(root_dir):
    """All (wav_path, txt_path) pairs under root_dir (recursive)."""
    wav_files = glob.glob(os.path.join(root_dir, "**", "*.wav"), recursive=True)
    pairs = []
    for wav_path in wav_files:
        txt_path = wav_path[:-4] + ".txt"
        if os.path.exists(txt_path):
            pairs.append((wav_path, txt_path))
    return pairs


class ASRDataset:
    """(wav, txt) pairs -> (waveform, token ids); optional augmentation."""

    def __init__(
        self,
        file_pairs,
        tokenizer,
        n_mel_channels=80,
        augment=False,
        speed_perturb=False,
        noise_dir=None,
        seed=None,
        spec_augment_freq=27,
        spec_augment_time=100,
    ):
        self.file_pairs = file_pairs
        self.tokenizer = tokenizer
        self.n_mel_channels = n_mel_channels
        self.augment = augment
        rng = np.random.default_rng(seed)
        self.speed_perturb = SpeedPerturbation(rng=rng) if speed_perturb else None
        self.noise_perturb = NoisePerturbation(noise_dir=noise_dir, rng=rng) if noise_dir else None
        # --spec_augment_freq/time reach BOTH SpecAugment paths (the
        # reference parses but ignores them, config.py:52-53 vs
        # dataset.py:70-75; the on-device path plumbs them in trainer.py).
        self.spec_augment = SpecAugment(
            freq_mask_param=spec_augment_freq,
            time_mask_param=spec_augment_time,
            rng=rng) if augment else None

    def __len__(self):
        return len(self.file_pairs)

    @property
    def training(self):
        return self.augment

    def _load_waveform(self, idx):
        """Host-side portion: decode + waveform-level augmentation."""
        wav_path, txt_path = self.file_pairs[idx]
        waveform, sr = load_audio(wav_path, TARGET_SAMPLE_RATE)
        # Conscious deviation from the reference, which parses
        # --speed_perturb but only ever perturbs under --augment
        # (ref dataset.py:267 / main.py): if a SpeedPerturbation was
        # constructed, it runs. Construction (create_datasets) still
        # defaults to the reference's augment-tied behavior.
        if self.speed_perturb is not None:
            waveform = self.speed_perturb(waveform, sr)
        if self.training and self.noise_perturb:
            waveform = self.noise_perturb(waveform, sr)
        try:
            with open(txt_path, "r", encoding="utf-8") as f:
                transcript = f.read().strip()
        except FileNotFoundError:
            transcript = ""
        target = np.asarray(self.tokenizer.encode(transcript), dtype=np.int32)
        return np.asarray(waveform, dtype=np.float32).reshape(-1), target

    def get_waveform(self, idx):
        """(waveform, target) with skip-to-next-sample error recovery
        (reference dataset.py:101-104; iterative so a long run of corrupt
        files can't blow the recursion limit)."""
        last_error = None
        for attempt in range(len(self)):
            i = (idx + attempt) % len(self)
            try:
                return self._load_waveform(i)
            except Exception as e:  # noqa: BLE001 — parity with reference
                print(f"Error processing {self.file_pairs[i][0]}: {e}")
                last_error = e
        raise RuntimeError("No decodable samples in dataset") from last_error

    def __getitem__(self, idx):
        """(features (T, n_mels) float32, target ids) — reference item
        contract; SpecAugment applied on host here (the training loader
        instead applies it on-device)."""
        waveform, target = self.get_waveform(idx)
        features = log_mel_spectrogram(torch.from_numpy(waveform),
                                       n_mels=self.n_mel_channels).numpy()
        if self.training and self.spec_augment:
            features = self.spec_augment(features)
        return features, target


class BucketingSampler:
    """Length-ordered batch sampler (file size as length proxy).

    Yields lists of indices, one list per batch.

    Multi-host: pass ``process_index``/``process_count`` and every process
    receives an equal ``batch_size // process_count`` slice of each global
    batch (same batches, same order on all processes — the shuffle RNG is
    seed-driven, so seeds must match across processes). Ragged final
    batches are dropped in this mode: ``shard_batch`` assembles the global
    array from the per-process slices, which must agree in size.
    """

    def __init__(self, data_source, batch_size, shuffle=True, drop_last=False,
                 seed=None, process_index=0, process_count=1):
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by process_count "
                f"{process_count}")
        self.data_source = data_source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._rng = random.Random(seed)
        self.lengths = []
        for wav_path, _ in data_source.file_pairs:
            try:
                self.lengths.append(os.path.getsize(wav_path))
            except OSError:
                self.lengths.append(0)

    def __iter__(self):
        indices = sorted(range(len(self.data_source)), key=lambda i: self.lengths[i])
        batches = []
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if len(batch) == self.batch_size or not self.drop_last:
                batches.append(batch)
        if self.shuffle:
            self._rng.shuffle(batches)
        if self.process_count > 1:
            # Interleaved slice keeps each process's shard length-sorted
            # within the batch (the batch is already one length bucket).
            batches = [b[self.process_index::self.process_count]
                       for b in batches if len(b) == self.batch_size]
        return iter(batches)

    def __len__(self):
        n = len(self.data_source)
        if self.process_count > 1 or self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def create_datasets(config, tokenizer, augment_train=True):
    """Train/valid/test datasets per the reference's discovery/split rules."""
    train_pairs, valid_pairs, test_pairs = [], [], []

    if getattr(config, "train_path", None):
        train_pairs = find_files(config.train_path)
    if getattr(config, "valid_path", None):
        valid_pairs = find_files(config.valid_path)
    if getattr(config, "test_path", None):
        test_pairs = find_files(config.test_path)

    if not train_pairs and getattr(config, "data_path", None):
        all_pairs = find_files(config.data_path)
        total = len(all_pairs)
        if total == 0:
            raise ValueError(f"No data found in: {config.data_path}")
        test_size = int(total * config.test_split)
        valid_size = int(total * config.val_split)
        train_size = total - test_size - valid_size
        random.Random(config.seed).shuffle(all_pairs)
        train_pairs = all_pairs[:train_size]
        valid_pairs = all_pairs[train_size:train_size + valid_size]
        test_pairs = all_pairs[train_size + valid_size:]

    noise_dir = getattr(config, "noise_dir", None)
    n_mels = config.n_mel_channels
    seed = getattr(config, "seed", None)

    # --speed_perturb is honored on its own (the reference parses it but
    # conflates it with --augment; VERDICT r1 #10). Defaults unchanged:
    # --augment alone still enables speed perturbation.
    speed = augment_train or bool(getattr(config, "speed_perturb", False))
    train_dataset = ASRDataset(
        train_pairs, tokenizer, n_mels,
        augment=augment_train, speed_perturb=speed,
        noise_dir=noise_dir, seed=seed,
        spec_augment_freq=getattr(config, "spec_augment_freq", 27),
        spec_augment_time=getattr(config, "spec_augment_time", 100),
    ) if train_pairs else None
    valid_dataset = ASRDataset(valid_pairs, tokenizer, n_mels, augment=False) if valid_pairs else None
    test_dataset = ASRDataset(test_pairs, tokenizer, n_mels, augment=False) if test_pairs else None
    return train_dataset, valid_dataset, test_dataset


# ---------------------------------------------------------------------------
# Static-shape bucketing + collation
# ---------------------------------------------------------------------------

DEFAULT_TARGET_BUCKETS = (16, 32, 64, 128, 256, 512)

_truncation_warned = 0


def _warn_truncation(wav_len, wav_bucket, tgt_len, tgt_bucket):
    """Truncating audio past the largest bucket while keeping the full
    transcript corrupts a CTC training pair — warn loudly (rate-limited)."""
    global _truncation_warned
    if _truncation_warned < 10:
        _truncation_warned += 1
        import logging
        logging.getLogger("turkish_asr_torch.data").warning(
            "collate truncation: waveform %d -> %d samples / target %d -> %d "
            "tokens; the clipped pair is noisy for CTC. Consider longer "
            "--bucket_lengths or filtering long utterances.",
            wav_len, min(wav_len, wav_bucket), tgt_len,
            min(tgt_len, tgt_bucket))


def collate_batch(
    items,
    batch_size,
    waveform_buckets=DEFAULT_WAVEFORM_BUCKETS,
    target_buckets=DEFAULT_TARGET_BUCKETS,
):
    """Pad (waveform, target) items to static bucket shapes.

    Returns a dict of numpy arrays:
        waveforms (B, S_bucket) f32, wav_lengths (B,) i32,
        targets (B, L_bucket) i32, target_lengths (B,) i32,
        sample_mask (B,) f32 — 0.0 for padding rows of a short final batch.
    """
    items = [it for it in items if it is not None and it[0] is not None]
    if not items:
        return None
    n = len(items)
    max_s = max(w.shape[0] for w, _ in items)
    max_l = max(max(len(t) for _, t in items), 1)
    S = bucket_table(max_s, waveform_buckets)
    L = bucket_table(max_l, target_buckets)

    waveforms = np.zeros((batch_size, S), dtype=np.float32)
    wav_lengths = np.zeros((batch_size,), dtype=np.int32)
    targets = np.zeros((batch_size, L), dtype=np.int32)
    target_lengths = np.zeros((batch_size,), dtype=np.int32)
    sample_mask = np.zeros((batch_size,), dtype=np.float32)

    for i, (w, t) in enumerate(items):
        s = min(w.shape[0], S)
        l = min(len(t), L)
        if s < w.shape[0] or l < len(t):
            _warn_truncation(w.shape[0], S, len(t), L)
        waveforms[i, :s] = w[:s]
        wav_lengths[i] = s
        targets[i, :l] = t[:l]
        target_lengths[i] = l
        sample_mask[i] = 1.0
    # Dummy rows need nonzero lengths so the CTC recursion stays finite;
    # they are excluded from the loss via sample_mask.
    wav_lengths[n:] = min(S, 640)
    target_lengths[n:] = 0

    return {
        "waveforms": waveforms,
        "wav_lengths": wav_lengths,
        "targets": targets,
        "target_lengths": target_lengths,
        "sample_mask": sample_mask,
    }


class PrefetchLoader:
    """Thread-pool prefetcher: host decode/collate overlapped with device
    compute. Yields collated batch dicts."""

    def __init__(self, dataset, sampler, batch_size, num_workers=4,
                 waveform_buckets=DEFAULT_WAVEFORM_BUCKETS,
                 target_buckets=DEFAULT_TARGET_BUCKETS,
                 prefetch=4):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.waveform_buckets = waveform_buckets
        self.target_buckets = target_buckets
        self.prefetch = prefetch

    def __len__(self):
        return len(self.sampler)

    def _make_batch(self, idx_list):
        items = [self.dataset.get_waveform(i) for i in idx_list]
        return collate_batch(items, self.batch_size,
                             self.waveform_buckets, self.target_buckets)

    def __iter__(self):
        batches = list(self.sampler)
        q = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            # Bounded in-flight futures: the executor only works ahead by
            # prefetch+workers batches, so host RAM holds O(prefetch)
            # collated batches, not the whole epoch.
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    inflight = deque()
                    it = iter(batches)
                    for b in it:
                        inflight.append(ex.submit(self._make_batch, b))
                        if len(inflight) >= self.num_workers + self.prefetch:
                            q.put(inflight.popleft().result())
                    while inflight:
                        q.put(inflight.popleft().result())
            except Exception as e:  # noqa: BLE001 — surface in consumer
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            if item is not None:
                yield item
