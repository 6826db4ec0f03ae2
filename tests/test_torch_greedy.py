"""Port's greedy CTC collapse against the JAX one: exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.decode.greedy import GreedyDecoder as JaxGreedyDecoder
from turkish_asr_tpu.decode.greedy import greedy_collapse_batch as jax_collapse
from turkish_asr_torch.data.tokenizer import CharTokenizer
from turkish_asr_torch.decode.greedy import GreedyDecoder, greedy_collapse_batch


def _logits(B, T, V, seed):
    rng = np.random.default_rng(seed)
    # Few classes dominate so runs, repeats and blanks all occur.
    x = rng.standard_normal((B, T, V)).astype(np.float32)
    x[..., :4] += 2.0
    return x


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("blank_id", [0, 3])
def test_collapse_matches_jax_exactly(with_lengths, blank_id):
    x = _logits(5, 40, 12, seed=blank_id)
    lens = np.asarray([40, 17, 1, 0, 33], np.int32) if with_lengths else None
    want_ids, want_counts = jax_collapse(
        jnp.asarray(x), None if lens is None else jnp.asarray(lens), blank_id=blank_id)
    ids, counts = greedy_collapse_batch(
        torch.from_numpy(x), None if lens is None else torch.from_numpy(lens),
        blank_id=blank_id)
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_decoder_texts_match_jax():
    tok = CharTokenizer()
    x = _logits(4, 60, tok.vocab_size, seed=7)
    lens = np.asarray([60, 31, 5, 0], np.int32)
    want = JaxGreedyDecoder(tok).decode_batch(jnp.asarray(x), jnp.asarray(lens))
    got = GreedyDecoder(tok).decode_batch(torch.from_numpy(x), torch.from_numpy(lens))
    assert got == want
    assert GreedyDecoder(tok).decode(torch.from_numpy(x[0])) == \
        JaxGreedyDecoder(tok).decode(x[0])
