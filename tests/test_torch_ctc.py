"""The port's CTC loss (ops/ctc.py, plain version on the CPU) against the
JAX package's ``ctc_loss`` in its Pallas kernel run in interpret mode and
in its scan implementation, and against ``torch.nn.functional.ctc_loss``.

The cases are those of tests/test_ctc_pallas.py plus NaN input, the
collate dummy row (input length 1, target length 0) and a V = 32768 case
whose B * V * Sp exceeds the JAX kernel's one-hot limit, so that the JAX
side takes its gather path.

Tolerances: losses 1e-5 relative and absolute, gradients 1e-4 relative and
1e-5 absolute (the tolerances tests/test_ctc_pallas.py holds the Pallas
kernel to against the scan): both sides run the same fp32 recursion, but
XLA's and PyTorch's exp/log1p differ in the last bits and the gradient's
lane sums are taken in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from turkish_asr_tpu.ops._ctc_pallas_impl import _ONEHOT_ELEM_LIMIT
from turkish_asr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from turkish_asr_torch.ops._ctc import ctc_topology, label_chains
from turkish_asr_torch.ops.ctc import ctc_loss

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _random_case(seed, B=3, T=37, V=7, L=9):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    targets = rng.integers(1, V, (B, L)).astype(np.int32)
    il = rng.integers(T // 2, T + 1, (B,)).astype(np.int32)
    tl = rng.integers(1, L + 1, (B,)).astype(np.int32)
    return lp, targets, il, tl


def _repeated_and_empty():
    rng = np.random.default_rng(11)
    B, T, V = 3, 20, 5
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((B, T, V)).astype(np.float32)), -1))
    tg = np.asarray([[2, 2, 3, 3, 2, 2], [1, 2, 3, 4, 1, 2], [0, 0, 0, 0, 0, 0]], np.int32)
    return lp, tg, np.asarray([T, T - 4, T], np.int32), np.asarray([6, 6, 0], np.int32)


def _dummy_row():
    """collate_batch's dummy row: 640 samples -> 1 frame after // 4, no target."""
    lp, tg, il, tl = _random_case(4, B=3, T=16, V=6, L=5)
    il[2], tl[2] = 1, 0
    return lp, tg, il, tl


def _big_vocab():
    lp, tg, il, tl = _random_case(6, B=5, T=12, V=32768, L=5)
    S = 2 * tg.shape[1] + 1
    assert lp.shape[0] * lp.shape[2] * ((S + 127) // 128 * 128) > _ONEHOT_ELEM_LIMIT
    return lp, tg, il, tl


CASES = {
    "ragged0": lambda: _random_case(0),
    "ragged1": lambda: _random_case(1),
    "ragged2": lambda: _random_case(2, B=4, T=25, V=6, L=7),
    "repeated_and_empty": _repeated_and_empty,
    "dummy_row": _dummy_row,
    "vocab_32768": _big_vocab,
}


def _jax_loss_and_grad(lp, tg, il, tl, impl):
    def mean_loss(x):
        per = jax_ctc_loss(x, jnp.asarray(tg), jnp.asarray(il), jnp.asarray(tl),
                           reduction="none", impl=impl)
        return jnp.mean(per / jnp.maximum(jnp.asarray(tl), 1)), per  # the 'mean' reduction

    (loss, per), grad = jax.value_and_grad(mean_loss, has_aux=True)(jnp.asarray(lp))
    return np.asarray(per), float(loss), np.asarray(grad)


def _port_loss_and_grad(lp, tg, il, tl):
    x = torch.tensor(lp, requires_grad=True)
    args = (torch.from_numpy(tg), torch.from_numpy(il), torch.from_numpy(tl))
    per = ctc_loss(x.detach(), *args, reduction="none")
    loss = ctc_loss(x, *args, reduction="mean")
    loss.backward()
    return per.numpy(), loss.item(), x.grad.numpy()


@pytest.mark.parametrize("impl", ["pallas_interpret", "scan"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_match_jax(case, impl):
    lp, tg, il, tl = CASES[case]()
    want_per, want_loss, want_grad = _jax_loss_and_grad(lp, tg, il, tl, impl)
    got_per, got_loss, got_grad = _port_loss_and_grad(lp, tg, il, tl)
    assert np.isfinite(got_per).all()
    np.testing.assert_allclose(got_per, want_per, **LOSS_TOL)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)
    for b, n in enumerate(il):  # padded frames get exactly zero gradient
        assert np.all(got_grad[b, int(n):] == 0.0)


def test_impossible_alignment_is_zeroed():
    """A target longer than its frames: zero_infinity turns the loss into
    0 and its gradient into exact zeros, as both JAX paths do."""
    rng = np.random.default_rng(5)
    B, T, V, L = 2, 4, 5, 8
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((B, T, V)).astype(np.float32)), -1))
    tg = rng.integers(1, V, (B, L)).astype(np.int32)
    il, tl = np.asarray([T, T], np.int32), np.asarray([8, 2], np.int32)
    got_per, _, got_grad = _port_loss_and_grad(lp, tg, il, tl)
    for impl in ("pallas_interpret", "scan"):
        want_per, _, want_grad = _jax_loss_and_grad(lp, tg, il, tl, impl)
        np.testing.assert_allclose(got_per, want_per, **LOSS_TOL)
        np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)
    assert got_per[0] == 0.0
    assert np.isfinite(got_grad).all() and np.all(got_grad[0] == 0.0)


def test_nan_input_passes_through():
    """A NaN log-prob makes that sample's loss NaN (zero_infinity does not
    hide it), so the trainer's NaN skip fires; the other samples agree
    with JAX."""
    lp, tg, il, tl = _random_case(7)
    lp[1, 3, :] = np.nan
    got_per, got_loss, _ = _port_loss_and_grad(lp, tg, il, tl)
    want_per, want_loss, _ = _jax_loss_and_grad(lp, tg, il, tl, "pallas_interpret")
    assert np.isnan(got_per[1]) and np.isnan(want_per[1]) and np.isnan(got_loss)
    keep = [0, 2]
    np.testing.assert_allclose(got_per[keep], want_per[keep], **LOSS_TOL)


def test_matches_torch_ctc_loss():
    """Loss and logit gradients against torch.nn.functional.ctc_loss (a
    test oracle only). Through log_softmax, because torch's CTC defines its
    log-prob gradient only up to a softmax-direction term (the convention
    of tests/test_ctc_pallas.py); 1e-3 relative on the gradient as there."""
    rng = np.random.default_rng(21)
    B, T, V, L = 4, 30, 9, 8
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    il = np.array([30, 25, 18, 30], np.int64)
    tl = np.array([8, 5, 3, 1], np.int64)
    tg = rng.integers(1, V, (B, L)).astype(np.int64)
    grads, losses = [], []
    for oracle in (True, False):
        x = torch.tensor(logits, requires_grad=True)
        lp = torch.log_softmax(x, -1)
        args = (torch.from_numpy(tg), torch.from_numpy(il), torch.from_numpy(tl))
        if oracle:
            loss = torch.nn.functional.ctc_loss(lp.permute(1, 0, 2), *args, blank=0,
                                                reduction="mean", zero_infinity=True)
        else:
            loss = ctc_loss(lp, *args)
        loss.backward()
        losses.append(loss.item())
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-3, atol=1e-5)


def test_label_chains_link_each_label_in_order():
    """The backward kernel's scatter order: each label's lanes chained in
    increasing s from a single leader."""
    tg = torch.tensor([[2, 2, 3, 2], [1, 0, 0, 0]])
    ext, allow_skip = ctc_topology(tg, 0)
    nxt, lead = label_chains(ext)
    for b in range(2):
        e = ext[b].tolist()
        for s, v in enumerate(e):
            later = [j for j in range(s + 1, len(e)) if e[j] == v]
            assert nxt[b, s].item() == (later[0] if later else -1)
            assert lead[b, s].item() == (v not in e[:s])
    assert allow_skip[0].tolist() == [False, True, False, False, False, True, False, True,
                                      False]


def test_wrapper_checks_inputs():
    lp = torch.zeros(2, 5, 4)
    ok = (torch.ones(2, 3, dtype=torch.int64), torch.tensor([5, 5]), torch.tensor([3, 3]))
    with pytest.raises(ValueError, match="fp32"):
        ctc_loss(lp.double(), *ok)
    with pytest.raises(ValueError, match="do not match"):
        ctc_loss(lp, ok[0], torch.tensor([5]), ok[2])
    with pytest.raises(ValueError, match="targets up to"):
        ctc_loss(lp, torch.ones(2, 5000, dtype=torch.int64), ok[1], ok[2])
    with pytest.raises(ValueError, match="reduction"):
        ctc_loss(lp, *ok, reduction="avg")
