"""The comparisons that decide ``correct``.

Served text (``text_gap``): a greedy CTC transcript is right when some
frame alignment spells it with the configuration's vocabulary (any
sequence of symbols whose decoded text is the transcript, each symbol over
one or more frames, the silent labels, blank and <unk>, between symbols
and wherever a symbol repeats) with every frame's label close to the
reference's best label at that frame. The number compared is, over such
alignments, the least of the widest gap by which a frame's label lies
below the reference's best logit: a bottleneck path through the CTC
lattice of every spelling. The program's own argmax path is one such
alignment, so a sound transcript reads at most the gap of its own frames,
and a character altered, dropped or added reads the gap of a label the
reference puts far down.
"""

import numpy as np

from asr_bench.reference.bpe import BLANK, UNK, WORD_MARK

INF = float("inf")


def _spellings(text, vocab):
    """The lattice of every symbol sequence whose decoded text is ``text``.

    Decoding joins the symbols, turns the word mark into a space and
    strips the ends, so the joined symbols are ``text`` with any spaces
    before and after. Positions index ``X`` = a space, ``text``, a space;
    the (P + 1, K) arrays give, for each end position, the symbols that
    end there (-1 where none) and where each starts. Spaces beyond the
    one at either end are the word-mark symbol emitted in a loop there."""
    X = WORD_MARK + text.replace(" ", WORD_MARK) + WORD_MARK
    P = len(X)
    longest = max(len(s) for s in vocab.strings[2:])
    ends = [[] for _ in range(P + 1)]
    for p in range(1, P + 1):
        for n in range(1, min(longest, p) + 1):
            k = vocab.index.get(X[p - n:p])
            if k is not None and k not in (BLANK, UNK):
                ends[p].append((k, p - n))
    K = max(1, max(len(e) for e in ends))
    ids = np.full((P + 1, K), -1, np.int64)
    starts = np.zeros((P + 1, K), np.int64)
    for p, e in enumerate(ends):
        for j, (k, s) in enumerate(e):
            ids[p, j], starts[p, j] = k, s
    return ids, starts, P


def text_gap(logits, text, vocab):
    """The least widest gap (logit units) of an alignment of ``text`` over
    ``logits`` (T, V) with ``vocab`` (``bpe.Vocabulary``); inf where none
    exists."""
    lg = np.asarray(logits, dtype=np.float64)
    T = lg.shape[0]
    if T == 0:
        return 0.0 if not text else INF
    gap = lg.max(axis=1, keepdims=True) - lg                   # (T, V)
    silent = np.minimum(gap[:, BLANK], gap[:, UNK])            # (T,)
    space = vocab.index[WORD_MARK]
    ids, starts, P = _spellings(text, vocab)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    not_space = ids != space
    # frame 0: before the first space, after it, in an extra leading space,
    # or in a symbol that starts at either
    sil = np.full(P + 1, INF)
    sil[0] = sil[1] = silent[0]
    lead, trail = gap[0, space], INF
    tok = np.where(valid & (starts <= 1), gap[0, safe], INF)
    for t in range(1, T):
        order = np.argsort(tok, axis=1, kind="stable")
        best1 = np.take_along_axis(tok, order[:, :1], axis=1)[:, 0]
        arg1 = np.take_along_axis(ids, order[:, :1], axis=1)[:, 0]
        best2 = (np.take_along_axis(tok, order[:, 1:2], axis=1)[:, 0]
                 if tok.shape[1] > 1 else np.full(P + 1, INF))
        new_sil = np.minimum(sil, best1)
        new_sil[0] = min(new_sil[0], lead)
        new_sil[P] = min(new_sil[P], trail)
        # a symbol entered from silence, or straight from another symbol
        from_tok = np.where(arg1[starts] == ids, best2[starts], best1[starts])
        enter = np.minimum(sil[starts], from_tok)
        enter = np.where((starts == 0) & not_space, np.minimum(enter, lead), enter)
        new_tok = np.minimum(tok, np.where(valid, enter, INF))
        new_lead = min(lead, sil[0])
        new_trail = min(trail, sil[P], np.min(np.where(valid[P] & not_space[P], tok[P], INF)))
        sil = np.maximum(new_sil, silent[t])
        tok = np.maximum(new_tok, np.where(valid, gap[t, safe], INF))
        lead = max(new_lead, gap[t, space])
        trail = max(new_trail, gap[t, space])
    end = min(sil[P - 1], sil[P], trail, tok[P - 1].min(), tok[P].min())
    return float(end)
