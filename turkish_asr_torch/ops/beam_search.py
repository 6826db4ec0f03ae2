"""Batched CTC prefix beam search on the log-probs' device.

Counterpart of turkish_asr_tpu/ops/beam_search.py, with the same inputs,
LM fusion forms and return contract. The JAX search is one ``lax.scan``
over frames under ``vmap``; here one Python loop runs over the T frames
and every step works on the whole batch at once: the state is (B, W)
tensors ((B, W, m) for the hash form's word-id windows), and an
utterance past its length (``active = t < lengths``) keeps its state and
records identity links. The loop reads no tensor on the host: no
``.item()``, no branch on a tensor's value, so the card runs it without a
host sync.

State per utterance (W = beam_width):
    last      (W,)    last token (-1 for the empty prefix)
    p_b, p_nb (W,)    log P(prefix ending in blank / non-blank)
    h1, h2    (W,)    two independent rolling hashes of the prefix
    lm_state  (W,)    LM state: ARPA table state (lm_tables), word-FSM
                      state (lm_trie), or a word-id window (lm_hash, (W, m))
    lm_p      (W,)    partial-word trie node (lm_trie, lm_hash)
    lm_ctx    (W,)    the carried scoring context complete(lm_state, lm_p)

Each step makes W "stay" candidates (blank and same-token merge) and W*K
"extend" candidates over the frame's top K = min(V, 2W) tokens. Live
beams are distinct prefixes, so the only duplicate is stay(P) against
extend(parent, t) with parent + t == P: a (W, W*K) double-hash equality
match folds the stay's mass into the extend. The top W by total
probability survive.

Ties are broken as ``jax.lax.top_k`` breaks them, the lower index first:
both top-K selections are a stable descending sort. The JAX search's
one-hot matmul lookups and their size thresholds were workarounds for
the TPU's slow dynamic gathers; here every lookup is a gather, which is
exact. Its uint32 hash arithmetic is done in int64 with the wrap made
explicit (``_hash_step``, ``_hash_probe``).

No token buffer rides the loop: each step records (parent, token) links,
and after the loop the links are followed back once, on the device (one
gather a frame over the (T, B, W) link stack), and the emitted tokens
are left-packed into ``max_prefix_len`` slots. Tokens past that are
dropped, as in the JAX search.
"""

import torch

NEG_INF = -1e30
# The JAX search's rolling-hash parameters (turkish_asr_tpu/ops/
# beam_search.py:54-55), so both merge exactly the same candidates.
_P1, _M1 = 1000003, 16777213
_P2, _M2 = 4097, 16777183
_U32 = 0xFFFFFFFF


def _hash_step(h, tok, p, m):
    """(h * p + tok + 1) mod m in uint32 wraparound arithmetic, on int64
    tensors. h may be negative (dead-beam seeds, blank dummies): its low
    32 bits are its uint32 value, as JAX's astype(uint32) reads it. tok
    is >= 0 and < 2^32 in every use, and p < 2^21, so the int64 product
    never overflows."""
    return ((((h & _U32) * p) + tok + 1) & _U32) % m


def _hash_consts():
    from turkish_asr_torch.decode.lm import (HASH_M1, HASH_M2, HASH_MIX2,
                                             HASH_P1, HASH_P2)
    return HASH_P1, HASH_M1, HASH_P2, HASH_M2, HASH_MIX2


def _suffix_hashes(ctx, p, m):
    """Rolling hashes of every suffix of the (..., n) windows ctx: (..., n)
    with entry j-1 the hash of ctx[..., n-j:], as decode/lm._roll_hash_np
    computes it. All n suffixes roll together: at position i the suffixes
    that have started (j >= n - i) take the step."""
    n = ctx.shape[-1]
    started = torch.arange(n, device=ctx.device)
    h = torch.zeros_like(ctx)
    for i in range(n):
        h = torch.where(started >= n - 1 - i, _hash_step(h, ctx[..., i:i + 1], p, m), h)
    return h


def _hash_probe(ht, h1, h2):
    """Two-choice cuckoo probe of the n-gram table: an entry sits at
    slot1 = (h1 * HASH_P1 mod 2^32) % size or slot2 = (h2 * HASH_MIX2 mod
    2^32) % size (decode/lm._arpa_hash_table). h1, h2 are table hashes in
    [0, 2^31), so both products stay below 2^63. Returns (found, prob,
    bo), each shaped like h1. When an entry's two slots coincide, the
    second gathered row is the first again, and only one hit counts."""
    hp1, _, _, _, mix2 = _hash_consts()
    keys, vals = ht["keys"], ht["vals"]
    size = keys.shape[0]
    i1 = ((h1 * hp1) & _U32) % size
    i2 = ((h2 * mix2) & _U32) % size
    idx = torch.stack([i1, i2], dim=-1)                  # (..., 2)
    k = keys[idx]                                        # (..., 2, 2)
    v = vals[idx]
    hit = (k[..., 0] == h1[..., None]) & (k[..., 1] == h2[..., None])
    hit = torch.cat([hit[..., :1], hit[..., 1:] & (i2 != i1)[..., None]], dim=-1)
    found = hit.any(dim=-1)
    prob = torch.where(hit, v[..., 0], 0.0).sum(dim=-1)
    bo = torch.where(hit, v[..., 1], 0.0).sum(dim=-1)
    return found, prob, bo


def _hash_unigrams(ht, wids):
    """s_0 = log10 p(w) for word ids wids, unk_prob where w has no entry."""
    hp1, hm1, hp2, hm2, _ = _hash_consts()
    f0, p0, _ = _hash_probe(ht, (wids + 1) % hm1, (wids + 1) % hm2)
    return torch.where(f0, p0, ht["unk_prob"])


def _hash_lm_scores(ht, ctx, wids, s0):
    """log10 p(w | ctx) for every (beam, word) pair: the exact Katz
    backoff recursion of ArpaLanguageModel._cond_score,

        s_0 = unigram(w)          (unk_prob when even that is missing)
        s_j = prob_j              if the n-gram (ctx[-j:], w) exists
            = s_{j-1} + bo_j      otherwise (bo_j = backoff(ctx[-j:]),
                                  0 when that context is absent)

    ctx (B, W, m) word-id windows, left-padded with HASH_PAD_ID (a padded
    suffix never hits the table). wids and s0 are (B, K) per-candidate
    word ids and their unigram scores, or (K2,) ids shared by every
    utterance. The m context lengths are probed together; only the
    recursion runs over them. Returns (B, W, K) or (B, W, K2)."""
    hp1, hm1, hp2, hm2, _ = _hash_consts()
    m = ctx.shape[-1]
    if wids.dim() == 1:
        wk, s = wids[None, None, None, :], s0[None, None, :]
    else:
        wk, s = wids[:, None, None, :], s0[:, None, :]
    c1 = _suffix_hashes(ctx, hp1, hm1)                   # (B, W, m): suffix j-1
    c2 = _suffix_hashes(ctx, hp2, hm2)
    fb, _, bo = _hash_probe(ht, c1, c2)                  # the contexts' backoffs
    bo = torch.where(fb, bo, 0.0)
    n1 = _hash_step(c1[..., None], wk, hp1, hm1)         # (B, W, m, K)
    n2 = _hash_step(c2[..., None], wk, hp2, hm2)
    fj, pj, _ = _hash_probe(ht, n1, n2)
    for j in range(m):
        s = torch.where(fj[:, :, j], pj[:, :, j], s + bo[:, :, j, None])
    return s


def _window_append(win, wid):
    """Shift-append word ids into (B, W, m) windows: the hash form's
    complete(h, p). Where wid < 0 the window is unchanged."""
    appended = torch.cat([win[..., 1:], wid.clamp(min=0)[..., None]], dim=-1)
    return torch.where((wid < 0)[..., None], win, appended)


def _topk_stable(x, k):
    """Top k along the last axis, the lower index first among equals (as
    jax.lax.top_k orders ties; torch.topk promises no order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def prepare_lm(device, lm_bias=None, lm_tables=None, lm_trie=None, lm_hash=None):
    """The fusion tables as tensors on ``device``, in the dtypes the
    search gathers from: index tables int64, scores fp32. Returns
    (mode, tables) with mode in {None, "bias", "tables", "trie", "hash"}.
    Tensors already in that form are used as they are, so a decoder
    prepares its tables once and every call reuses them."""
    given = [(name, x) for name, x in (("bias", lm_bias), ("tables", lm_tables),
                                       ("trie", lm_trie), ("hash", lm_hash))
             if x is not None]
    if len(given) > 1:
        raise ValueError("pass at most one of lm_bias/lm_tables/lm_trie/lm_hash")
    if not given:
        return None, {}

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def i64(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    mode, src = given[0]
    if mode in ("trie", "hash") and "pnw" in src:
        return mode, src  # prepared already
    if mode == "bias":
        return mode, {"bias": f32(src)}
    if mode == "tables":
        return mode, {"score": f32(src[0]), "next": i64(src[1])}
    for name in ("pnext", "wq"):
        if name not in src:
            raise ValueError(
                f"lm_{mode} lacks the fused advance tables 'pnext'/'wq' — rebuild "
                f"the fusion tables, or derive them with decode.lm."
                f"derive_fused_trie_advance(ptrans, wid, tok_kind) as "
                f"decode.factory.DeviceBeamDecoder does")
    kind = i64(src["tok_kind"])
    out = {"pnw": torch.stack([i64(src["pnext"]), i64(src["wq"])], dim=-1),
           "tok_kind": kind, "qwid": i64(src["qwid"]),
           # tokens whose extension scores a word (kinds 1, 3, 4)
           "scores_word": (kind == 1) | (kind == 3) | (kind == 4)}
    if mode == "trie":
        out.update(score_w=f32(src["score_w"]), next_w=i64(src["next_w"]))
        return mode, out
    out.update(keys=torch.as_tensor(src["keys"], dtype=torch.int32, device=device),
               vals=f32(src["vals"]), start_ctx=i64(src["start_ctx"]),
               unk_prob=f32(src["unk_prob"]))
    if "uniq_q" in src:
        # Probe-dedup: qwid maps the V tokens onto K2 distinct word ids,
        # and a score depends only on (context, word id), so each step
        # probes the K2 ids and picks columns. Their unigram scores do
        # not change from frame to frame: probed once, here.
        out.update(uniq_q=i64(src["uniq_q"]), qcol=i64(src["qcol"]))
        out["s0"] = _hash_unigrams(out, out["uniq_q"])
    return mode, out


def _beam_step(st, lp_t, active, c, mode, lm, lm_weight):
    """One frame for the whole batch. st: dict of state tensors; lp_t
    (B, V) log-probs; active (B,) bool. Returns (new state, (parent,
    token) links (B, W))."""
    W, K, V = c["W"], c["K"], lp_t.shape[1]
    last, p_b, p_nb, h1, h2 = st["last"], st["p_b"], st["p_nb"], st["h1"], st["h2"]

    top_logp, top_tok = _topk_stable(lp_t, K)                        # (B, K)
    total = torch.logaddexp(p_b, p_nb)                               # (B, W)

    # stay candidates (W): blank transition and same-token merge
    stay_pb = total + lp_t[:, c["blank"]:c["blank"] + 1]
    has_last = last >= 0
    stay_pnb = torch.where(has_last, p_nb + lp_t.gather(1, last.clamp(0, V - 1)), NEG_INF)

    # extend candidates (W*K)
    tok = top_tok[:, None, :]                                        # (B, 1, K)
    lp = top_logp[:, None, :]
    is_repeat = tok == last[:, :, None]                              # (B, W, K)
    ext_pnb = torch.where(is_repeat, p_b[:, :, None] + lp, total[:, :, None] + lp)
    is_blank = tok == c["blank"]
    if mode is not None:
        # Shallow fusion on different-token extensions only, as the
        # reference adds its LM score.
        if mode == "bias":
            rows = (last + 1).clamp(0, lm["bias"].shape[0] - 1)
            score = lm["bias"][rows[:, :, None], tok]
        elif mode == "tables":
            score = lm["score"][st["lm_state"][:, :, None], tok]
        else:
            scores_word = lm["scores_word"][top_tok][:, None, :]     # (B, 1, K)
            if mode == "trie":
                q = lm["qwid"][top_tok]                              # (B, K)
                score = lm["score_w"][st["lm_ctx"][:, :, None], q[:, None, :]]
            elif "uniq_q" in lm and lm["uniq_q"].shape[0] < K:
                every = _hash_lm_scores(lm, st["lm_ctx"], lm["uniq_q"], lm["s0"])
                col = lm["qcol"][top_tok][:, None, :].expand(-1, W, -1)
                score = every.gather(2, col)                         # (B, W, K)
            else:
                q = lm["qwid"][top_tok]
                score = _hash_lm_scores(lm, st["lm_ctx"], q, _hash_unigrams(lm, q))
            score = torch.where(scores_word, score, 0.0)
        ext_pnb = torch.where(is_repeat | is_blank, ext_pnb, ext_pnb + lm_weight * score)
    # Blank "extensions" and dead parents spawn no candidate, and get
    # unique negative hash ids that can merge with no live prefix (real
    # hashes are >= 0, dead-beam seeds are -(0..W-1)).
    kill = is_blank | (total <= NEG_INF * 0.5)[:, :, None]            # (B, W, K)
    ext_pnb = torch.where(kill, NEG_INF, ext_pnb)
    e_h1 = torch.where(kill, c["dummy"], _hash_step(h1[:, :, None], tok, _P1, _M1))
    e_h2 = torch.where(kill, c["dummy"], _hash_step(h2[:, :, None], tok, _P2, _M2))

    # merge: stay(P) with extend(parent, t) where parent + t == P
    B = lp_t.shape[0]
    e_h1, e_h2, e_pnb = e_h1.reshape(B, W * K), e_h2.reshape(B, W * K), ext_pnb.reshape(B, W * K)
    eq = (h1[:, :, None] == e_h1[:, None, :]) & (h2[:, :, None] == e_h2[:, None, :])
    stay_matched = eq.any(dim=2)                                     # (B, W)
    m_e_pb = torch.where(eq, stay_pb[:, :, None], NEG_INF).amax(dim=1)
    m_e_pnb = torch.logaddexp(e_pnb, torch.where(eq, stay_pnb[:, :, None], NEG_INF).amax(dim=1))
    m_pb = torch.cat([torch.where(stay_matched, NEG_INF, stay_pb), m_e_pb], dim=1)
    m_pnb = torch.cat([torch.where(stay_matched, NEG_INF, stay_pnb), m_e_pnb], dim=1)

    _, sel = _topk_stable(torch.logaddexp(m_pb, m_pnb), W)           # (B, W)
    n_pb, n_pnb = m_pb.gather(1, sel), m_pnb.gather(1, sel)
    n_h1 = torch.cat([h1, e_h1], dim=1).gather(1, sel)
    n_h2 = torch.cat([h2, e_h2], dim=1).gather(1, sel)
    sel_parent = c["cand_parent"][sel]
    sel_tok = torch.cat([c["no_tok"].expand(B, W), top_tok.repeat(1, W)], dim=1).gather(1, sel)
    extended = sel_tok >= 0

    new = {"p_b": n_pb, "p_nb": n_pnb, "h1": n_h1, "h2": n_h2,
           "last": torch.where(extended, sel_tok, last.gather(1, sel_parent))}
    if mode in ("trie", "hash", "tables"):
        if mode == "hash":
            par = sel_parent[:, :, None].expand(-1, -1, st["lm_state"].shape[-1])
        else:
            par = sel_parent
        n_state = st["lm_state"].gather(1, par)
    if mode in ("trie", "hash"):
        n_p = st["lm_p"].gather(1, sel_parent)
        n_ctx = st["lm_ctx"].gather(1, par)
        # State advance by the token's kind (decode/lm.py _KIND_*):
        #   0 empty   : (h, p) unchanged
        #   1 "frag"  : p -> walk(p, frag)
        #   2 " "     : h -> complete(h, p), p -> root
        #   3 " frag" : h -> complete(h, p), p -> walk(root, frag)
        #   4 "frag " : h -> complete(h, walk(p, frag)), p -> root
        # pnext[p, v] is the whole p transition and wq[p, v] the word id
        # the context completes with (-1: none). ctx' = complete(base,
        # wq) with base = h, except kind 3 (base = ctx), and ctx' = ctx for
        # kinds 0 and 2.
        tok_c = sel_tok.clamp(0, V - 1)
        kind = lm["tok_kind"][tok_c]                                 # (B, W)
        pw = lm["pnw"][n_p, tok_c]                                   # (B, W, 2)
        pn, wq = pw[..., 0], pw[..., 1]
        if mode == "trie":
            base = torch.where(kind == 3, n_ctx, n_state)
            comp = torch.where(wq < 0, base, lm["next_w"][base, wq.clamp(min=0)])
        else:
            kind = kind[..., None]
            base = torch.where(kind == 3, n_ctx, n_state)
            comp = _window_append(base, wq)
        h_next = torch.where(kind == 4, comp, torch.where(kind >= 2, n_ctx, n_state))
        ctx_next = torch.where((kind == 0) | (kind == 2), n_ctx, comp)
        ext = extended[..., None] if mode == "hash" else extended
        new["lm_state"] = torch.where(ext, h_next, n_state)
        new["lm_p"] = torch.where(extended, pn, n_p)
        new["lm_ctx"] = torch.where(ext, ctx_next, n_ctx)
    elif mode == "tables":
        # The state advances on every extension, repeat-token extends
        # too: the reference reads its context from the whole prefix.
        stepped = lm["next"][n_state, sel_tok.clamp(0, lm["next"].shape[1] - 1)]
        new["lm_state"] = torch.where(extended, stepped, n_state)

    # Frames past an utterance's end keep its state and link each beam
    # to itself.
    a2 = active[:, None]
    a3 = active[:, None, None]
    out = {k: torch.where(a3 if v.dim() == 3 else a2, v, st[k]) for k, v in new.items()}
    links = (torch.where(a2, sel_parent, c["beams"]), torch.where(a2, sel_tok, -1))
    return out, links


@torch.inference_mode()
def ctc_beam_search(log_probs, lengths=None, *, beam_width=16, blank_id=0,
                    max_prefix_len=None, lm_bias=None, lm_weight=0.3,
                    lm_tables=None, lm_trie=None, lm_hash=None,
                    lm_start_state=0, return_all_beams=False):
    """Batched CTC prefix beam search on the device of ``log_probs``.

    Args:
        log_probs: (B, T, V) log-softmax outputs (a tensor; fp32).
        lengths: optional (B,) valid frame counts.
        lm_bias: optional (V+1, V) token-bigram log-prob matrix (row 0 =
            empty context, row i+1 = last token i; decode/lm.
            token_bigram_matrix), added with weight ``lm_weight`` on
            different-token extensions.
        lm_tables: optional (score (S, V), next_state (S, V)) from decode/
            lm.build_arpa_fusion_tables: exact ARPA backoff fusion; each
            beam carries a state starting at ``lm_start_state``.
        lm_trie: optional dict from decode/lm.build_trie_fusion_tables:
            ARPA fusion for char/subword tokenizers; each beam carries
            (word-FSM state, partial-word trie node); ``lm_start_state``
            is its "start_h".
        lm_hash: optional dict from decode/lm.build_hash_fusion_tables:
            the trie fusion at production scale, with hash-probed n-gram
            scores and (W, order-1) word-id windows.
        The tables may be numpy arrays, or the tensors ``prepare_lm``
        returns (then they are not copied again).
        max_prefix_len: slots of the returned id rows (default T).
        return_all_beams: return every beam, for a host rerank.

    Returns:
        (ids (B, L) int32, counts (B,) int32), the best beam of each
        utterance, zero-padded past its count; with return_all_beams,
        (ids (B, W, L), counts (B, W), scores (B, W) fp32). All on the
        device of ``log_probs``.
    """
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    B, T, V = log_probs.shape
    mode, lm = prepare_lm(dev, lm_bias, lm_tables, lm_trie, lm_hash)
    if mode in ("trie", "hash") and lm["pnw"].shape[1] != V:
        raise ValueError(f"fusion tables were built for vocab_size={lm['pnw'].shape[1]} "
                         f"but log_probs has V={V} — rebuild with the model's n_classes")
    W, L = beam_width, max_prefix_len or T
    K = min(V, 2 * W)
    lengths = (torch.full((B,), T, dtype=torch.int64, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev).to(torch.int64))
    beams = torch.arange(W, device=dev)
    c = {"W": W, "K": K, "blank": blank_id, "beams": beams,
         "dummy": -(torch.arange(W * K, device=dev).reshape(W, K) + W + 1),
         # candidate index -> parent beam: W stays, then W*K extends
         "cand_parent": torch.cat([beams, beams.repeat_interleave(K)]),
         "no_tok": torch.full((1, W), -1, dtype=torch.int64, device=dev)}

    # Beam 0 is the live empty prefix (hash seed 0); dead beams get
    # distinct negative seeds, so no dead row hash-merges with a live
    # prefix when W exceeds the finite candidates.
    st = {"last": torch.full((B, W), -1, dtype=torch.int64, device=dev),
          "p_b": torch.full((B, W), NEG_INF, device=dev),
          "p_nb": torch.full((B, W), NEG_INF, device=dev),
          "h1": (-beams).expand(B, W).clone(), "h2": (-beams).expand(B, W).clone()}
    st["p_b"][:, 0] = 0.0
    if mode == "hash":
        st["lm_state"] = lm["start_ctx"].expand(B, W, -1).clone()   # <s> windows
    elif mode in ("trie", "tables"):
        st["lm_state"] = torch.full((B, W), int(lm_start_state), dtype=torch.int64, device=dev)
    if mode in ("trie", "hash"):
        st["lm_p"] = torch.zeros((B, W), dtype=torch.int64, device=dev)  # trie root
        st["lm_ctx"] = st["lm_state"].clone()  # complete(start, root) == start

    frames = log_probs.to(torch.float32).transpose(0, 1).contiguous()   # (T, B, V)
    links = []
    for t in range(T):
        st, link = _beam_step(st, frames[t], t < lengths, c, mode, lm, lm_weight)
        links.append(link)
    scores = torch.logaddexp(st["p_b"], st["p_nb"])                     # (B, W)

    # Backtrace: parent and token+1 packed in one int64 link, followed
    # from the last frame to the first.
    cur = beams.expand(B, W) if return_all_beams else scores.argmax(1, keepdim=True)
    followed = []
    if links:
        parents, tokens = (torch.stack(x) for x in zip(*links))      # (T, B, W)
        packed = parents * (V + 2) + (tokens + 1)
        for t in range(T - 1, -1, -1):
            v = packed[t].gather(1, cur)
            followed.append(v)
            cur = v // (V + 2)
    toks = (torch.stack(followed[::-1], dim=-1) % (V + 2) - 1 if followed
            else torch.zeros(cur.shape + (0,), dtype=torch.int64, device=dev))  # (B, n, T)
    emitted = toks >= 0
    pos = torch.cumsum(emitted, dim=-1) - 1
    counts = emitted.sum(dim=-1).clamp(max=L).to(torch.int32)
    slot = torch.where(emitted & (pos < L), pos, L)
    buf = torch.zeros(toks.shape[:-1] + (L + 1,), dtype=torch.int64, device=dev)
    buf.scatter_(-1, slot, toks)
    ids = buf[..., :L].to(torch.int32)
    if return_all_beams:
        return ids, counts, scores
    return ids[:, 0], counts[:, 0]
