# Copied from turkish_asr_tpu/decode/lm.py (numpy only); only this header and the
# form of the reference-file citations differ. The port imports nothing of the JAX
# package, so it keeps its own copy. The builders' size guards (max_entries, the
# 2^24 node-count refusals) stay as they are: the port gathers, so it would not
# need them for exactness, but they decide which fusion form lm_fusion="auto"
# picks, and another pick is another transcript.
"""Language models for shallow fusion in beam-search decoding.

Reference counterparts (reference utils/decoding.py:23-125):
- KenLMModel: wraps the kenlm C++ package. Here the wrapper first tries
  ``import kenlm``; when unavailable (as in a hermetic TPU image) it falls
  back to a self-contained **ARPA backoff n-gram scorer**
  (:class:`ArpaLanguageModel`) with the same log10 ``score`` /
  ``score_word`` API — so ``--lm path/to/lm.arpa`` works with no external
  dependency.
- NGramLanguageModel: pure count-based n-gram with the reference's exact
  semantics (order 3, -10.0 unknown penalty, <s>/</s> padding).
"""

import logging
import math
from collections import defaultdict


class ArpaLanguageModel:
    """Backoff n-gram LM loaded from an ARPA file (log10 scores).

    Implements the standard Katz backoff query:
        p(w|h) = prob(h,w)                  if (h,w) in table
               = backoff(h) + p(w|h[1:])    otherwise
    matching KenLM's scoring for the same ARPA input.
    """

    def __init__(self, model_path):
        self.logprob = {}
        self.backoff = {}
        self.order = 1
        with open(model_path, "rb") as f:
            head = f.read(64)
        if head.startswith(b"mmap lm http"):
            # KenLM binary magic ("mmap lm http://kheafield.com/code ...")
            raise ValueError(
                f"{model_path} is a BINARY KenLM model (.bin/.klm). This "
                "hermetic build reads text ARPA only; binary models need "
                "the kenlm C++ package. Use the .arpa file lmplz produced "
                "before build_binary (build_binary is one-way — keep the "
                "ARPA), or `pip install kenlm` where allowed.")
        self._load(model_path)
        if not self.logprob:
            raise ValueError(
                f"No n-grams parsed from {model_path}: not a text ARPA file "
                "(binary KenLM .bin/.klm files need the kenlm package; keep "
                "the .arpa lmplz produced before build_binary)")
        self._vocab = {w[0] for w in self.logprob if len(w) == 1}

    def _load(self, path):
        cur_order = 0
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    cur_order = int(line[1:line.index("-")])
                    self.order = max(self.order, cur_order)
                    section = "grams"
                    continue
                if line.startswith("\\"):
                    section = None
                    continue
                if section != "grams":
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < cur_order + 1:
                        continue
                    lp = parts[0]
                    words = tuple(parts[1:1 + cur_order])
                    bo = parts[1 + cur_order] if len(parts) > 1 + cur_order else None
                else:
                    lp = parts[0]
                    words = tuple(parts[1].split())
                    bo = parts[2] if len(parts) > 2 else None
                try:
                    self.logprob[words] = float(lp)
                    if bo is not None:
                        self.backoff[words] = float(bo)
                except ValueError:
                    continue

    def _cond_score(self, history, word):
        """log10 p(word | history) with backoff.

        OOV words (in the query and in the context) map to <unk> first,
        like KenLM's vocabulary lookup — otherwise backoff paths through
        <unk>-context n-grams are never taken and scores diverge from the
        kenlm backend on the same ARPA file."""
        if word not in self._vocab:
            word = "<unk>"
        history = tuple(w if w in self._vocab else "<unk>" for w in history)
        for start in range(len(history) + 1):
            h = history[start:]
            ng = h + (word,)
            if ng in self.logprob:
                # accumulate backoff weights of the skipped longer histories
                bo = 0.0
                for s2 in range(start):
                    h2 = history[s2:]
                    bo += self.backoff.get(h2, 0.0)
                return bo + self.logprob[ng]
        # fully unseen (no <unk> unigram in the file): flat penalty
        bo = sum(self.backoff.get(history[s:], 0.0) for s in range(len(history)))
        return bo + self.logprob.get(("<unk>",), -10.0)

    def score(self, text, bos=True, eos=True):
        """log10 probability of the whole text (KenLM .score contract)."""
        words = text.split()
        tokens = (["<s>"] if bos else []) + words + (["</s>"] if eos else [])
        total = 0.0
        start = 1 if bos else 0
        for i in range(start, len(tokens)):
            history = tuple(tokens[max(0, i - self.order + 1):i])
            total += self._cond_score(history, tokens[i])
        return total

    def score_word(self, word, context=""):
        full_text = f"{context} {word}".strip()
        if context:
            return (self.score(full_text, bos=True, eos=False)
                    - self.score(context, bos=True, eos=False))
        return self.score(word, bos=True, eos=False)


class KenLMModel:
    """KenLM if installed, ArpaLanguageModel fallback otherwise.

    API parity with the reference KenLMModel
    (reference utils/decoding.py:23-85): ``score(text, bos, eos)``
    and ``score_word(word, context)`` in log10.
    """

    def __init__(self, model_path):
        self.backend = None
        self.model_path = model_path
        try:
            import kenlm
            self.model = kenlm.Model(model_path)
            self.order = self.model.order
            self.backend = "kenlm"
        except ImportError:
            self.model = ArpaLanguageModel(model_path)
            self.order = self.model.order
            self.backend = "arpa"
        print(f"LM loaded ({self.backend}): {model_path} (order={self.order})")

    def score(self, text, bos=True, eos=True):
        return self.model.score(text, bos=bos, eos=eos)

    def score_word(self, word, context=""):
        # Backend-agnostic: both backends expose score(text, bos, eos).
        full_text = f"{context} {word}".strip()
        if context:
            return (self.score(full_text, bos=True, eos=False)
                    - self.score(context, bos=True, eos=False))
        return self.score(word, bos=True, eos=False)


def tokenizer_is_word_granular(tokenizer, vocab_size, n_probe=8):
    """True when ``decode`` treats each token as its own space-delimited
    word — the granularity at which on-device ARPA table fusion matches
    the host KenLM context semantics exactly.

    Probes pairs of token ids: a word-granular tokenizer satisfies
    ``decode([a, b]) == decode([a]) + " " + decode([b])``. Char-level and
    merge-style BPE tokenizers (which join tokens without separators)
    fail the probe, and callers should prefer the host beam for LM
    fusion parity there.

    Probe ids are spread across the FULL vocab range (not just the first
    decodable ids): vocabularies whose early ids are whole-word specials
    would otherwise pass while later merge-style pieces join without
    spaces.
    """
    probed = 0
    want = 2 * n_probe
    ids, seen = [], set()
    for k in range(want):
        anchor = (k * vocab_size) // want
        for v in range(anchor, vocab_size):
            if v in seen:
                continue
            try:
                t = tokenizer.decode([v])
            except Exception:  # noqa: BLE001
                continue
            if t.strip():
                ids.append(v)
                seen.add(v)
                break
    for a, b in zip(ids[0::2], ids[1::2]):
        try:
            joint = tokenizer.decode([a, b])
            parts = f"{tokenizer.decode([a])} {tokenizer.decode([b])}"
        except Exception:  # noqa: BLE001
            return False
        if joint.split() != parts.split():
            return False
        probed += 1
    return probed > 0


def build_arpa_fusion_tables(lm, tokenizer, vocab_size,
                             max_entries=32_000_000):
    """Compile an ARPA backoff LM into dense tables for on-device fusion.

    The reference fuses KenLM per prefix extension on the host
    (reference utils/decoding.py:261-263, 298-307): for each
    candidate token it decodes the prefix, re-splits it, and queries
    ``score_word(token_text, context)`` — a Python/C++ round trip per
    (beam, token, frame). The TPU-native equivalent precomputes the LM as
    a finite-state machine over **token** emissions:

    - A *state* is an n-gram context that the ARPA file can actually
      distinguish: the empty context plus every n-gram key of length
      <= order-1 (longer histories collapse onto their longest listed
      suffix, exactly like KenLM state recombination).
    - ``score[s, v]`` is the full Katz-backoff conditional log10-prob of
      token v's word text given state s (OOV words map to <unk>, same as
      ArpaLanguageModel._cond_score).
    - ``next_state[s, v]`` is the state reached after emitting token v.

    Shallow fusion then becomes two gathers inside the beam-search scan
    (ops/beam_search.ctc_beam_search(lm_tables=...)), with each beam
    carrying one int32 LM state — any n-gram order rides at the same cost
    as the bigram matrix.

    Granularity note: each emitted token's decoded text is treated as one
    LM word — the same granularity the reference uses when *scoring* an
    appended token (it inserts a space: ``f"{context} {word}"``). For
    tokenizers whose ``decode`` joins several tokens into one word (char
    fallback, merge-style BPE), the host context words differ, so THIS
    builder is not the parity path for them — build_trie_fusion_tables
    (or build_hash_fusion_tables at production ARPA sizes) is, and
    create_decoder routes them there. Tokens that decode to several words walk the
    state machine word-by-word; tokens that decode to nothing score 0 and
    keep the state.

    Args:
        lm: KenLMModel (arpa backend) or ArpaLanguageModel, or a path to
            a text ARPA file.
        tokenizer: provides ``decode([token_id]) -> str``.
        vocab_size: number of token columns (model n_classes).
        max_entries: refuse to build tables larger than this many cells
            (returns None; callers fall back to host fusion).

    Returns:
        (score (S, V) float32 np.ndarray, next_state (S, V) int32
        np.ndarray, start_state int) or None if the table would exceed
        ``max_entries``.
    """
    import numpy as np

    if isinstance(lm, str):
        model = ArpaLanguageModel(lm)
    elif isinstance(lm, KenLMModel):
        if not isinstance(lm.model, ArpaLanguageModel):
            # kenlm C++ backend: its internals aren't enumerable; re-parse
            # the text ARPA if we kept a path.
            path = getattr(lm, "model_path", None)
            if path is None:
                return None
            try:
                model = ArpaLanguageModel(path)
            except (OSError, ValueError):
                return None
        else:
            model = lm.model
    else:
        model = lm

    order = model.order
    logprob, backoff, vocab = model.logprob, model.backoff, model._vocab
    V = vocab_size

    states = [()] + sorted(
        (k for k in logprob if 1 <= len(k) <= order - 1),
        key=lambda t: (len(t), t))
    sid = {s: i for i, s in enumerate(states)}
    S = len(states)
    if S * V > max_entries:
        return None

    # Token -> word sequence (OOV words -> <unk>, like _cond_score).
    tok_words = []
    for v in range(V):
        try:
            text = tokenizer.decode([v])
        except Exception:  # noqa: BLE001 — special ids may not decode
            text = ""
        tok_words.append([w if w in vocab else "<unk>" for w in text.split()])
    word_cols = {}
    multi = []
    for v, ws in enumerate(tok_words):
        if len(ws) == 1:
            word_cols.setdefault(ws[0], []).append(v)
        else:
            multi.append((v, ws))

    # Explicit extensions (score overrides) and explicit child states
    # (next-state overrides), keyed by context tuple.
    explicit = {}
    for k, lp in logprob.items():
        explicit.setdefault(k[:-1], []).append((k[-1], lp))
    children = {}
    for u, i in sid.items():
        if u:
            children.setdefault(u[:-1], []).append((u[-1], i))

    def sigma(t):
        while t not in sid:
            t = t[1:]
        return t

    score = np.empty((S, V), np.float32)
    nxt = np.empty((S, V), np.int32)

    unk_lp = logprob.get(("<unk>",), -10.0)
    score[0] = unk_lp
    nxt[0] = 0
    for w, lp in explicit.get((), []):
        cols = word_cols.get(w)
        if cols:
            score[0, cols] = lp
    for w, uid in children.get((), []):
        cols = word_cols.get(w)
        if cols:
            nxt[0, cols] = uid

    # Rows in increasing state length: backoff recursion reads the parent
    # row sigma(s[1:]), which is strictly shorter and already filled.
    for i in range(1, S):
        s = states[i]
        par = sid[sigma(s[1:])]
        score[i] = backoff.get(s, 0.0) + score[par]
        nxt[i] = nxt[par]
        for w, lp in explicit.get(s, []):
            cols = word_cols.get(w)
            if cols:
                score[i, cols] = lp
        c = s if len(s) < order - 1 else s[1:]
        if c in sid or c == ():
            for w, uid in children.get(c, []):
                cols = word_cols.get(w)
                if cols:
                    nxt[i, cols] = uid

    # Multi-word / empty-word token columns: walk the machine word by word.
    for i, s in enumerate(states):
        for v, ws in multi:
            if not ws:
                score[i, v] = 0.0
                nxt[i, v] = i
                continue
            cur, tot = s, 0.0
            for w in ws:
                tot += model._cond_score(cur, w)
                grown = cur + (w,)
                cur = sigma(grown[len(grown) - (order - 1):]
                            if order > 1 else ())
            score[i, v] = tot
            nxt[i, v] = sid[cur]

    # score_word(w, context="") scores against <s> (bos=True).
    start_state = sid.get(("<s>",), 0)
    return score, nxt, start_state


class _WordIdentityTok:
    """Each 'token' IS one LM word — feeds build_arpa_fusion_tables to
    produce word-level FSM tables (score/next over ARPA word columns)."""

    def __init__(self, words):
        self.words = words

    def decode(self, ids):
        return " ".join(self.words[i] for i in ids)


# Token text shapes the trie fusion understands. Anything else (internal
# whitespace, i.e. multi-word fragments) makes the builder return None.
_KIND_EMPTY, _KIND_FRAG, _KIND_SPACE, _KIND_SP_FRAG, _KIND_FRAG_SP = range(5)


def _classify_tokens(tokenizer, vocab_size, n_validate=64, seed=0):
    """Classify each token's word-boundary behavior -> (kinds, frags) or
    None when the tokenizer can't be modeled.

    ``decode`` may strip outer whitespace (our JSON BPE strips the leading
    "▁"-marker space), so boundary markers are probed with PAIR decodes
    against an anchor pure-fragment token f:
        decode([f, v]) != decode([f]) + decode([v])  => v opens a word
        decode([v, f]) != decode([v]) + decode([f])  => v closes a word
    The classification is then VALIDATED: for random id sequences,
    decode(ids).split() must equal the word list the (kind, frag) model
    predicts — this is the exact property the trie state machine needs
    (the host beam's LM context is decode(prefix).split(), beam.py
    _lm_score)."""
    import random

    texts = []
    for v in range(vocab_size):
        try:
            texts.append(tokenizer.decode([v]))
        except Exception:  # noqa: BLE001
            texts.append("")

    def dec(ids):
        try:
            return tokenizer.decode(ids)
        except Exception:  # noqa: BLE001
            return None

    # anchor: a mid-word fragment (self-pair joins without a boundary)
    anchor = None
    for v in range(vocab_size):
        t = texts[v]
        if t and not any(c.isspace() for c in t) and dec([v, v]) == t + t:
            anchor = v
            break
    if anchor is None:
        return None
    ta = texts[anchor]

    kinds = [0] * vocab_size
    frags = [""] * vocab_size
    for v in range(vocab_size):
        t = texts[v]
        stripped = t.strip()
        if any(c.isspace() for c in stripped):
            return None  # multi-word fragment
        if stripped == "":
            # "" from decode can still be a boundary marker whose space is
            # stripped (a bare "▁"): probe it between two anchors.
            mid = dec([anchor, v, anchor])
            if mid == ta + ta:
                kinds[v] = _KIND_EMPTY
            elif mid is not None and mid.split() == [ta, ta]:
                kinds[v] = _KIND_SPACE
            else:
                return None
            continue
        frags[v] = stripped
        lead_probe = dec([anchor, v])
        trail_probe = dec([v, anchor])
        if lead_probe is None or trail_probe is None:
            return None
        lead = lead_probe != ta + t
        trail = trail_probe != t + ta
        if lead and (lead_probe or "").split() != [ta, stripped]:
            return None
        if trail and (trail_probe or "").split() != [stripped, ta]:
            return None
        if lead and trail:
            return None
        kinds[v] = (_KIND_SP_FRAG if lead
                    else _KIND_FRAG_SP if trail else _KIND_FRAG)

    # validation: model-predicted words == decode().split()
    rng = random.Random(seed)
    for _ in range(n_validate):
        n = rng.randrange(1, 10)
        ids = [rng.randrange(vocab_size) for _ in range(n)]
        joined = dec(ids)
        if joined is None:
            return None
        parts = []
        for v in ids:
            k = kinds[v]
            if k == _KIND_SPACE:
                parts.append(" ")
            elif k == _KIND_FRAG:
                parts.append(frags[v])
            elif k == _KIND_SP_FRAG:
                parts.append(" " + frags[v])
            elif k == _KIND_FRAG_SP:
                parts.append(frags[v] + " ")
        if joined.split() != "".join(parts).split():
            return None
    return kinds, frags


_TRIE_SPECIALS = {"<s>", "</s>", "<unk>"}


def _word_trie_size(uni):
    """Node count of the partial-word trie WITHOUT building the (P, V)
    tables — size gate for builders."""
    nodes = {""}
    for w in uni:
        if w in _TRIE_SPECIALS:
            continue
        for i in range(1, len(w) + 1):
            nodes.add(w[:i])
    return len(nodes) + 1  # + OOV sink


def _word_trie_tables(uni, word_index, unk_id, tok_kind, frags, vocab_size):
    """Build the partial-word trie over ARPA vocab words and the per-token
    walk table. Shared by the dense (build_trie_fusion_tables) and hash
    (build_hash_fusion_tables) builders.

    Returns (ptrans (P, V) i32, wid (P,) i32, P). Node 0 = root (empty
    partial), node 1 = OOV sink (a partial that is no prefix of any vocab
    word can only ever map to <unk>)."""
    import numpy as np

    # Trie over prefixes of real vocab words (specials excluded — a
    # partial word can never complete to "<s>").
    children = {}          # (node, char) -> node
    node_string = ["", None]   # node 1 = OOV sink
    ROOT, SINK = 0, 1
    for w in uni:
        if w in _TRIE_SPECIALS:
            continue
        node = ROOT
        for ch in w:
            nxt = children.get((node, ch))
            if nxt is None:
                nxt = len(node_string)
                node_string.append(
                    (node_string[node] or "") + ch if node != SINK else None)
                children[(node, ch)] = nxt
            node = nxt
    P = len(node_string)
    wid = np.full((P,), unk_id, np.int32)
    for p, s in enumerate(node_string):
        if s and s in word_index and s not in _TRIE_SPECIALS:
            wid[p] = word_index[s]

    # Vectorized trie walks (round-4: the per-(p, v) Python loop was
    # O(P*V*len) dict probes — minutes at 100k-word tries). Build a dense
    # (P, alphabet) child array once, then each fragment walk is
    # len(frag) numpy gathers over all P rows at once.
    alphabet = sorted({ch for (_, ch) in children})
    cidx = {ch: i for i, ch in enumerate(alphabet)}
    child = np.full((P, len(alphabet) + 1), SINK, np.int32)  # last col:
    for (node, ch), nxt in children.items():                 # unknown char
        child[node, cidx[ch]] = nxt
    child[SINK, :] = SINK

    def walk_all(start, frag):
        """Trie nodes reached from `start` ((P,) array or scalar) by
        walking `frag`; dead ends land in SINK (child is SINK-closed)."""
        cur = np.asarray(start, np.int32)
        for ch in frag:
            cur = child[cur, cidx.get(ch, len(alphabet))]
        return cur

    # ptrans[p, v]: trie node reached by v's fragment — from p for
    # FRAG/FRAG_SP, from ROOT for SP_FRAG (the leading space completed the
    # old partial), ROOT for SPACE, identity for EMPTY.
    ptrans = np.empty((P, vocab_size), np.int32)
    all_nodes = np.arange(P, dtype=np.int32)
    for v in range(vocab_size):
        k = tok_kind[v]
        if k == _KIND_EMPTY:
            ptrans[:, v] = all_nodes
        elif k == _KIND_SPACE:
            ptrans[:, v] = ROOT
        elif k == _KIND_SP_FRAG:
            ptrans[:, v] = walk_all(ROOT, frags[v])
        else:  # FRAG, FRAG_SP
            ptrans[:, v] = walk_all(all_nodes, frags[v])
    return ptrans, wid, P


def build_trie_fusion_tables(lm, tokenizer, vocab_size,
                             max_entries=32_000_000):
    """Compile ARPA fusion tables for SUBWORD/CHAR tokenizers.

    The word-granular tables (build_arpa_fusion_tables) require each token
    to decode to its own word; the shipped default tokenizer is char-level,
    so `--lm_fusion auto` used to fall back to the 0.9-RTFx host beam
    (VERDICT r2 weak #2). This builder extends the LM state machine with
    the *word-in-progress*, lexicon-free-flashlight-style, reproducing the
    host CTCBeamDecoder's exact scoring semantics
    (decode/beam.py _lm_score -> lm.score_word):

    - host context = decode(prefix).split(): completed words PLUS the
      current partial word, each mapped to the ARPA vocab (OOV -> <unk>).
    - each extension's decode([token]) text is scored as its own word(s)
      against that context.

    Beam state = (h, p): h = ARPA sigma-state of the completed words,
    p = trie node of the partial word (node 0 = empty, node 1 = OOV sink —
    a partial that is no prefix of any vocab word can only ever map to
    <unk>). Scoring context = complete(h, p) = next_w[h, wid[p]]
    (p != empty), i.e. the state after emitting the partial as a word.

    Returns a dict of numpy arrays (or None when a token's text has
    internal whitespace, decode is non-concatenative, or the tables exceed
    max_entries):
        score_w (S, Wa) f32   word-conditional log10 probs
        next_w  (S, Wa) i32   word-level state transitions
        ptrans  (P, V)  i32   trie walk per token (kind-dependent origin)
        wid     (P,)    i32   ARPA word id of each trie node (<unk> if
                              the node's string is not a vocab word)
        tok_kind (V,)   i32   _KIND_* classification of decode([v])
        qwid    (V,)    i32   ARPA word id of the token's fragment text
        pnext   (P, V)  i32   FUSED full p-transition (kind folded in):
                              the device advance reads p' directly instead
                              of dispatching on kind (ops/beam_search.py)
        wq      (P, V)  i32   word id to complete against for the carried
                              scoring context (-1 = no completion lookup:
                              kinds EMPTY/SPACE, or a ROOT walk result)
        start_h int, trie_nodes int
    """
    import numpy as np

    if isinstance(lm, str):
        model = ArpaLanguageModel(lm)
    elif isinstance(lm, KenLMModel):
        if isinstance(lm.model, ArpaLanguageModel):
            model = lm.model
        else:
            path = getattr(lm, "model_path", None)
            if path is None:
                return None
            try:
                model = ArpaLanguageModel(path)
            except (OSError, ValueError):
                return None
    else:
        model = lm

    kinds_frags = _classify_tokens(tokenizer, vocab_size)
    if kinds_frags is None:
        return None
    tok_kind, frags = kinds_frags

    uni = sorted(model._vocab)
    if "<unk>" not in model._vocab:
        uni.append("<unk>")
    word_index = {w: i for i, w in enumerate(uni)}
    unk_id = word_index["<unk>"]
    Wa = len(uni)

    # Word-level FSM: reuse the word-granular compiler with identity
    # word "tokens" — score_w[s, w] = score_word(uni[w], state s words).
    word_tables = build_arpa_fusion_tables(
        model, _WordIdentityTok(uni), Wa, max_entries=max_entries)
    if word_tables is None:
        return None
    score_w, next_w, start_h = word_tables
    S = score_w.shape[0]

    V = vocab_size
    tok_kind = np.asarray(tok_kind, np.int32)
    qwid = np.asarray(
        [word_index.get(f, unk_id) if f else unk_id for f in frags],
        np.int32)

    trie_sz = _word_trie_size(uni)
    # 3x (P, V): ptrans (host/debug) + the fused pnext/wq device tables.
    if S * Wa * 2 + trie_sz * V * 3 > max_entries:
        return None
    if trie_sz >= (1 << 24):
        # Node ids round-trip through f32 one-hot payload matmuls in the
        # device beam (exact only below 2^24; ops/beam_search.py parent
        # selection) — refuse rather than silently corrupt ids.
        return None
    ptrans, wid, P = _word_trie_tables(uni, word_index, unk_id, tok_kind,
                                       frags, vocab_size)
    pnext, wq = derive_fused_trie_advance(ptrans, wid, tok_kind)
    return {
        "score_w": score_w.astype(np.float32),
        "next_w": next_w.astype(np.int32),
        "ptrans": ptrans,
        "wid": wid,
        "tok_kind": tok_kind,
        "qwid": qwid,
        "pnext": pnext,
        "wq": wq,
        "start_h": int(start_h),
        "trie_nodes": P,
    }


def derive_fused_trie_advance(ptrans, wid, tok_kind):
    """Fold the kind-dispatched trie advance into two (P, V) tables.

    The device beam's per-step advance used to dispatch on tok_kind with a
    chain of where/selects plus a dependent wid lookup (round-3 ablations
    pinned the trie-vs-word-table RTFx gap on exactly those small serial
    ops, AGENTS.md). Precomputing collapses it to two independent cell
    lookups:
        pnext[p, v] : the full next partial-word trie node —
                      EMPTY: p, SPACE/FRAG_SP: ROOT, FRAG/SP_FRAG: the walk
        wq[p, v]    : ARPA word id the carried scoring context must
                      complete against (wid of the walked node), or -1
                      when no completion lookup is needed (EMPTY/SPACE, or
                      the walk landed on ROOT)
    """
    import numpy as np

    ptrans = np.asarray(ptrans, np.int32)
    P, V = ptrans.shape
    k = np.asarray(tok_kind, np.int32)[None, :]             # (1, V)
    all_nodes = np.arange(P, dtype=np.int32)[:, None]       # (P, 1)
    pnext = np.where(k == _KIND_EMPTY, all_nodes,
                     np.where((k == _KIND_FRAG) | (k == _KIND_SP_FRAG),
                              ptrans, 0)).astype(np.int32)
    wq = np.where((k == _KIND_EMPTY) | (k == _KIND_SPACE) | (ptrans == 0),
                  -1, np.asarray(wid, np.int32)[ptrans]).astype(np.int32)
    return pnext, wq


# Rolling-hash params for the PRODUCTION-SCALE n-gram hash table
# (build_hash_fusion_tables <-> ops/beam_search._hash_lm_scores). Computed
# in uint32 wraparound arithmetic then reduced mod M — host (numpy uint32)
# and device (jnp uint32, ops/beam_search._hash_step) match bit-for-bit.
# Keys are verified with BOTH hashes (gathered as int32 and compared as
# ints, no f32 round-trip), so moduli use the full int32 range: ~62 bits
# of key identity, false-hit probability ~2^-42 even at 1e6 probes/s.
HASH_P1, HASH_M1 = 1000003, 2147483647
HASH_P2, HASH_M2 = 4097, 2147483629
# Second cuckoo-slot mix (Knuth's multiplicative constant): slot2 =
# (h2 * HASH_MIX2 mod 2^32) % table_size. Independent of slot1's
# h1·HASH_P1 mix because h1/h2 are independent rolling hashes.
HASH_MIX2 = 2654435761
# Reserved "absent history" word id for left-padded context windows —
# never a real word id (builders assert vocab < HASH_PAD_ID), so any
# n-gram probe whose window still contains it simply misses the table.
HASH_PAD_ID = 1 << 22


def _roll_hash_np(ids, p, m):
    """Rolling hash of each ROW of ids (N, L) uint32 -> (N,) int64 in
    [0, m): h = (h * p + id + 1) mod 2^32 mod m per column, matching
    ops/beam_search._hash_step."""
    import numpy as np

    h = np.zeros(ids.shape[0], np.uint32)
    p = np.uint32(p)
    one = np.uint32(1)
    for c in range(ids.shape[1]):
        h = (h * p + ids[:, c].astype(np.uint32) + one) % np.uint32(m)
    return h.astype(np.int64)


def _arpa_hash_table(model, word_index, load_factor=0.45):
    """Pack every ARPA n-gram into a two-choice CUCKOO hash table.

    Layout: keys (size, 2) int32 — the two rolling hashes of the n-gram's
    word-id sequence (-1 = empty slot); vals (size, 2) float32 —
    (log10 prob, backoff weight). Every entry sits at exactly one of TWO
    slots — slot1 = (h1·HASH_P1 mod 2^32) % size, slot2 = (h2·HASH_MIX2
    mod 2^32) % size — so the device probe gathers 2 rows per point
    (ops/beam_search._hash_probe). The previous linear-probing scheme
    needed depth-8 chains and grew to load ~0.1 (10.6M slots for 1.05M
    n-grams) before every chain fit; the probe gather is ~linear in
    fetched rows on v5e (scripts/ab_hash_probe_cost.py: depth 8→2 took
    the 100k-ARPA beam 474→178 ms/iter), so 8→2 rows is the whole win,
    and cuckoo packs at load 0.45 (the two-choice threshold is 0.5),
    shrinking the table ~4.5× on top.

    Insertion is a vectorized random-walk: each round every pending entry
    claims its current-side slot (one winner per slot via scatter); the
    displaced occupant and the round's losers flip to their other slot
    and retry. Residue after the round cap grows the table 1.3×.
    """
    import numpy as np

    by_len = {}
    skipped = 0
    for ng, lp in model.logprob.items():
        # N-grams containing a word with NO unigram entry (hand-pruned /
        # non-lmplz ARPA files) are unreachable in the host oracle —
        # _cond_score maps every query/context word to <unk> BEFORE the
        # logprob lookup, so the raw entry is never consulted. Skip them
        # (substituting <unk> ids would create duplicate keys with
        # genuine <unk> n-grams) instead of crashing on word_index.
        if any(w not in word_index for w in ng):
            skipped += 1
            continue
        by_len.setdefault(len(ng), []).append(ng)
    if skipped:
        logging.getLogger(__name__).warning(
            "hash fusion: skipped %d n-grams containing words with no "
            "unigram entry (unreachable under <unk> mapping)", skipped)
    h1_parts, h2_parts, prob_parts, bo_parts = [], [], [], []
    for n, ngrams in sorted(by_len.items()):
        ids = np.array([[word_index[w] for w in ng] for ng in ngrams],
                       np.uint32).reshape(len(ngrams), n)
        h1_parts.append(_roll_hash_np(ids, HASH_P1, HASH_M1))
        h2_parts.append(_roll_hash_np(ids, HASH_P2, HASH_M2))
        prob_parts.append(np.array([model.logprob[ng] for ng in ngrams],
                                   np.float32))
        bo_parts.append(np.array([model.backoff.get(ng, 0.0)
                                  for ng in ngrams], np.float32))
    h1 = np.concatenate(h1_parts)
    h2 = np.concatenate(h2_parts)
    prob = np.concatenate(prob_parts)
    bo = np.concatenate(bo_parts)
    total = len(h1)

    pairs = h1 * (1 << 32) + h2
    if len(np.unique(pairs)) != total:
        raise ValueError(
            "dual-hash collision between distinct n-grams (probability "
            "~2^-42 at 1M n-grams) — change HASH_P1/HASH_P2 seeds")

    size = max(64, int(total / load_factor))
    # Slots mix the raw hashes by one multiply each: rolling hashes of
    # prefix-sharing n-grams are CONSECUTIVE integers (unigrams are id+1;
    # bigrams under one first word differ only by the last id), so h % size
    # alone forms dense runs. Matches ops/beam_search._hash_probe
    # bit-for-bit (uint32 wrap on both sides).
    for _ in range(16):
        pos1 = (((h1.astype(np.uint64) * np.uint64(HASH_P1))
                 & 0xFFFFFFFF) % size).astype(np.int64)
        pos2 = (((h2.astype(np.uint64) * np.uint64(HASH_MIX2))
                 & 0xFFFFFFFF) % size).astype(np.int64)
        entry_at = np.full(size, -1, np.int64)
        side = np.zeros(total, np.uint8)
        pending = np.arange(total)
        for _round in range(256):
            if len(pending) == 0:
                break
            pos = np.where(side[pending] == 0, pos1[pending], pos2[pending])
            claim = np.full(size, -1, np.int64)
            claim[pos] = pending            # last writer wins the slot
            won = claim[pos] == pending
            win_pos = pos[won]
            evicted = entry_at[win_pos]     # read before write: prior rounds'
            entry_at[win_pos] = pending[won]  # occupants only
            ev = evicted[evicted >= 0]
            side[ev] ^= 1                   # displaced: try the other slot
            lost = pending[~won]
            side[lost] ^= 1
            pending = np.concatenate([lost, ev])
        if len(pending) == 0:
            keys = np.full((size, 2), -1, np.int32)
            vals = np.zeros((size, 2), np.float32)
            filled = np.nonzero(entry_at >= 0)[0]
            e = entry_at[filled]
            keys[filled, 0] = h1[e]
            keys[filled, 1] = h2[e]
            vals[filled, 0] = prob[e]
            vals[filled, 1] = bo[e]
            return keys, vals, size
        size = int(size * 1.3)
    raise RuntimeError(
        f"cuckoo table failed to place {len(pending)} n-grams after 16 "
        f"growth rounds (size {size}) — pathological key clustering; "
        f"change HASH_P1/HASH_P2/HASH_MIX2 seeds")


def build_hash_fusion_tables(lm, tokenizer, vocab_size,
                             max_entries=600_000_000):
    """PRODUCTION-SCALE trie fusion: hash-table ARPA scoring.

    build_trie_fusion_tables compiles the word-level LM into dense
    (S, Wa) score/next tables — quadratic in vocabulary, infeasible past
    ~3k words (a 100k-word ARPA would need tens of GB). This builder keeps
    the same partial-word trie front (pnext/wq/tok_kind/qwid) but replaces
    the word FSM with KenLM-style probing-hash scoring:

    - every beam carries its last (order-1) ARPA word ids (a context
      WINDOW, left-padded with HASH_PAD_ID) instead of a dense state id;
    - score_word = the exact Katz backoff recursion of
      ArpaLanguageModel._cond_score, evaluated on device with two-row
      cuckoo probes of a hash table over ALL n-grams
      (ops/beam_search._hash_lm_scores);
    - complete(h, p) degenerates to shift-append — the dense path's
      next_w lookup disappears.

    Memory is linear in the ARPA (2 i32 + 2 f32 per slot at load 0.45) and
    in the trie ((P, V) pnext/wq), so 100k+-word LMs fit easily.

    Returns a dict (or None when the tokenizer can't be modeled):
        keys (N, 2) i32, vals (N, 2) f32, table_size, probe_depth (= 2,
            the two cuckoo choices — informational; the device probe
            derives the size from keys' static shape and always gathers
            exactly 2 rows)
        order, ctx_len (= order-1), start_ctx (ctx_len,) i32
        unk_prob float  — unigram fallback (logprob of <unk>, or -10)
        pnext/wq (P, V) i32, tok_kind/qwid (V,) i32   — trie front
        uniq_q (K2,) i32, qcol (V,) i32  — probe-dedup: the distinct
            qwid values and each token's index into them
        trie_nodes, n_words
    """
    import numpy as np

    if isinstance(lm, str):
        model = ArpaLanguageModel(lm)
    elif isinstance(lm, KenLMModel):
        if isinstance(lm.model, ArpaLanguageModel):
            model = lm.model
        else:
            path = getattr(lm, "model_path", None)
            if path is None:
                return None
            try:
                model = ArpaLanguageModel(path)
            except (OSError, ValueError):
                return None
    else:
        model = lm

    kinds_frags = _classify_tokens(tokenizer, vocab_size)
    if kinds_frags is None:
        return None
    tok_kind, frags = kinds_frags

    uni = sorted(model._vocab)
    if "<unk>" not in model._vocab:
        uni.append("<unk>")
    word_index = {w: i for i, w in enumerate(uni)}
    unk_id = word_index["<unk>"]
    if len(uni) >= HASH_PAD_ID:
        raise ValueError(f"ARPA vocabulary too large: {len(uni)} >= "
                         f"{HASH_PAD_ID} (HASH_PAD_ID)")

    V = vocab_size
    tok_kind = np.asarray(tok_kind, np.int32)
    qwid = np.asarray(
        [word_index.get(f, unk_id) if f else unk_id for f in frags],
        np.int32)
    # Probe-dedup: scores depend on (ctx, word id) only, and qwid maps the
    # V tokens onto few DISTINCT word ids (char tokenizers: almost every
    # token's fragment is no ARPA word -> <unk>). The device search probes
    # the K2 = len(uniq_q) distinct ids once per step and selects columns,
    # instead of probing per candidate (ops/beam_search._beam_step).
    uniq_q, qcol = np.unique(qwid, return_inverse=True)

    trie_sz = _word_trie_size(uni)
    if trie_sz * V * 2 > max_entries:
        return None
    if trie_sz >= (1 << 24):
        # The entry budget admits node counts above 2^24 for tiny
        # vocabularies (V < ~18), but node ids round-trip through f32
        # one-hot payload matmuls in the device beam — exact only below
        # 2^24. Refuse (falls back to the host beam) rather than
        # silently corrupt node ids. (Word ids are already bounded by
        # the HASH_PAD_ID check above: 2^22 < 2^24.)
        return None
    ptrans, wid, P = _word_trie_tables(uni, word_index, unk_id, tok_kind,
                                       frags, vocab_size)
    pnext, wq = derive_fused_trie_advance(ptrans, wid, tok_kind)

    keys, vals, size = _arpa_hash_table(model, word_index)

    m = max(model.order - 1, 1)
    start_ctx = np.full((m,), HASH_PAD_ID, np.int32)
    if "<s>" in word_index:
        start_ctx[-1] = word_index["<s>"]

    return {
        "keys": keys,
        "vals": vals,
        "table_size": int(size),
        "probe_depth": 2,
        "order": int(model.order),
        "ctx_len": int(m),
        "start_ctx": start_ctx,
        "unk_prob": float(model.logprob.get(("<unk>",), -10.0)),
        "pnext": pnext,
        "wq": wq,
        "tok_kind": tok_kind,
        "qwid": qwid,
        "uniq_q": uniq_q.astype(np.int32),
        "qcol": qcol.astype(np.int32),
        "trie_nodes": int(P),
        "n_words": int(len(uni)),
    }


def token_bigram_matrix(texts, tokenizer, vocab_size):
    """Dense (V+1, V) token-bigram log-prob matrix for on-device fusion.

    Row 0 is the empty/start context; row i+1 conditions on last token i.
    Scores replicate ``NGramLanguageModel(order=2).train(texts, tokenizer)``
    query semantics exactly — log(count/total + 1e-10) for tokens under a
    seen context, log(1e-10) for unseen tokens under a seen context, and
    -10 for unseen contexts (the empty prefix is always "unseen" because
    beam queries pass raw prefixes, never <s>) — so the on-device beam with
    this bias matches the host beam with that LM bit-for-bit.
    """
    import numpy as np
    counts = {}
    totals = {}
    for text in texts:
        toks = list(tokenizer.encode(text))
        padded = ["<s>"] + toks + ["</s>"]
        for a, b in zip(padded, padded[1:]):
            counts[(a, b)] = counts.get((a, b), 0) + 1
            totals[a] = totals.get(a, 0) + 1
    mat = np.full((vocab_size + 1, vocab_size), -10.0, dtype=np.float32)
    unseen = math.log(1e-10)
    for a, total in totals.items():
        if not isinstance(a, int) or a >= vocab_size:
            continue  # "<s>" contexts are never queried by the beam
        mat[a + 1, :] = unseen
    for (a, b), c in counts.items():
        if not isinstance(a, int) or not isinstance(b, int):
            continue
        if a >= vocab_size or b >= vocab_size:
            continue
        mat[a + 1, b] = math.log(c / totals[a] + 1e-10)
    return mat


class NGramLanguageModel:
    """Count-based n-gram fallback (reference decoding.py:88-125)."""

    def __init__(self, order=3):
        self.order = order
        self.counts = defaultdict(int)
        self.total_counts = defaultdict(int)

    def train(self, texts, tokenizer=None):
        for text in texts:
            if tokenizer:
                tokens = tokenizer.encode(text)
            else:
                tokens = text.lower().split()
            tokens = ["<s>"] * (self.order - 1) + list(tokens) + ["</s>"]
            for i in range(len(tokens) - self.order + 1):
                ngram = tuple(tokens[i:i + self.order])
                self.counts[ngram] += 1
                self.total_counts[ngram[:-1]] += 1

    def score(self, history, next_token):
        hist = tuple(history[-(self.order - 1):] if self.order > 1 else [])
        ngram = hist + (next_token,)
        count = self.counts.get(ngram, 0)
        total = self.total_counts.get(hist, 0)
        if total == 0:
            return -10.0
        return math.log(count / total + 1e-10)
