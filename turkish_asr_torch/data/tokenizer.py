# Copied from turkish_asr_tpu/data/tokenizer.py; only the imports and the form of the
# reference-file citations differ. The JAX package's own __init__ files
# import JAX, so this jax-free host module cannot be imported from there.
"""Tokenizers for Turkish ASR.

The reference wraps HF ``alibayram/turkish-mft-tokenizer``
(reference data/tokenizer.py:4-56) and uses its ``pad_token_id`` as
the CTC blank inside ``ctc_decode`` while the loss uses blank=0 — quirk 1
in SURVEY.md §2. This build pins the sane contract: **blank = 0
everywhere**. When the HF tokenizer is available (cached locally; this
framework never requires network), we keep the reference's
pad-token-as-blank decode behavior for checkpoint/decode parity; the
built-in fallback CharTokenizer guarantees pad_token_id == 0 == blank.

``ctc_decode`` reproduces the reference collapse exactly: drop a token if
it equals the *immediately preceding raw* token (blank included in the
"previous" tracking), then drop blanks.
"""

BLANK_ID = 0

# Turkish alphabet + digits + common punctuation. Index 0 is the CTC blank
# (doubling as pad), index 1 is <unk>.
_TURKISH_CHARS = (
    " abcçdefgğhıijklmnoöpqrsştuüvwxyz"
    "0123456789"
    ".,!?'\"-:;()"
)


class CharTokenizer:
    """Deterministic character-level tokenizer (no external assets).

    id 0 = blank/pad, id 1 = <unk>, then the fixed Turkish charset.
    """

    def __init__(self, extra_chars=""):
        charset = _TURKISH_CHARS + "".join(
            c for c in extra_chars if c not in _TURKISH_CHARS
        )
        self._itos = ["<blank>", "<unk>"] + list(charset)
        self._stoi = {c: i for i, c in enumerate(self._itos)}
        self.pad_token_id = BLANK_ID
        self.unk_token_id = 1

    @property
    def vocab_size(self):
        return len(self._itos)

    @property
    def chars(self):
        return range(self.vocab_size)

    def encode(self, text):
        text = text.lower()
        return [self._stoi.get(c, self.unk_token_id) for c in text]

    def decode(self, ids):
        out = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.unk_token_id):
                continue
            if 0 <= i < len(self._itos):
                out.append(self._itos[i])
        return "".join(out)

    def ctc_decode(self, ids):
        return self.decode(_ctc_collapse(ids, self.pad_token_id))


def _ctc_collapse(ids, blank_id):
    """Reference collapse (reference data/tokenizer.py:33-56):
    keep a token only when it differs from the previous raw token and is
    not blank."""
    filtered = []
    last = None
    for curr in ids:
        curr = int(curr)
        if curr != last:
            if curr != blank_id:
                filtered.append(curr)
        last = curr
    return filtered


def load_tokenizer(tokenizer_path=None):
    """Tokenizer factory: a ``.json`` path loads a BPETokenizer trained by
    spm_train.py (the reference trains one but never wires it —
    SURVEY.md §2 spm_train row; here it is usable end-to-end); anything
    else (or None) builds the default TurkishTokenizer."""
    if tokenizer_path and tokenizer_path.endswith(".json"):
        from turkish_asr_torch.data.bpe import BPETokenizer
        return BPETokenizer.load(tokenizer_path)
    if tokenizer_path:
        return TurkishTokenizer(model_name=tokenizer_path)
    return TurkishTokenizer()


class TurkishTokenizer:
    """HF AutoTokenizer wrapper with an offline char-level fallback.

    Contract-compatible with the reference TurkishTokenizer: ``encode``,
    ``decode(skip_special_tokens)``, ``ctc_decode`` (collapse repeats, drop
    blank == pad_token_id), ``vocab_size``, ``chars``.
    """

    def __init__(self, model_name="alibayram/turkish-mft-tokenizer",
                 fallback="char"):
        self.backend = None
        self.tokenizer = None
        if model_name:
            try:
                from transformers import AutoTokenizer
                self.tokenizer = AutoTokenizer.from_pretrained(
                    model_name, trust_remote_code=True, local_files_only=True
                )
                if self.tokenizer.pad_token is None:
                    self.tokenizer.pad_token = self.tokenizer.eos_token
                self.backend = "hf"
            except Exception:
                self.tokenizer = None
        if self.tokenizer is None:
            if fallback != "char":
                raise RuntimeError(
                    f"Tokenizer '{model_name}' unavailable offline and no fallback"
                )
            self.tokenizer = CharTokenizer()
            self.backend = "char"

    @property
    def vocab_size(self):
        if self.backend == "hf":
            return len(self.tokenizer)
        return self.tokenizer.vocab_size

    @property
    def chars(self):
        return range(self.vocab_size)

    @property
    def pad_token_id(self):
        return self.tokenizer.pad_token_id

    @property
    def blank_id(self):
        """CTC blank. Loss always uses 0; decode uses pad_token_id to match
        the reference's behavior (identical to 0 for the char fallback)."""
        return BLANK_ID

    def encode(self, text):
        return self.tokenizer.encode(text)

    def decode(self, ids):
        ids = [int(i) for i in ids]
        if self.backend == "hf":
            return self.tokenizer.decode(ids, skip_special_tokens=True)
        return self.tokenizer.decode(ids)

    def ctc_decode(self, ids):
        blank = self.tokenizer.pad_token_id
        filtered = _ctc_collapse(ids, blank)
        return self.decode(filtered)
