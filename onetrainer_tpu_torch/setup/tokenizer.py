"""Tokenizer wrapper with trained-embedding placeholder support.

(reference: modules/modelSetup/mixin/ModelSetupEmbeddingMixin.py:25-88 —
placeholder -> N unique tokens added to the tokenizer; here placeholders
splice ids >= vocab_size which index the extra_embeddings table in
models.clip.CLIPTextModel.)

The port's copies of `SDTokenizer` (CLIP), `T5TokenizerWrapper` (SD3's,
FLUX's and PixArt's T5), `GemmaTokenizerWrapper` (Sana's Gemma-2) and
`LlamaTokenizerWrapper` (HunyuanVideo's Llama) from
onetrainer_tpu/setup/tokenizer.py; transformers is imported only when a
tokenizer directory is given.
"""

from __future__ import annotations

import zlib

import numpy as np


def _splice_pieces(text: str, placeholders: dict, encode_words) -> list[int]:
    """Splice placeholder ids into `text` in TEXT order, covering every
    occurrence of every placeholder (the reference replaces placeholders
    with added tokenizer tokens, so ordering/repeats come for free there;
    here we splice spans explicitly). Overlapping matches keep the
    earliest span."""
    spans = []
    for ph, ids in placeholders.items():
        start = 0
        while True:
            i = text.find(ph, start)
            if i < 0:
                break
            spans.append((i, i + len(ph), ids))
            start = i + len(ph)
    spans.sort()
    pieces: list[int] = []
    cursor = 0
    for start, end, ids in spans:
        if start < cursor:
            continue  # overlaps an already-spliced span
        pieces.extend(encode_words(text[cursor:start]))
        pieces.extend(ids)
        cursor = end
    pieces.extend(encode_words(text[cursor:]))
    return pieces


class SDTokenizer:
    """CLIP tokenizer + placeholder splicing. Wraps a transformers
    tokenizer when available; otherwise a deterministic hash fallback so
    pipelines stay testable offline."""

    def __init__(self, tokenizer_dir: str | None = None, max_length: int = 77,
                 vocab_size: int = 49408, bos: int = 49406, eos: int = 49407):
        self.max_length = max_length
        self.vocab_size = vocab_size
        # placeholder ids index extra_embeddings appended at the MODEL's
        # table size (te_config.vocab_size, passed by the setups) — NOT
        # the HF tokenizer's vocab_size, which can be smaller (T5
        # tokenizer 32100 vs table 32128, Llama-3 128000 vs 128320); the
        # scatter base in the TE models uses the table size
        self.embedding_base = vocab_size
        self.bos = bos
        self.eos = eos
        self._tokenizer = None
        if tokenizer_dir:
            try:
                from transformers import CLIPTokenizer
                self._tokenizer = CLIPTokenizer.from_pretrained(tokenizer_dir)
                self.vocab_size = self._tokenizer.vocab_size
                self.bos = self._tokenizer.bos_token_id
                self.eos = self._tokenizer.eos_token_id
            except Exception as e:
                print(f"tokenizer load failed ({e}); using hash fallback")
        # placeholder -> list of extra ids (>= embedding_base)
        self.placeholders: dict[str, list[int]] = {}
        self._next_extra = 0

    def register_placeholder(self, placeholder: str, token_count: int) -> list[int]:
        ids = list(range(self.embedding_base + self._next_extra,
                         self.embedding_base + self._next_extra + token_count))
        self._next_extra += token_count
        self.placeholders[placeholder] = ids
        return ids

    def _encode_words(self, text: str) -> list[int]:
        if self._tokenizer is not None:
            return self._tokenizer(text, add_special_tokens=False)["input_ids"]
        # offline fallback: deterministic word hash into the vocab
        return [abs(hash(w)) % (self.vocab_size - 2) + 1
                for w in text.lower().split()]

    def encode_pieces(self, text: str) -> list[int]:
        """Token ids with placeholders spliced in TEXT order (every
        occurrence), no special tokens."""
        return _splice_pieces(text, self.placeholders, self._encode_words)

    def __call__(self, text: str) -> np.ndarray:
        """-> int32 [max_length] with BOS/EOS + eos-padding (CLIP style)."""
        pieces = self.encode_pieces(text)
        ids = [self.bos] + pieces[: self.max_length - 2] + [self.eos]
        ids = ids + [self.eos] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)


class T5TokenizerWrapper:
    """T5 tokenization (no BOS, EOS=1, PAD=0) with the same placeholder
    splicing; wraps a transformers T5Tokenizer when files are available."""

    def __init__(self, tokenizer_dir: str | None = None, max_length: int = 77,
                 vocab_size: int = 32128):
        self.max_length = max_length
        self.vocab_size = vocab_size
        # model-table size for placeholder/extra-embedding ids; the HF
        # T5 tokenizer reports 32100 but the model table is 32128
        self.embedding_base = vocab_size
        self.eos = 1
        self.pad = 0
        self._tokenizer = None
        if tokenizer_dir:
            try:
                from transformers import T5Tokenizer
                self._tokenizer = T5Tokenizer.from_pretrained(tokenizer_dir)
                self.vocab_size = self._tokenizer.vocab_size
                self.eos = self._tokenizer.eos_token_id
                self.pad = self._tokenizer.pad_token_id
            except Exception as e:
                print(f"t5 tokenizer load failed ({e}); using hash fallback")
        self.placeholders: dict[str, list[int]] = {}
        self._next_extra = 0

    def register_placeholder(self, placeholder: str, token_count: int) -> list[int]:
        ids = list(range(self.embedding_base + self._next_extra,
                         self.embedding_base + self._next_extra + token_count))
        self._next_extra += token_count
        self.placeholders[placeholder] = ids
        return ids

    def _encode_words(self, text: str) -> list[int]:
        if self._tokenizer is not None:
            return self._tokenizer(text, add_special_tokens=False)["input_ids"]
        return [abs(hash(w)) % (self.vocab_size - 2) + 2
                for w in text.lower().split()]

    def __call__(self, text: str) -> np.ndarray:
        pieces = _splice_pieces(text, self.placeholders, self._encode_words)
        ids = pieces[: self.max_length - 1] + [self.eos]
        ids = ids + [self.pad] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)


class GemmaTokenizerWrapper(T5TokenizerWrapper):
    """Gemma tokenization for Sana (BOS=2, EOS=1, PAD=0; BOS prepended, no
    EOS, padded to max_length: transformers GemmaTokenizer's defaults, as
    Sana uses it) and the keep mask the Sana DiT's cross-attention takes."""

    def __init__(self, tokenizer_dir: str | None = None, max_length: int = 300,
                 vocab_size: int = 256000):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.embedding_base = vocab_size
        self.bos = 2
        self.eos = 1
        self.pad = 0
        self._tokenizer = None
        if tokenizer_dir:
            try:
                from transformers import AutoTokenizer
                self._tokenizer = AutoTokenizer.from_pretrained(tokenizer_dir)
                self.vocab_size = self._tokenizer.vocab_size
                self.bos = self._tokenizer.bos_token_id or 2
                self.pad = self._tokenizer.pad_token_id or 0
            except Exception as e:
                print(f"gemma tokenizer load failed ({e}); using hash fallback")
        self.placeholders: dict[str, list[int]] = {}
        self._next_extra = 0

    def __call__(self, text: str) -> np.ndarray:
        pieces = _splice_pieces(text, self.placeholders, self._encode_words)
        ids = [self.bos] + pieces[: self.max_length - 1]
        ids = ids + [self.pad] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)

    def mask(self, tokens: np.ndarray) -> np.ndarray:
        return (tokens != self.pad).astype(np.int32)


class LlamaTokenizerWrapper(T5TokenizerWrapper):
    """Llama-3 tokenization for HunyuanVideo: the system prompt template
    occupies exactly CROP_START tokens before the user text (max_length =
    77 + CROP_START). The hash fallback emits deterministic filler tokens
    for the template so the crop boundary holds."""

    CROP_START = 95

    def __init__(self, tokenizer_dir: str | None = None,
                 max_length: int = 77 + 95, vocab_size: int = 128320):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.embedding_base = vocab_size
        self.bos = 128000
        self.eos = 128001
        self.pad = 128001
        self._tokenizer = None
        if tokenizer_dir:
            try:
                from transformers import AutoTokenizer
                self._tokenizer = AutoTokenizer.from_pretrained(tokenizer_dir)
                self.vocab_size = self._tokenizer.vocab_size
                self.bos = self._tokenizer.bos_token_id or self.bos
                self.pad = self._tokenizer.pad_token_id or self.eos
            except Exception as e:
                print(f"llama tokenizer load failed ({e}); using hash fallback")
        if self._tokenizer is None and self.vocab_size <= self.bos:
            # tiny test vocabularies (hash fallback only): low special ids.
            # A real Llama-3 tokenizer reports vocab_size 128000 == bos, and
            # its specials are valid, so this must not trip for it.
            self.bos, self.eos, self.pad = 2, 1, 0
        self.placeholders: dict[str, list[int]] = {}
        self._next_extra = 0

    def __call__(self, text: str) -> np.ndarray:
        from onetrainer_tpu_torch.models.hunyuan_video import DEFAULT_PROMPT_TEMPLATE
        if self._tokenizer is not None:
            if any(ph in text for ph in self.placeholders):
                # placeholder ids (>= embedding_base) spliced into the
                # templated prompt between the template's two halves
                pre, post = DEFAULT_PROMPT_TEMPLATE.split("{}")
                ids = list(self._tokenizer(pre)["input_ids"])
                ids.extend(_splice_pieces(text, self.placeholders, self._encode_words))
                ids.extend(self._tokenizer(post, add_special_tokens=False)["input_ids"])
                ids = ids[: self.max_length]
                ids = ids + [self.pad] * (self.max_length - len(ids))
                return np.asarray(ids, np.int32)
            out = self._tokenizer(
                DEFAULT_PROMPT_TEMPLATE.format(text), padding="max_length",
                truncation=True, max_length=self.max_length)
            return np.asarray(out["input_ids"], np.int32)
        pieces = _splice_pieces(text, self.placeholders, self._encode_words)
        filler = [(zlib.crc32(f"tmpl{i}".encode()) % (self.vocab_size - 4)) + 2
                  for i in range(self.CROP_START - 1)]
        ids = [self.bos] + filler + pieces[: self.max_length - self.CROP_START]
        ids = ids + [self.pad] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)

    def mask(self, tokens: np.ndarray) -> np.ndarray:
        return (tokens != self.pad).astype(np.int32)
