"""Tokenizer wrapper with trained-embedding placeholder support.

(reference: modules/modelSetup/mixin/ModelSetupEmbeddingMixin.py:25-88 —
placeholder -> N unique tokens added to the tokenizer; here placeholders
splice ids >= vocab_size which index the extra_embeddings table in
models.clip.CLIPTextModel.)

The port's copy of `SDTokenizer` from onetrainer_tpu/setup/tokenizer.py
(CLIP tokenization only); transformers is imported only when a tokenizer
directory is given.
"""

from __future__ import annotations

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
