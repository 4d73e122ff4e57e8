"""CLIP BPE tokenizer (port of dream2real_tpu/clip/tokenizer.py).

Wraps transformers' CLIPTokenizerFast when its vocab files exist locally;
otherwise a deterministic hash tokenizer whose ids equal the reference's
fallback id for id, so both packages score the same captions alike.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence

import numpy as np

_SOT = 49406
_EOT = 49407


class ClipTokenizer:
    def __init__(self, path: str | None = None, context_length: int = 77, vocab_size: int = 49408):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.is_semantic = False
        self._tok = None
        path = path or os.environ.get("D2R_CLIP_PATH") or "openai/clip-vit-large-patch14-336"
        try:
            from transformers import CLIPTokenizerFast

            self._tok = CLIPTokenizerFast.from_pretrained(path, local_files_only=True)
            self.is_semantic = True
        except Exception:  # no transformers, or no local vocab files
            self._tok = None

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> (B, context_length) int32 ids with SOT/EOT framing."""
        if self._tok is not None:
            out = self._tok(
                list(texts),
                padding="max_length",
                truncation=True,
                max_length=self.context_length,
                return_tensors="np",
            )
            return out["input_ids"].astype(np.int32)
        return hash_tokenize(texts, self.context_length, self.vocab_size)


def hash_tokenize(texts: Sequence[str], context_length: int = 77,
                  vocab_size: int = 49408) -> np.ndarray:
    """Deterministic fallback: one pseudo-token per whitespace word (md5 of
    the word); EOT keeps the highest id so encode_text's argmax pooling finds
    the end. (B, context_length) int32."""
    ids = np.zeros((len(texts), context_length), np.int32)
    for r, text in enumerate(texts):
        toks = [_SOT]
        for word in text.lower().strip().split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            toks.append(1 + (h % (vocab_size - 3)))
            if len(toks) >= context_length - 1:
                break
        toks.append(_EOT)
        ids[r, : len(toks)] = toks
    return ids
