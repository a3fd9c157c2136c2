"""CLIP byte-level BPE tokenizer in pure Python (the port's own copy of
stable_nerf_tpu/models/diffusion/tokenizer.py).

The reference tokenizes with HF's AutoTokenizer (reference
stable_diffusion/network.py:35-40), and its main path only ever encodes
the empty prompt, which ``clip_text.empty_prompt_ids`` covers without any
file.  This module loads ``vocab.json`` + ``merges.txt`` from a tokenizer
directory (HF hub layout) for any prompt, token for token as
transformers.CLIPTokenizer.

The pre-tokenizer is CLIP's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` written as a scanner over ``unicodedata`` categories,
so the port needs no ``regex`` package.  No ftfy: inputs are taken to be
well-formed unicode (HF uses ftfy only to repair mojibake).
"""

from __future__ import annotations

import functools
import html
import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def pretokenize(text: str) -> List[str]:
    """The pieces CLIP's pattern finds in ``text``, in order (whitespace
    separates pieces and belongs to none)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        piece = next((s for s in _SPECIAL + _CONTRACTIONS
                      if text[i:i + len(s)].lower() == s), None)
        if piece is None:
            j = i + 1
            if _is_letter(c):
                while j < n and _is_letter(text[j]):
                    j += 1
            elif not _is_number(c):
                while j < n and not (text[j].isspace() or _is_letter(text[j])
                                     or _is_number(text[j])):
                    j += 1
            piece = text[i:j]
        out.append(text[i:i + len(piece)])
        i += len(piece)
    return out


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP's reversible byte → printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 pad_token: Optional[str] = None, model_max_length: int = 77):
        self.vocab = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_token, self.eos_token = bos_token, eos_token
        self.pad_token = pad_token or eos_token
        self.model_max_length = model_max_length
        self.cache: Dict[str, str] = {bos_token: bos_token, eos_token: eos_token}

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPTokenizer":
        """Load an HF tokenizer directory (vocab.json + merges.txt, and
        special_tokens_map.json where present)."""
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the first line is the version header
        merges = [tuple(line.split()) for line in lines[1:] if len(line.split()) == 2]
        cfg_path = os.path.join(path, "special_tokens_map.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                sp = json.load(f)
            v = sp.get("pad_token")
            kw.setdefault("pad_token", v["content"] if isinstance(v, dict) else v)
        return cls(vocab, merges, **kw)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _clean(self, text: str) -> str:
        text = html.unescape(html.unescape(text))
        return " ".join(text.split()).strip().lower()

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no special tokens)."""
        ids: List[int] = []
        for token in pretokenize(self._clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Batch-tokenize with bos/eos, padded and truncated to
        ``max_length`` (HF's padding='max_length', truncation=True) →
        [B, max_length] int32."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.model_max_length
        bos, eos = self.vocab[self.bos_token], self.vocab[self.eos_token]
        out = np.full((len(texts), L), self.vocab[self.pad_token], np.int32)
        for i, t in enumerate(texts):
            ids = [bos] + self.encode(t)[: L - 2] + [eos]
            out[i, : len(ids)] = ids
        return out
