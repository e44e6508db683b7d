"""CLIP byte-level BPE tokenizer.

Counterpart of ``dvdx_tpu/models/tokenizer.py``: lowercasing and whitespace
cleanup, the CLIP split pattern, the byte -> unicode alphabet, end-of-word
``</w>`` BPE with ranked merges, ``<|startoftext|>`` / ``<|endoftext|>``
framing and EOS padding, over the ``vocab.json`` / ``merges.txt`` of a
diffusers checkpoint's ``tokenizer/`` folder.

Token ids are part of the Proof-of-Inference chain: a miner and a validator
must derive the same ids from a prompt. The reference's ids depend on what is
installed: it splits with the ``regex`` package and normalises through
``transformers``' ``BasicTokenizer`` only where ``transformers`` imports.
This module depends on neither. It implements that normalisation
(``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``: control
characters dropped, whitespace made spaces, spaces around CJK ideographs,
NFC, lowercase) and the split pattern's classes

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

(case-insensitive) with ``unicodedata`` itself, so the ids are the same on
every host with the same Python (whose Unicode tables decide the letter and
number classes). Two cases of the case-insensitive pattern are kept: the
long s (U+017F) matches the ``s`` of the literals, and U+0345, whose case
fold is a letter, falls in neither class and is skipped.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
# the pattern's literal alternatives, in its order
_LITERALS = (BOS_TOKEN, EOS_TOKEN, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# characters the case-insensitive pattern matches neither as a letter nor as
# "other": U+0345 folds to a letter (iota) but is a mark
_SKIPPED = frozenset("\u0345")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 / CLIP reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def normalize(text: str) -> str:
    """``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``'s
    tokens joined by spaces, then CLIP's whitespace cleanup and lowercase."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split()).lower()


def _kind(ch: str) -> str:
    """The pattern's class of one character: "L" (letter), "N" (number),
    "O" (neither, not whitespace), or "" (matched by no class)."""
    if ch.isspace() or ch in _SKIPPED:
        return ""
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _literal_at(text: str, i: int) -> int:
    """Length of the pattern literal starting at text[i], 0 if none."""
    for lit in _LITERALS:
        seg = text[i:i + len(lit)]
        if len(seg) == len(lit) and seg.replace("\u017f", "s") == lit:
            return len(lit)
    return 0


def pretokenize(text: str) -> List[str]:
    """The CLIP pattern's ``findall`` over normalised (lowercase) text."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + _literal_at(text, i)
        if j == i:
            kind = _kind(text[i])
            if not kind:
                i += 1
                continue
            j = i + 1
            if kind != "N":
                while j < n and _kind(text[j]) == kind:
                    j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPBPETokenizer:
    """text -> int32 ids, the same ids as the CLIP tokenizer given the same
    vocab / merges files."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 bos_token: str = BOS_TOKEN, eos_token: str = EOS_TOKEN,
                 model_max_length: int = 77):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token, self.eos_token = bos_token, eos_token
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.eos_id  # CLIP pads with <|endoftext|>
        self.model_max_length = model_max_length
        self._cache: Dict[str, str] = {bos_token: bos_token, eos_token: eos_token}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "CLIPBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # the first line is the "#version:" header
        merges = [tuple(line.split()) for line in lines[1:]
                  if line and len(line.split()) == 2]
        return cls(vocab, merges, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPBPETokenizer":
        """From a diffusers checkpoint's ``tokenizer/`` folder."""
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"), **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
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
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for token in pretokenize(normalize(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            toks.extend(self.bpe(token).split(" "))
        return toks

    def encode(self, text: str) -> List[int]:
        """Token ids without the special tokens."""
        return [self.vocab[t] for t in self.tokenize(text)]

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Batch encode: [BOS] ids[:L-2] [EOS], EOS-padded to max_length ->
        (B, max_length) int32."""
        if isinstance(texts, str):
            texts = [texts]
        length = max_length or self.model_max_length
        out = np.full((len(texts), length), self.pad_id, np.int32)
        for r, text in enumerate(texts):
            ids = [self.bos_id] + self.encode(text)[: length - 2] + [self.eos_id]
            out[r, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks = [self.decoder[int(i)] for i in ids if int(i) in self.decoder]
        if skip_special:
            toks = [t for t in toks if t not in (self.bos_token, self.eos_token)]
        text = "".join(toks).replace("</w>", self.byte_encoder[ord(" ")])
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").strip()


def build_test_vocab(words: Sequence[str]) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A small BPE (vocab, merges) trained greedily on pair counts over
    ``words`` (at most 128 merges), for tests and synthetic checkpoints: the
    byte alphabet, its ``</w>`` forms, the merges, then BOS and EOS last."""
    b2u = bytes_to_unicode()
    alphabet = list(b2u.values())
    vocab_list = alphabet + [a + "</w>" for a in alphabet]
    merges: List[Tuple[str, str]] = []
    corpus: Dict[Tuple[str, ...], int] = {}
    for w in words:
        enc = "".join(b2u[b] for b in w.encode("utf-8"))
        key = tuple(enc[:-1]) + (enc[-1] + "</w>",)
        corpus[key] = corpus.get(key, 0) + 1
    for _ in range(128):
        counts: Dict[Tuple[str, str], int] = {}
        for word, n in corpus.items():
            for p in zip(word[:-1], word[1:]):
                counts[p] = counts.get(p, 0) + n
        if not counts:
            break
        best = max(sorted(counts), key=lambda p: counts[p])
        if counts[best] < 2:
            break
        merges.append(best)
        merged = best[0] + best[1]
        vocab_list.append(merged)
        new_corpus: Dict[Tuple[str, ...], int] = {}
        for word, n in corpus.items():
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_corpus[tuple(out)] = new_corpus.get(tuple(out), 0) + n
        corpus = new_corpus
    vocab_list += [BOS_TOKEN, EOS_TOKEN]
    return {tok: i for i, tok in enumerate(vocab_list)}, merges


def write_tokenizer_files(dirpath: str, vocab: Dict[str, int],
                          merges: Sequence[Tuple[str, str]]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(dirpath, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
