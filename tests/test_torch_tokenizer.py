"""The port's CLIP BPE tokenizer against the JAX package's and against
``transformers.CLIPTokenizer``, all three built from the same locally trained
vocabulary (the real CLIP vocabulary cannot be downloaded here).

Tolerance: none. Token ids enter the Proof-of-Inference chain, so they must
be exactly equal, and the port's must not depend on whether ``regex`` or
``transformers`` can be imported.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dvdx_tpu.models.tokenizer import CLIPBPETokenizer as JTokenizer
from dvdx_tpu.models.tokenizer import build_test_vocab as jbuild_test_vocab
from dvdx_tpu_torch.models.tokenizer import (CLIPBPETokenizer, build_test_vocab,
                                             bytes_to_unicode, normalize, pretokenize,
                                             write_tokenizer_files)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAIN_WORDS = ["a", "the", "red", "panda", "climbing", "tree", "snowy", "mountain",
               "video", "of", "cat", "playing", "with", "ball", "in", "garden",
               "café", "naïve", "日本", "北京", "1234", "straße", "ſtar"]

CORPUS = [
    "a red panda climbing a snowy tree",
    "A RED PANDA   climbing!!",
    "the cat's ball, isn't it? THEY'LL've'D'M",
    "café crème brûlée, naïve Ångström, Ελληνικά ΣΊΣΥΦΟΣ",
    "日本の北京ダック 한국어 繁體字 中文测试",
    "control\x00chars\x07and\x1b[0m​zero width﻿�",
    "tabs\tnew\nlines\r\x0bvertical\x0cfeed\x85next\xa0nbsp　ideographic",
    "digits 0123456789 ٣٤٥ ½ ² Ⅻ 4k 1080p",
    "emoji 😀🎬 and symbols ©®™ → ∞ ≈",
    "ſtar 'ſ ǅungla İstanbul Kelvin K",
    "combining é vs é, ͅ alone, ᾳ",
    "punctuation:;'\"!?-_=+ ... (fast) [test] {x} #tag @user",
    "",
    "  leading and   trailing   whitespace  ",
    " ".join(["panda"] * 120),  # past 77 tokens: truncated
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    vocab, merges = build_test_vocab(TRAIN_WORDS * 3 + ["climbing", "panda"])
    d = tmp_path_factory.mktemp("tok")
    write_tokenizer_files(str(d), vocab, merges)
    return str(d)


def test_test_vocab_matches_reference():
    assert build_test_vocab(TRAIN_WORDS * 3) == jbuild_test_vocab(TRAIN_WORDS * 3)
    m = bytes_to_unicode()
    assert len(m) == 256 and len(set(m.values())) == 256


@pytest.mark.parametrize("text", CORPUS)
def test_ids_equal_reference_and_transformers(tok_dir, text):
    from transformers import CLIPTokenizer

    ours = CLIPBPETokenizer.from_dir(tok_dir)
    theirs = CLIPTokenizer(vocab_file=f"{tok_dir}/vocab.json",
                           merges_file=f"{tok_dir}/merges.txt")
    assert ours.encode(text) == JTokenizer.from_dir(tok_dir).encode(text)
    assert ours.encode(text) == theirs.encode(text, add_special_tokens=False)


def test_batch_encode_matches_transformers_padded(tok_dir):
    from transformers import CLIPTokenizer

    ours = CLIPBPETokenizer.from_dir(tok_dir)
    theirs = CLIPTokenizer(vocab_file=f"{tok_dir}/vocab.json",
                           merges_file=f"{tok_dir}/merges.txt")
    got = ours(CORPUS, max_length=77)
    want = theirs(CORPUS, padding="max_length", max_length=77, truncation=True,
                  return_tensors="np").input_ids
    assert got.dtype == np.int32 and got.shape == (len(CORPUS), 77)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got, JTokenizer.from_dir(tok_dir)(CORPUS, max_length=77))
    long = got[-1]
    assert long[0] == ours.bos_id and long[-1] == ours.eos_id and (long != ours.eos_id).sum() == 76


def test_special_tokens_in_text_match_reference(tok_dir):
    """The pattern's literal special tokens (and the long s folded into
    them) as the reference's case-insensitive pattern splits them."""
    ours, ref = CLIPBPETokenizer.from_dir(tok_dir), JTokenizer.from_dir(tok_dir)
    for text in ("a <|endoftext|> b", "!<|startoftext|>", "<|ſtartoftext|>x", "'ſ 'S"):
        assert ours.encode(text) == ref.encode(text), text
    assert pretokenize(normalize("It'S <|EndOfText|>")) == ["it", "'s", "<|endoftext|>"]


def test_decode_roundtrip(tok_dir):
    ours = CLIPBPETokenizer.from_dir(tok_dir)
    assert ours.decode(ours.encode("a red panda climbing")) == "a red panda climbing"
    assert ours.decode(ours([("café 日本")])[0]) == "café 日 本"


def test_ids_do_not_depend_on_regex_or_transformers(tok_dir):
    """The same ids in a process where ``regex`` and ``transformers`` cannot
    be imported."""
    code = ("import sys, json\n"
            "for name in ('regex', 'transformers', 'jax', 'dvdx_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from dvdx_tpu_torch.models.tokenizer import CLIPBPETokenizer\n"
            f"tok = CLIPBPETokenizer.from_dir({tok_dir!r})\n"
            f"print(json.dumps(tok({CORPUS!r}, max_length=77).tolist()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    import json

    blocked = np.asarray(json.loads(proc.stdout), np.int32)
    np.testing.assert_array_equal(blocked, CLIPBPETokenizer.from_dir(tok_dir)(CORPUS, 77))
