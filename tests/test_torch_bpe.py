"""The port's byte-level BPE tokenizer against the JAX package's.

The reference pre-tokenizes with the `regex` module's \\p{L} / \\p{N}
patterns; the port, whose GPU machine has no `regex`, with a hand-written
scanner over unicodedata's classes.  Held here, exactly:
  - the scanner's pieces equal regex.findall of the reference's two
    patterns (gpt2 and llama-bpe) on a corpus and on seeded random
    strings over an alphabet of every class the patterns tell apart;
  - token ids of BpeTokenizer equal the reference's on the corpus, with
    specials, under both patterns, and decode gives the same bytes;
  - the character classes agree with regex's on every code point that
    unicodedata assigns (Unicode 15.0 in Python 3.12).  The code points
    that regex's newer Unicode assigns as letters or numbers and
    unicodedata does not are "other" to the port (ROADMAP Queue 3).
"""

import unicodedata

import numpy as np
import pytest
import regex

from tokenhawk_tpu import tokenizer_bpe as j_bpe
from tokenhawk_tpu_torch import tokenizer_bpe as t_bpe
from tokenhawk_tpu_torch.ggml.synth import bpe_vocab_metadata

CORPUS = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "I'll say he's done it, they're sure, we've won, you'd know, I'm in.",
    "I'LL SAY HE'S DONE IT, THEY'RE SURE, WE'VE WON, YOU'D KNOW, I'M IN",
    "long s: it\u017f and it'\u017f, quote'", "''s 's' x'  'll",
    "x = 1234567890 + 3.14159; 12 123 1234 12345",
    "  leading and   internal   spaces  ", "trailing   ",
    "line one\nline two\r\n\r\n\ttabbed\n\n\n  \n x",
    " \n\n  word \r\n\r\n  \t\n",
    "naïve café — déjà vu überholt",
    "日本語のテキストと漢字、한국어 텍스트, Ελληνικά, русский текст",
    "emoji: 🚀🧪✨ and ½ fractions ²³ Ⅻ ٣٤٥",
    "mixed: abc123def456 foo_bar-baz@example.com",
    "quotes \"double\" and 'single' and `back`",
    "separators \x1c\x1d\x1e\x1f next \x85 nel \xa0nbsp em\u2003ideo\u3000space",
    "combining e\u0301 a\u0308 \u200b zwsp",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nHi!<|eot_id|>",
    "text <|eot_id|>tail<|end_of_text|>",
    "", " ", "\n", "a", "'", "1",
]

# Characters of every class the two patterns distinguish.
ALPHABET = list("aZ'sStTrRvVmMlLdD\u017f0 19\r\n\t\x0b\x0c\x1c\x1f\x85\xa0\u2003\u3000"
                "!?.,-_@#\u00e9\u0301\u0663\u00bd\u2167\u65e5\U0001F680\u200b")

PATTERNS = {"gpt2": j_bpe._GPT2_PRE, "llama-bpe": j_bpe._LLAMA3_PRE}


def _fuzz(n, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET, size=rng.integers(1, 24))) for _ in range(n)]


@pytest.mark.parametrize("pre", list(PATTERNS))
def test_pre_tokenizer_pieces_match_regex(pre):
    compiled = regex.compile(PATTERNS[pre])
    scan = t_bpe._PRE_PATTERNS[pre]
    for text in CORPUS + _fuzz(3000, len(pre)):
        assert t_bpe.pre_tokenize(text, scan) == compiled.findall(text), repr(text)


@pytest.fixture(scope="module")
def metadata():
    return bpe_vocab_metadata(2048, np.random.default_rng(3), n_special=32)


@pytest.mark.parametrize("pre", ["gpt2", "llama-bpe"])
def test_token_ids_match_reference(metadata, pre):
    md = dict(metadata, **{"tokenizer.ggml.pre": pre})
    j, t = j_bpe.BpeTokenizer.from_gguf_metadata(md), t_bpe.BpeTokenizer.from_gguf_metadata(md)
    assert (t.bos_id, t.eos_id, t.eog_ids, t.n_vocab) == (j.bos_id, j.eos_id, j.eog_ids, j.n_vocab)
    assert t.eog_ids == {2016 + 1, 2016 + 9}  # <|end_of_text|> and <|eot_id|>
    for text in CORPUS + _fuzz(300, 7):
        for special in (True, False):
            ids = j.encode(text, parse_special=special)
            assert t.encode(text, parse_special=special) == ids, repr(text)
        assert t.encode_prompt(text) == j.encode_prompt(text)
        assert [t.decode_token_bytes(i) for i in ids] == [j.decode_token_bytes(i) for i in ids]
        assert t.decode(ids) == j.decode(ids)


def test_byte_table_matches_reference():
    assert t_bpe.bytes_to_unicode() == j_bpe.bytes_to_unicode()
    assert t_bpe.unicode_to_bytes() == j_bpe.unicode_to_bytes()


def test_character_classes_match_regex_on_every_assigned_code_point():
    letter, number, space = regex.compile(r"\p{L}"), regex.compile(r"\p{N}"), regex.compile(r"\s")
    differ, newer = [], {}
    for cp in range(0x110000):
        c = chr(cp)
        want = ("S" if space.match(c) else "L" if letter.match(c)
                else "N" if number.match(c) else "O")
        if unicodedata.category(c) == "Cn":  # unassigned in unicodedata's Unicode
            assert t_bpe.char_class(c) == "O"
            if want != "O":
                newer[want] = newer.get(want, 0) + 1
        elif t_bpe.char_class(c) != want:
            differ.append(hex(cp))
    assert differ == []
    print(f"unicodedata {unicodedata.unidata_version}, regex {regex.__version__}: code points "
          f"unassigned in the first and classed by the second (other to the port): {newer}")
    assert t_bpe.char_class("\x1c") == "O" and "\x1c".isspace()  # regex's \s, not isspace
    assert t_bpe.char_class("\x85") == "S"
