"""Byte-level BPE tokenizer (GGUF ``tokenizer.ggml.model == "gpt2"``).

Counterpart of tokenhawk_tpu/tokenizer_bpe.py with the same public
surface (BpeTokenizer, from_gguf_metadata, bos_id / eos_id / eog_ids,
encode / encode_prompt / decode / decode_token_bytes, the byte table,
specials matched longest-first).  One change: the reference splits text
with the ``regex`` module's ``\\p{L}`` / ``\\p{N}`` patterns, and the GPU
machine has no ``regex``.  The two pre-tokenizer patterns are written out
here as a hand-made scanner that gives the same pieces:

  _GPT2_PRE    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
               |\\s+(?!\\S)|\\s+
  _LLAMA3_PRE  (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}
               | ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

At each position the first alternative that matches wins, as in the
regex engine.  Letters are ``unicodedata.category(c)[0] == "L"``, numbers
``"N"``; whitespace is ``regex``'s ``\\s`` (Unicode White_Space), which
unlike ``str.isspace()`` excludes U+001C-U+001F.  Python 3.12's
``unicodedata`` is Unicode 15.0: code points assigned later (letters or
numbers to a newer ``regex``) count as neither here (ROADMAP Queue 3).
The specials are matched with the standard library's ``re``.
"""

from __future__ import annotations

import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# token_type values (tokenizer.ggml.token_type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

# regex's \s: the Unicode White_Space property.
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
# The characters regex's (?i:...) takes for each letter of the contractions.
_FOLD = {"s": "sS\u017f", "t": "tT", "r": "rR", "e": "eE", "v": "vV", "m": "mM",
         "l": "lL", "d": "dD"}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")

_GPT2 = "gpt2"
_LLAMA3 = "llama3"
# Pre-tokenizer patterns keyed by tokenizer.ggml.pre (as the reference's).
_PRE_PATTERNS = {
    "default": _GPT2,
    "gpt-2": _GPT2,
    "gpt2": _GPT2,
    "llama-bpe": _LLAMA3,
    "llama3": _LLAMA3,
    "llama-v3": _LLAMA3,
    "smaug-bpe": _LLAMA3,
}


@lru_cache(maxsize=65536)
def char_class(c: str) -> str:
    """"L" (letter), "N" (number), "S" (regex's \\s) or "O" (other)."""
    if c in _WHITESPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "O"


def _run(cls: List[str], i: int, kind: str) -> int:
    """End of the run of class `kind` that starts at i."""
    n = len(cls)
    while i < n and cls[i] == kind:
        i += 1
    return i


def _contraction(text: str, i: int, fold: bool) -> int:
    """End of a contraction at i ('s, 't, 're, 've, 'm, 'll, 'd), or -1."""
    if text[i] != "'":
        return -1
    for c in _CONTRACTIONS:
        j = i + 1 + len(c)
        if j <= len(text) and all(
                (ch in _FOLD[want]) if fold else ch == want
                for ch, want in zip(text[i + 1:j], c)):
            return j
    return -1


def _whitespace(text: str, cls: List[str], i: int, llama3: bool) -> int:
    """End of the match of the whitespace alternatives at i (cls[i] == "S"):
    (llama3 only) \\s*[\\r\\n]+, then \\s+(?!\\S), then \\s+."""
    k = _run(cls, i, "S")
    if llama3:
        for j in range(k - 1, i - 1, -1):
            if text[j] in "\r\n":
                return j + 1
    if k == len(text) or k - i == 1:
        return k  # at the end, or \s+(?!\S) fails and \s+ takes the one
    return k - 1  # \s+(?!\S): the run less its last, which precedes \S


def _gpt2_end(text: str, cls: List[str], i: int) -> int:
    j = _contraction(text, i, fold=False)
    if j >= 0:
        return j
    n = len(text)
    c = cls[i]
    if text[i] == " " and i + 1 < n and cls[i + 1] in "LNO":
        return _run(cls, i + 1, cls[i + 1])  # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+'
    if c in "LNO":
        return _run(cls, i, c)
    return _whitespace(text, cls, i, llama3=False)


def _llama3_end(text: str, cls: List[str], i: int) -> int:
    j = _contraction(text, i, fold=True)
    if j >= 0:
        return j
    n = len(text)
    c = cls[i]
    nxt = cls[i + 1] if i + 1 < n else ""
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if c in "SO" and text[i] not in "\r\n" and nxt == "L":
        return _run(cls, i + 1, "L")
    if c == "L":
        return _run(cls, i, "L")
    if c == "N":  # \p{N}{1,3}
        return min(_run(cls, i, "N"), i + 3)
    #  ?[^\s\p{L}\p{N}]+[\r\n]*
    start = i + 1 if text[i] == " " and nxt == "O" else i
    if cls[start] == "O":
        j = _run(cls, start, "O")
        while j < n and text[j] in "\r\n":
            j += 1
        return j
    return _whitespace(text, cls, i, llama3=True)


def pre_tokenize(text: str, pattern: str) -> List[str]:
    """Split `text` as the reference's pre-tokenizer regex does."""
    cls = [char_class(c) for c in text]
    end = _llama3_end if pattern == _LLAMA3 else _gpt2_end
    out, i = [], 0
    while i < len(text):
        j = end(text, cls, i)
        out.append(text[i:j])
        i = j
    return out


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table.

    Printable ASCII and the latin-1 block map to themselves; the
    remaining 68 bytes map to U+0100.. so every byte has a visible,
    unambiguous spelling inside vocab strings."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    table: Dict[int, str] = {b: chr(b) for b in keep}
    n = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(0x100 + n)
            n += 1
    return table


@lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


class BpeTokenizer:
    def __init__(
        self,
        tokens: Sequence[str],
        merges: Sequence[str],
        token_types: Optional[Sequence[int]] = None,
        pre: str = "default",
        bos_id: Optional[int] = None,
        eos_id: Optional[int] = None,
        add_bos: bool = True,
    ):
        self.id_to_token: List[str] = list(tokens)
        self.token_to_id: Dict[str, int] = {}
        for i, t in enumerate(self.id_to_token):
            self.token_to_id.setdefault(t, i)
        self.token_types = (list(token_types) if token_types is not None
                            else [NORMAL] * len(tokens))
        # merges lines are "left right" in byte-level-unicode space; rank
        # = line order (lower merges first).
        self.ranks: Dict[Tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            a, sep, b = m.partition(" ")
            if not sep:
                raise ValueError(f"malformed BPE merge line {m!r}")
            self.ranks[(a, b)] = i
        if not self.ranks:
            raise ValueError("gpt2 tokenizer requires a non-empty merge table")

        pat = _PRE_PATTERNS.get(pre)
        if pat is None:
            print(f"tokenizer: unknown pre-tokenizer {pre!r}, "
                  "falling back to gpt-2 splitting", file=sys.stderr)
            pat = _GPT2
        self.pre = pre
        self._pattern = pat

        self.bos_id = bos_id if bos_id is not None else -1
        self.eos_id = eos_id if eos_id is not None else -1
        self.add_bos = add_bos

        # Specials: matched literally (longest first) before the split.
        # CONTROL and USER_DEFINED types.
        self._specials: Dict[str, int] = {}
        for i, (t, ty) in enumerate(zip(self.id_to_token, self.token_types)):
            if ty in (CONTROL, USER_DEFINED):
                self._specials.setdefault(t, i)
        self._special_re = None
        if self._specials:
            alts = sorted(self._specials, key=len, reverse=True)
            self._special_re = re.compile("|".join(re.escape(s) for s in alts))

        # End-of-generation ids: eos plus common chat terminators present
        # in the vocab (Llama-3 instruct stops on <|eot_id|>/<|eom_id|>).
        self.eog_ids = {self.eos_id} if self.eos_id >= 0 else set()
        for name in ("<|eot_id|>", "<|eom_id|>", "<|end_of_text|>",
                     "<|im_end|>", "<|end|>"):
            tid = self.token_to_id.get(name)
            if tid is not None and self.token_types[tid] == CONTROL:
                self.eog_ids.add(tid)

        self._byte_enc = bytes_to_unicode()
        self._byte_dec = unicode_to_bytes()

    @property
    def n_vocab(self) -> int:
        return len(self.id_to_token)

    # -- encoding ----------------------------------------------------------

    @lru_cache(maxsize=16384)
    def _bpe(self, word: str) -> Tuple[str, ...]:
        """Merge one pre-token (byte-level-unicode string) by rank."""
        parts: List[str] = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return tuple(parts)

    def _encode_chunk(self, text: str, out: List[int]) -> None:
        for piece_text in pre_tokenize(text, self._pattern):
            word = "".join(self._byte_enc[b] for b in piece_text.encode("utf-8"))
            for piece in self._bpe(word):
                tid = self.token_to_id.get(piece)
                if tid is not None:
                    out.append(tid)
                else:  # unreachable with a complete byte-level vocab
                    out.extend(
                        t for t in (self.token_to_id.get(c) for c in piece)
                        if t is not None)

    def encode(self, text: str, add_bos: bool = True,
               parse_special: bool = True) -> List[int]:
        """text -> ids.  ``add_bos`` is further gated by the file's
        ``tokenizer.ggml.add_bos_token`` flag.  ``parse_special`` maps
        special-token spellings in the text to their ids (chat-template
        output needs this); pass False to treat user text opaquely."""
        out: List[int] = []
        if add_bos and self.add_bos and self.bos_id >= 0:
            out.append(self.bos_id)
        if not text:
            return out
        if parse_special and self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    self._encode_chunk(text[pos : m.start()], out)
                out.append(self._specials[m.group()])
                pos = m.end()
            if pos < len(text):
                self._encode_chunk(text[pos:], out)
        else:
            self._encode_chunk(text, out)
        return out

    def encode_prompt(self, text: str, add_bos: bool = True) -> List[int]:
        """Byte-level BPE has no SentencePiece dummy-space prefix: the
        pre-tokenizer already attaches a leading space to word pieces, so
        prompts encode as-is."""
        return self.encode(text, add_bos=add_bos)

    # -- decoding ----------------------------------------------------------

    def decode_token_bytes(self, token_id: int) -> bytes:
        if not (0 <= token_id < len(self.id_to_token)):
            return b""
        ty = self.token_types[token_id]
        if ty == CONTROL:
            return b""  # control markers don't render (llama.cpp parity)
        piece = self.id_to_token[token_id]
        if ty == USER_DEFINED:
            return piece.encode("utf-8")
        if ty == BYTE and piece.startswith("<0x") and piece.endswith(">"):
            return bytes([int(piece[3:-1], 16)])
        dec = self._byte_dec
        return bytes(dec.get(c, 0x3F) for c in piece)  # '?' never hit

    def decode(self, ids: Iterable[int]) -> str:
        return b"".join(
            self.decode_token_bytes(i) for i in ids
        ).decode("utf-8", errors="replace")

    # -- construction --------------------------------------------------

    @staticmethod
    def from_gguf_metadata(md: Dict) -> "BpeTokenizer":
        tokens = md["tokenizer.ggml.tokens"]
        merges = md.get("tokenizer.ggml.merges")
        if not merges:
            raise ValueError(
                "gpt2-model GGUF is missing tokenizer.ggml.merges")
        return BpeTokenizer(
            tokens,
            merges,
            token_types=md.get("tokenizer.ggml.token_type"),
            pre=md.get("tokenizer.ggml.pre", "default"),
            bos_id=md.get("tokenizer.ggml.bos_token_id"),
            eos_id=md.get("tokenizer.ggml.eos_token_id"),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", True)),
        )
