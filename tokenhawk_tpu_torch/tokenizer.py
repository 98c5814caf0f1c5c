# Copy of tokenhawk_tpu/tokenizer.py (imports rewritten, upstream citations as bare
# file:line): importing tokenhawk_tpu imports jax, which the GPU machine lacks.
# tests/test_torch_host.py holds the copy equal to its original.
"""SentencePiece-style greedy bigram-merge BPE tokenizer.

Behavioral parity with the reference tokenizer
(th-llama.cpp:910-1108): the input is split into UTF-8
characters, then adjacent pairs are greedily merged in order of vocab
score (ties broken toward the leftmost pair), and any leftover symbol
that is not a vocab token is emitted as byte-fallback tokens
(token id = byte value + 3).  BOS=1, EOS=2.

Implementation is a fresh design around a heap of candidate merges over a
doubly-linked symbol list (the reference uses a C++ priority_queue over
index pairs; same algorithm family, independently written).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence

BOS_ID = 1
EOS_ID = 2
_BYTE_FALLBACK_OFFSET = 3

_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def utf8_char_len(first_byte: int) -> int:
    return _UTF8_LEN[first_byte >> 4]


class Tokenizer:
    def __init__(self, tokens: Sequence[bytes], scores: Sequence[float],
                 bos_id: int = BOS_ID, eos_id: int = EOS_ID):
        self.id_to_token: List[bytes] = [
            t.encode("utf-8") if isinstance(t, str) else bytes(t) for t in tokens
        ]
        self.scores: List[float] = list(scores)
        self.token_to_id: Dict[bytes, int] = {}
        # First occurrence wins, matching insertion into a map keyed by text.
        for i, t in enumerate(self.id_to_token):
            self.token_to_id.setdefault(t, i)
        # GGUF files carry explicit ids (usually the SPM defaults 1/2);
        # ggjt v1 has no field for them, so the defaults apply.
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.eog_ids = {eos_id}

    @property
    def n_vocab(self) -> int:
        return len(self.id_to_token)

    # -- encoding --------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        out: List[int] = [self.bos_id] if add_bos else []
        if not text:
            return out

        data = text.encode("utf-8")

        # Split into UTF-8 characters: pieces[i] = bytes of symbol i.
        pieces: List[bytes] = []
        off = 0
        while off < len(data):
            n = min(len(data) - off, utf8_char_len(data[off]))
            pieces.append(data[off : off + n])
            off += n

        n_sym = len(pieces)
        prev = list(range(-1, n_sym - 1))
        nxt = list(range(1, n_sym + 1))
        nxt[-1] = -1
        alive = [True] * n_sym

        # Heap of candidate merges: (-score, left_index, merged_len).
        # Python's heapq pops the smallest, so negate the score; the
        # secondary key gives leftmost-first tie-breaking like the
        # reference comparator (th-llama.cpp:920-924).
        heap: List[tuple] = []

        def push(left: int):
            right = nxt[left]
            if left < 0 or right < 0:
                return
            merged = pieces[left] + pieces[right]
            tid = self.token_to_id.get(merged)
            if tid is None or tid >= len(self.id_to_token):
                return
            heapq.heappush(heap, (-self.scores[tid], left, len(merged)))

        for i in range(n_sym - 1):
            push(i)

        while heap:
            _, left, mlen = heapq.heappop(heap)
            right = nxt[left]
            if not alive[left] or right < 0 or not alive[right]:
                continue
            if len(pieces[left]) + len(pieces[right]) != mlen:
                continue  # stale entry: one side was merged since
            pieces[left] = pieces[left] + pieces[right]
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            push(prev[left])
            push(left)

        i = 0
        while i != -1:
            if alive[i]:
                tid = self.token_to_id.get(pieces[i])
                if tid is None:
                    for b in pieces[i]:
                        out.append(b + _BYTE_FALLBACK_OFFSET)
                else:
                    out.append(tid)
            i = nxt[i]
        return out

    def encode_prompt(self, text: str, add_bos: bool = True) -> List[int]:
        """Encode a user prompt with the SentencePiece dummy prefix.

        The reference inserts a leading space before tokenizing
        (th-llama.cpp:122) so the first word of the
        prompt gets its word-initial (U+2581) piece instead of falling
        to character/byte pieces.
        """
        return self.encode(" " + text, add_bos=add_bos)

    # -- decoding --------------------------------------------------------

    def decode_token_bytes(self, token_id: int) -> bytes:
        if not (0 <= token_id < len(self.id_to_token)):
            return b""
        piece = self.id_to_token[token_id]
        # SentencePiece byte-fallback pieces are spelled "<0xHH>" in some
        # vocab exports; emit the raw byte.
        if len(piece) == 6 and piece[:3] == b"<0x" and piece[5:] == b">":
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        # SentencePiece word-boundary marker U+2581 -> space.
        if b"\xe2\x96\x81" in piece:
            piece = piece.replace(b"\xe2\x96\x81", b" ")
        return piece

    def decode(self, ids: Sequence[int]) -> str:
        parts = []
        for i in ids:
            if i in (self.bos_id, self.eos_id):
                continue
            parts.append(self.decode_token_bytes(i))
        return b"".join(parts).decode("utf-8", errors="replace")

    # -- construction ----------------------------------------------------

    @staticmethod
    def from_vocab(vocab, bos_id: int = BOS_ID,
                   eos_id: int = EOS_ID) -> "Tokenizer":
        """Build from a ggml reader Vocab."""
        return Tokenizer(vocab.tokens, vocab.scores,
                         bos_id=bos_id, eos_id=eos_id)


def byte_fallback_vocab(extra: Dict[str, float] | None = None) -> Tokenizer:
    """A minimal vocab: specials + 256 byte tokens (+ optional merges).

    Used by tests and as a stand-in when running synthetic models.
    """
    tokens: List[bytes] = [b"<unk>", b"<s>", b"</s>"]
    scores: List[float] = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(bytes([b]))
        scores.append(-1e6)  # byte pieces merge only as a last resort
    if extra:
        for t, s in extra.items():
            tokens.append(t.encode("utf-8"))
            scores.append(s)
    return Tokenizer(tokens, scores)
