"""Byte-level BPE tokenizer (GPT-2 style, what Whisper uses), a copy of
``wealy_tpu.data.tokenizer``.

Pure Python and offline: it reads ``vocab.json`` and ``merges.txt`` (and an
optional ``special_tokens.json``) from a directory the user gives. It turns
the token ids of a transcription (``models/whisper/generate.py``) into text
for the validity census (``data/transcription.py``).

Special tokens (``<|...|>``) pass through verbatim on decode and are dropped
with ``skip_special=True``.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode mapping (printable chars stay
    themselves; the rest map into a private range)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_PRETOKEN_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


class ByteLevelBPE:
    """vocab.json (token -> id) + merges.txt (one merge pair per line)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.special = dict(special_tokens or {})
        for tok, idx in self.special.items():
            self.ids_to_tokens.setdefault(idx, tok)
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str | Path) -> "ByteLevelBPE":
        path = Path(path)
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for line in (path / "merges.txt").read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        special = {}
        sp_path = path / "special_tokens.json"
        if sp_path.exists():
            special = json.loads(sp_path.read_text(encoding="utf-8"))
        return cls(vocab, merges, special)

    # -- encoding -------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _PRETOKEN_RE.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                ids.append(self.vocab[sub])
        return ids

    # -- decoding -------------------------------------------------------
    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        parts: List[str] = []
        for i in ids:
            tok = self.ids_to_tokens.get(int(i))
            if tok is None:
                continue
            if tok.startswith("<|") and tok.endswith("|>"):
                if not skip_special:
                    parts.append(tok)
                continue
            parts.append(tok)
        text = "".join(parts)
        data = bytearray()
        for ch in text:
            if ch in self.byte_decoder:
                data.append(self.byte_decoder[ch])
            else:
                data.extend(ch.encode("utf-8"))
        return data.decode("utf-8", errors="replace")
