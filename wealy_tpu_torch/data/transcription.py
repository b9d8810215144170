"""Transcription validation and caching (host-side, pure Python), a copy of
``wealy_tpu.data.transcription``.

Parity: lib/audio_dataset/validator.py (heuristic ASR-on-music validity
checks) and lib/audio_dataset/cache.py (RAM cache of transcription .txt files
with disk persistence). Differences by design:
  - no nltk and no network download at import: a regex word tokenizer gives
    the same token stream for these heuristics;
  - persistence is JSON, not pickle.

Default thresholds match the reference call sites (min_words=10,
max_repetition_ratio=0.6: cache.py:127-132, dataset.py:476-481).
"""

from __future__ import annotations

import contextlib
import json
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

_MUSICAL_SYMBOLS = r"[♪♫♬♩♭♮♯\U0001d11e\U0001d122\U0001d12a\U0001d12b]"

_MUSICAL_ANNOTATIONS = [
    r"\(music\s*playing\)",
    r"\[music\]",
    r"\(music\)",
    r"\[music\s*playing\]",
    r"\(instrumental\)",
    r"\[instrumental\]",
    r"\(singing\)",
    r"\[singing\]",
    r"\(humming\)",
    r"\[humming\]",
    r"\(whistling\)",
    r"\[whistling\]",
    r"\(melody\)",
    r"\[melody\]",
    r"\(musical\s*interlude\)",
    r"\[musical\s*interlude\]",
]

_REPETITIVE_MUSICAL = [
    rf"\b({syll}\s+){{3,}}"
    for syll in ("la", "na", "da", "tra", "do", "re", "mi", "fa", "so", "ti", "doo", "bah")
]

_MUSICAL_SYLLABLES = {
    "la", "na", "da", "tra", "do", "re", "mi", "fa", "so", "ti", "doo", "bah", "hmm", "mm",
}


def _tokenize(text: str) -> list[str]:
    """Word tokens: alphanumeric runs with internal apostrophes kept."""
    return re.findall(r"[\w']+", text)


class TranscriptionValidator:
    """Heuristic validity of ASR output on music (see module docstring)."""

    def __init__(
        self,
        min_words: int = 10,
        max_repetition_ratio: float = 0.6,
        min_unique_bigrams: int = 3,
        min_unique_trigrams: int = 2,
    ):
        self.min_words = min_words
        self.max_repetition_ratio = max_repetition_ratio
        self.min_unique_bigrams = min_unique_bigrams
        self.min_unique_trigrams = min_unique_trigrams

    def clean_text(self, text: str) -> str:
        """Lowercase; strip [mm:ss] timestamps, (...) / [...] annotations,
        filler words; collapse punctuation (apostrophes kept) and whitespace."""
        if not text or not isinstance(text, str):
            return ""
        text = text.lower()
        text = re.sub(r"\[\d+:\d+\]", "", text)
        text = re.sub(r"\(.*?\)", "", text)
        text = re.sub(r"\[.*?\]", "", text)
        text = re.sub(r"\b(um|uh|ah|hmm|er|eh|mm)\b", " ", text)
        text = re.sub(r"[^\w\s']", " ", text)
        return re.sub(r"\s+", " ", text).strip()

    def is_empty_or_too_short(self, text: str) -> bool:
        cleaned = self.clean_text(text)
        if not cleaned:
            return True
        return len(_tokenize(cleaned)) < self.min_words

    def is_only_symbols(self, text: str) -> bool:
        """<5 alphanumeric characters total -> symbols-only."""
        if not text or not isinstance(text, str):
            return True
        if not re.sub(r"\s+", "", text):
            return True
        return len(re.sub(r"[^a-zA-Z0-9]", "", text)) < 5

    def is_musical_content(self, text: str) -> bool:
        """Musical symbols, (music playing)-style annotations, la-la-la runs,
        or >=70% musical-syllable words."""
        if not text or not isinstance(text, str):
            return False
        lower = text.lower()
        if re.search(_MUSICAL_SYMBOLS, text):
            residue = re.sub(r"\s+", "", re.sub(_MUSICAL_SYMBOLS, "", text))
            if len(residue) < 10:
                return True
        for pattern in _MUSICAL_ANNOTATIONS:
            if re.search(pattern, lower):
                return True
        for pattern in _REPETITIVE_MUSICAL:
            if re.search(pattern, lower):
                return True
        words = re.findall(r"\b\w+\b", lower)
        if len(words) >= 3:
            musical = sum(1 for w in words if w in _MUSICAL_SYLLABLES)
            if musical / len(words) > 0.7:
                return True
        return False

    def has_excessive_repetition(self, text: str) -> bool:
        """Bigram/trigram analysis: too few unique n-grams or one n-gram
        dominating beyond max_repetition_ratio."""
        cleaned = self.clean_text(text)
        if not cleaned:
            return True
        words = _tokenize(cleaned)
        if len(words) < 4:
            return False
        bigrams = list(zip(words, words[1:]))
        if len(bigrams) >= 2:
            top = Counter(bigrams).most_common(1)[0][1]
            if (
                len(set(bigrams)) < self.min_unique_bigrams
                or top / len(bigrams) > self.max_repetition_ratio
            ):
                return True
        if len(words) >= 6:
            trigrams = list(zip(words, words[1:], words[2:]))
            if len(trigrams) >= 2:
                top = Counter(trigrams).most_common(1)[0][1]
                if (
                    len(set(trigrams)) < self.min_unique_trigrams
                    or top / len(trigrams) > self.max_repetition_ratio
                ):
                    return True
        return False

    def has_repeated_phrases(self, text: str) -> bool:
        """One sentence accounting for >50% of all sentences.

        NOTE: the reference splits on [.!?] *after* clean_text has already
        stripped that punctuation (validator.py:213-236), which makes the
        check inert. We split the raw text first, then clean each sentence —
        the evident intent.
        """
        if not self.clean_text(text):
            return True
        sentences = [
            self.clean_text(s) for s in re.split(r"[.!?]+", text) if self.clean_text(s)
        ]
        if len(sentences) < 2:
            return False
        counts = Counter(sentences)
        return any(c / len(sentences) > 0.5 for c in counts.values())

    def is_valid_transcription(self, text: str) -> bool:
        return not (
            self.is_empty_or_too_short(text)
            or self.is_only_symbols(text)
            or self.is_musical_content(text)
            or self.has_excessive_repetition(text)
            or self.has_repeated_phrases(text)
        )

    def get_validation_details(self, text: str) -> dict:
        issues = []
        for name, check in (
            ("empty_or_too_short", self.is_empty_or_too_short),
            ("only_symbols", self.is_only_symbols),
            ("musical_content", self.is_musical_content),
            ("excessive_repetition", self.has_excessive_repetition),
            ("repeated_phrases", self.has_repeated_phrases),
        ):
            if check(text):
                issues.append(name)
        return {
            "is_valid": not issues,
            "issues": issues,
            "text_length": len(text) if text else 0,
            "cleaned_text": self.clean_text(text),
        }


class TranscriptionCache:
    """Index of transcription .txt files keyed by version, with JSON
    persistence per (dataset, whisper_set, split) — cache.py:11-90 semantics.

    Layouts mirror the audio trees: ``{root}/{whisper_set}/.../{key}.txt``;
    ``build_index`` globs the tree once, ``get`` reads lazily with a RAM cache.
    """

    def __init__(self, cache_dir: str | Path, dataset_name: str, whisper_set: str, split: str):
        self.cache_dir = Path(cache_dir)
        self.dataset_name = dataset_name
        self.whisper_set = whisper_set
        self.split = split
        self._index: Dict[str, str] = {}  # version_key -> txt path
        self._texts: Dict[str, str] = {}  # version_key -> contents

    @property
    def cache_file(self) -> Path:
        return (
            self.cache_dir
            / f"{self.dataset_name}_{self.whisper_set}_{self.split}_cache.json"
        )

    def load_disk_cache(self) -> bool:
        if not self.cache_file.exists():
            return False
        payload = json.loads(self.cache_file.read_text())
        self._index = payload.get("index", {})
        self._texts = payload.get("texts", {})
        return True

    def save_disk_cache(self) -> None:
        self.cache_file.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.cache_file.with_suffix(".tmp")
        tmp.write_text(json.dumps({"index": self._index, "texts": self._texts}))
        tmp.replace(self.cache_file)

    def build_index(self, transcription_root: str | Path) -> int:
        """Glob ``{root}/**/*.txt``; key = file stem (the version_key)."""
        root = Path(transcription_root)
        self._index = {p.stem: str(p) for p in sorted(root.rglob("*.txt"))}
        return len(self._index)

    def get(self, version_key: str) -> Optional[str]:
        if version_key in self._texts:
            return self._texts[version_key]
        path = self._index.get(version_key)
        if path is None:
            return None
        text = None
        with contextlib.suppress(OSError):  # an unreadable file reads as missing
            text = Path(path).read_text(errors="replace")
        if text is None:
            return None
        self._texts[version_key] = text
        return text

    def validate_all(
        self, keys: Iterable[str], validator: Optional[TranscriptionValidator] = None
    ) -> Dict[str, dict]:
        """Per-key {text, has_valid_transcription, details} census —
        the analogue of cache.apply_to_dataframe (cache.py:92-179)."""
        validator = validator or TranscriptionValidator()
        out = {}
        for key in keys:
            text = self.get(key)
            if text is None:
                out[key] = {"text": None, "has_valid_transcription": False, "details": {"issues": ["missing"]}}
            else:
                details = validator.get_validation_details(text)
                out[key] = {
                    "text": text,
                    "has_valid_transcription": details["is_valid"],
                    "details": details,
                }
        return out
