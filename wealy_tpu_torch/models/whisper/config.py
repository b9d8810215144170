"""Whisper model family configs (public architecture hyperparameters)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500  # encoder frames after the stride-2 conv
    n_audio_state: int = 384  # model width d
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    # special token ids (multilingual vocab layout; openai-whisper
    # tokenizer.py specials order: <|endoftext|> <|startoftranscript|>
    # <lang>*n <|translate|> <|transcribe|> <|startoflm|> <|startofprev|>
    # <|nospeech|> <|notimestamps|> <timestamps>*1501)
    @property
    def sot(self) -> int:  # <|startoftranscript|>
        # fixed across multilingual families: <|endoftext|>/<|sot|> sit at
        # the end of the TEXT vocab (50257/50258); large-v3's extra token is
        # <|yue|> INSIDE the language block (only the task tokens shift).
        # English-only vocabs have one fewer text token (50256/50257).
        return 50258 if self.n_vocab >= 51865 else 50257

    @property
    def eot(self) -> int:  # <|endoftext|>
        return self.sot - 1

    @property
    def n_languages(self) -> int:
        # large-v3 family (n_vocab 51866) added a 100th language (yue);
        # English-only vocabs (51864) keep the full 99-language token block
        # (the specials list is identical, only the text vocab shrinks)
        return 99 + max(0, self.n_vocab - 51865)

    @property
    def token_translate(self) -> int:
        return self.sot + 1 + self.n_languages

    @property
    def token_transcribe(self) -> int:
        return self.token_translate + 1

    @property
    def token_startoflm(self) -> int:
        return self.token_transcribe + 1

    @property
    def token_startofprev(self) -> int:  # long-form context carry-over prefix
        return self.token_startoflm + 1

    @property
    def token_nospeech(self) -> int:
        return self.token_startofprev + 1

    @property
    def token_no_timestamps(self) -> int:
        return self.token_nospeech + 1

    def language_token(self, lang_index: int) -> int:
        """Language tokens immediately follow <|startoftranscript|>; English is 0."""
        return self.sot + 1 + lang_index


def _cfg(d, h, enc_l, dec_l, n_mels=80, n_vocab=51865):
    return WhisperConfig(
        n_mels=n_mels,
        n_audio_state=d,
        n_audio_head=h,
        n_audio_layer=enc_l,
        n_vocab=n_vocab,
        n_text_state=d,
        n_text_head=h,
        n_text_layer=dec_l,
    )


WHISPER_CONFIGS = {
    # "dev": not a published Whisper size — a 1-layer width-64 stand-in with
    # the real mel/ctx/vocab geometry, for smoke tests and CI (full tiny
    # costs ~10 s per forward on 1-core CPU runners)
    "dev": _cfg(64, 2, 1, 1),
    "tiny": _cfg(384, 6, 4, 4),
    "base": _cfg(512, 8, 6, 6),
    "small": _cfg(768, 12, 12, 12),
    "medium": _cfg(1024, 16, 24, 24),
    "large": _cfg(1280, 20, 32, 32),
    "large-v2": _cfg(1280, 20, 32, 32),
    "large-v3": _cfg(1280, 20, 32, 32, n_mels=128, n_vocab=51866),
    # "turbo" — the WEALY default whisper_set is turbo-based
    # (lib/audio_dataset/dataset.py:17-19: whisper_set="turbo_nothing_whisper_42")
    "large-v3-turbo": _cfg(1280, 20, 32, 4, n_mels=128, n_vocab=51866),
}
WHISPER_CONFIGS["turbo"] = WHISPER_CONFIGS["large-v3-turbo"]
