"""Character tokenizer: BOS '^' + cleaned text + EOS '~', mapped through the
symbol table of the hparams character string (the port's copy of
``vaenar_tts_tpu.text.tokenizer``)."""

from __future__ import annotations

from typing import List

from ..configs.hparams import TextConfig
from .cleaners import english_cleaners


class CharTokenizer:
    def __init__(self, text_config: TextConfig):
        self.cfg = text_config
        self.symbols: List[str] = list(text_config.characters)
        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}

    @property
    def vocab_size(self) -> int:
        return len(self.symbols)

    def encode(self, cleaned: str) -> List[int]:
        """Unknown symbols raise a KeyError."""
        text = self.cfg.bos + cleaned + self.cfg.eos
        return [self.symbol_to_id[s] for s in text]

    def encode_english(self, raw: str) -> List[int]:
        return self.encode(english_cleaners(raw))
