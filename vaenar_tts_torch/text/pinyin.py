"""The Mandarin (DataBaker) text frontend, the port's copy of
``vaenar_tts_tpu/text/pinyin.py``.

``parse_cn_prosody_label`` turns DataBaker's hanzi transcript with #1-#4
prosody boundaries and its pinyin line into one flat pinyin string with
separator punctuation, merging erhua (儿化) syllables. ``text_to_pinyin`` is
the free-text frontend: a line that is already TONE3 pinyin ("ni3 hao3")
passes through lowercased; hanzi need the ``pypinyin`` package and raise
``ImportError`` without it. Corpus preprocessing parses the corpus's own
pinyin and needs no ``pypinyin``.
"""

from __future__ import annotations

import re
from typing import Optional

_PUNCT_RE = re.compile("[“”、，。：；？！—…#（）]")


def is_erhua(pinyin_no_tone: str) -> bool:
    """Whether a toneless pinyin syllable is retroflex (erhua)."""
    if len(pinyin_no_tone) <= 1 or pinyin_no_tone == "er":
        return False
    return pinyin_no_tone[-1] == "r"


def parse_cn_prosody_label(text: str, pinyin_seq: str,
                           use_prosody: bool = False) -> Optional[str]:
    """A DataBaker transcript pair as a pinyin string with boundary
    separators, or None for an empty transcript.

    text:       "100001 妈妈#1当时#1表示#3，儿子#1开心得#2像花儿#1一样#4。"
    pinyin_seq: "ma1 ma1 dang1 shi2 biao3 shi4 er2 zi5 kai1 xin1 de5 xiang4 huar1 yi2 yang4"
    returns:    "ma1-ma1 dang1-shi2 biao3-shi4, er2-zi5 kai1-xin1-de5 xiang4-huar1 yi2-yang4."
    """
    text = text.strip()
    pinyin_seq = pinyin_seq.strip()
    if len(text) == 0:
        return None

    text = _PUNCT_RE.sub("", text)

    _sen_id, chars = text.split()
    phones = pinyin_seq.split()

    # separators: syllable, prosodic word, prosodic phrase, intonation
    # phrase, sentence
    SYL = "-"
    PWD = " "
    PPH = " / " if use_prosody else " "
    IPH = ", "
    SEN = "."

    py_seq = ""
    i = 0  # index into chars
    j = 0  # index into phones
    at_boundary = True
    while i < len(chars):
        if chars[i].isdigit():
            tag = chars[i]
            if tag == "1":
                py_seq += PWD
            elif tag == "2":
                py_seq += PPH
            elif tag == "3":
                py_seq += IPH
            elif tag == "4":
                py_seq += SEN
            at_boundary = True
            i += 1
        elif chars[i] != "儿" or j == 0 or not is_erhua(phones[j - 1][:-1]):
            if not at_boundary:
                py_seq += SYL
            py_seq += phones[j]
            at_boundary = False
            i += 1
            j += 1
        else:  # erhua: the 儿 is merged into the previous syllable's pinyin
            i += 1
    return py_seq


#: a line that is already space-separated TONE3 pinyin (syllable and an
#: optional tone digit, neutral tone 5), e.g. "ni3 hao3 shi4 jie4"
_PINYIN_LINE = re.compile(r"^[a-zA-Z]+[1-5]?(\s+[a-zA-Z]+[1-5]?)*$")


def text_to_pinyin(text: str) -> str:
    """Free-text Mandarin -> space-separated TONE3 pinyin. Romanized TONE3
    input passes through, lowercased; hanzi need ``pypinyin``."""
    stripped = text.strip()
    if _PINYIN_LINE.match(stripped):
        return " ".join(stripped.lower().split())
    try:
        from pypinyin import Style, pinyin  # type: ignore
    except ImportError as e:
        raise ImportError(
            "free-text Mandarin synthesis needs the 'pypinyin' package; "
            "corpus preprocessing (which parses DataBaker's own pinyin "
            "transcripts) does not."
        ) from e
    py = pinyin(text, style=Style.TONE3, neutral_tone_with_five=True,
                errors="ignore")
    return " ".join(p[0].lower() for p in py)
