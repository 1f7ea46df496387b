"""Text cleaners (reference: texts/texts.py:31-75).

``unidecode`` is replaced by a self-contained ASCII transliteration built on
``unicodedata`` NFKD decomposition plus a small table for characters that do
not decompose (ae ligatures, eszett, etc.) - sufficient for the LJSpeech
metadata and typical free-form English input.
"""

from __future__ import annotations

import re
import unicodedata

_whitespace_re = re.compile(r"\s+")

# Characters NFKD cannot reduce to ASCII.
_TRANSLIT = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "Th", "ł": "l", "Ł": "L", "ħ": "h", "Ħ": "H",
    "ı": "i", "ŋ": "ng", "Ŋ": "NG", "ĸ": "k",
    "“": '"', "”": '"', "‘": "'", "’": "'", "„": '"', "‚": "'",
    "–": "-", "—": "-", "―": "-", "…": "...", "«": '"', "»": '"',
    "·": "-", "•": "-", " ": " ",
}

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

from .numbers import normalize_numbers  # noqa: E402


def convert_to_ascii(text: str) -> str:
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _TRANSLIT:
            out.append(_TRANSLIT[ch])
            continue
        decomposed = unicodedata.normalize("NFKD", ch)
        ascii_part = "".join(c for c in decomposed if ord(c) < 128
                             and not unicodedata.combining(c))
        out.append(ascii_part)
    return "".join(out)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def english_cleaners(text: str) -> str:
    """Full English pipeline (reference texts.py:68-75): ascii -> lowercase
    -> numbers -> abbreviations -> whitespace."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
