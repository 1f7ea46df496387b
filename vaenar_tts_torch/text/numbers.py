"""English number-to-words expansion.

Self-contained replacement for the ``inflect`` usage in the reference text
normalizer (reference: texts/texts.py:78-142). Implements the subset the
reference exercises: cardinal wording, ordinal wording ("1st" -> "first"),
year-style pair reading for 1001..2999, currency, and decimals.
"""

from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (10 ** 2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def number_to_words(n: int, andword: str = "and") -> str:
    """Cardinal wording of a non-negative integer.

    ``andword`` mirrors inflect's parameter: "one hundred and one" vs
    "one hundred one" when andword="".
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 100:
        return _two_digits(n)
    for scale, word in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = number_to_words(head, andword) + " " + word
            if rest:
                joiner = " "
                if rest < 100 and andword:
                    joiner = f" {andword} "
                out += joiner + number_to_words(rest, andword)
            return out
    return _two_digits(n)  # unreachable


def ordinal_words(n: int) -> str:
    """Ordinal wording of a non-negative integer: 1 -> "first",
    23 -> "twenty-third", 101 -> "one hundred and first".

    Keeps inflect's default andword='and' because the reference's
    _expand_ordinal (texts.py:116-117) calls number_to_words with defaults —
    only the plain-number path passes andword='' — and corpora tokenized by
    the reference carry that 'and'."""
    card = number_to_words(n, andword="and")
    parts = card.rsplit(" ", 1)
    last = parts[-1]
    hy = last.rsplit("-", 1)
    tail = hy[-1]
    if tail in _ORDINAL_IRREGULAR:
        ord_tail = _ORDINAL_IRREGULAR[tail]
    elif tail.endswith("y"):
        ord_tail = tail[:-1] + "ieth"
    else:
        ord_tail = tail + "th"
    hy[-1] = ord_tail
    parts[-1] = "-".join(hy)
    return " ".join(parts)


def year_words(n: int) -> str:
    """Year-style pair reading used by the reference for 1001..2999
    (reference texts.py:120-132: inflect group=2, zero='oh', joined by space).
    Example: 1906 -> "nineteen oh six", 2021 -> "twenty twenty-one".
    """
    hi, lo = divmod(n, 100)
    hi_w = _two_digits(hi)
    if lo == 0:
        return hi_w + " hundred"
    if lo < 10:
        return hi_w + " oh " + _UNITS[lo]
    return hi_w + " " + _two_digits(lo)


# ---------------------------------------------------------------------------
# Regex-driven text expansion, same rule order as the reference
# (texts/texts.py:135-142).
# ---------------------------------------------------------------------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100, andword="")
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        return year_words(num)
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
