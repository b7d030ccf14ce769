"""Moses punctuation normalization, the port's own: sacremoses 0.1.1's
``MosesPunctNormalizer(lang)`` at the constructor defaults the JAX
package's callers use (``penn``, ``norm_quote_commas`` and
``norm_numbers`` on; ``pre_replace_unicode_punct``,
``post_remove_control_chars`` and ``perl_parity`` off), a port of the
Moses decoder's ``scripts/tokenizer/normalize-punctuation.perl``.

``normalize_punctuation(text, lang)`` applies the language's
substitutions in sacremoses' order and strips the result.
"""

import functools
import re

__all__ = ["normalize_punctuation"]

_EXTRA_WHITESPACE = [
    (r"\r", r""), (r"\(", r" ("), (r"\)", r") "), (r" +", r" "),
    (r"\) ([.!:?;,])", r")\g<1>"), (r"\( ", r"("), (r" \)", r")"),
    (r"(\d) %", r"\g<1>%"), (r" :", r":"), (r" ;", r";")]
_NORMALIZE_UNICODE_IF_NOT_PENN = [(r"`", r"'"), (r"''", r' " ')]
_NORMALIZE_UNICODE = [
    ("„", r'"'), ("“", r'"'), ("”", r'"'), ("–", r"-"), ("—", r" - "),
    (r" +", r" "), ("´", r"'"), ("([a-zA-Z])‘([a-zA-Z])", r"\g<1>'\g<2>"),
    ("([a-zA-Z])’([a-zA-Z])", r"\g<1>'\g<2>"), ("‘", r"'"), ("‚", r"'"),
    ("’", r"'"), (r"''", r'"'), ("´´", r'"'), ("…", r"...")]
_FRENCH_QUOTES = [
    ("\u00A0«\u00A0", r'"'), ("«\u00A0", r'"'), ("«", r'"'),
    ("\u00A0»\u00A0", r'"'), ("\u00A0»", r'"'), ("»", r'"')]
_HANDLE_PSEUDO_SPACES = [
    ("\u00A0%", r"%"), ("nº\u00A0", "nº "), ("\u00A0:", r":"),
    ("\u00A0ºC", " ºC"), ("\u00A0cm", r" cm"), ("\u00A0\\?", "?"),
    ("\u00A0\\!", "!"), ("\u00A0;", r";"), (",\u00A0", r", "),
    (r" +", r" ")]
_EN_QUOTATION_FOLLOWED_BY_COMMA = [(r'"([,.]+)', r'\g<1>"')]
_DE_ES_FR_QUOTATION_FOLLOWED_BY_COMMA = [
    (r',"', r'",'), (r'(\.+)"(\s*[^<])', r'"\g<1>\g<2>')]
_DE_ES_CZ_CS_FR = [("(\\d)\u00A0(\\d)", r"\g<1>,\g<2>")]
_OTHER = [("(\\d)\u00A0(\\d)", r"\g<1>.\g<2>")]


@functools.lru_cache(maxsize=None)
def _substitutions(lang):
    subs = (_EXTRA_WHITESPACE + _NORMALIZE_UNICODE_IF_NOT_PENN
            + _NORMALIZE_UNICODE + _FRENCH_QUOTES + _HANDLE_PSEUDO_SPACES)
    if lang == "en":
        subs = subs + _EN_QUOTATION_FOLLOWED_BY_COMMA
    elif lang in ("de", "es", "fr"):
        subs = subs + _DE_ES_FR_QUOTATION_FOLLOWED_BY_COMMA
    subs = subs + (_DE_ES_CZ_CS_FR if lang in ("de", "es", "cz", "cs", "fr")
                   else _OTHER)
    return tuple((re.compile(p), r) for p, r in subs)


def normalize_punctuation(text, lang="en"):
    for regexp, sub in _substitutions(lang):
        text = regexp.sub(sub, str(text))
    return text.strip()
