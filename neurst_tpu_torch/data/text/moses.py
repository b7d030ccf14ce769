"""The Moses tokenizer and detokenizer (``moses``), the port's own: the
same rules as sacremoses 0.1.1's ``MosesTokenizer.tokenize`` and
``MosesDetokenizer.detokenize``, which the JAX package's
``neurst_tpu/data/text/moses.py`` calls, written with ``re`` alone.

The character classes (Perl Unicode Properties) and the nonbreaking
prefixes are data the port carries under ``moses_data/`` (generated by
``tests/tools/make_moses_tables.py``; see its ``NOTICE``).  The
tokenizer keeps sacremoses' language rules: English, French / Italian
and the other languages' apostrophes, the CJK letters of zh, ja and ko;
the detokenizer its en, fr, it, ga, cs, fi and CJK rules.  Where
sacremoses' behaviour is odd, the port keeps it, so that both give the
same text (noted where it happens).
"""

import functools
import os
import re

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["MosesTokenizer", "moses_tokenize", "moses_detokenize",
           "char_ranges", "is_cjk"]

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "moses_data")
# sacremoses.indic: the viramas and nuktas the tokenizer adds to its
# letters and digits
VIRAMAS = (0x094D, 0x09CD, 0x0A4D, 0x0ACD, 0x0B4D, 0x0BCD, 0x0C4D, 0x0CCD,
           0x0D3B, 0x0D3C, 0x0D4D, 0x0EBA, 0x1039, 0x1714, 0x1BAB, 0xA8C4,
           0xA8F3, 0xA8F4, 0xA953, 0xAAF6, 0x10A3F, 0x11046, 0x110B9,
           0x11133, 0x111C0, 0x11235, 0x112EA, 0x1134D, 0x11442, 0x114C2,
           0x115BF, 0x1163F, 0x116B6, 0x11839, 0x119E0, 0x11A34, 0x11C3F,
           0x11D45, 0x11D97, 0x0DCA)
NUKTAS = (0x093C, 0x09BC, 0x0A3C, 0x0ABC, 0x0AFD, 0x0AFE, 0x0AFF, 0x0B3C,
          0x0CBC, 0x1C37, 0x110BA, 0x11173, 0x111CA, 0x11236, 0x112E9,
          0x1133C, 0x11446, 0x114C3, 0x115C0, 0x116B7, 0x1183A, 0x11D42,
          0x1E94A)
# sacremoses.util.CJKChars.ranges; ``is_cjk`` holds a code point strictly
# inside one of them (both ends excluded, as sacremoses does)
CJK_RANGES = ((4352, 4607), (11904, 42191), (43072, 43135), (44032, 55215),
              (63744, 64255), (65072, 65103), (65381, 65500),
              (94208, 101119), (110592, 110895), (110960, 111359),
              (131072, 196607))
# sacremoses.corpus.NonbreakingPrefixes.available_langs: a language's
# name or code -> its prefix list; any other language reads English's
_PREFIX_LANGS = {
    "assamese": "as", "bengali": "bn", "catalan": "ca", "czech": "cs",
    "german": "de", "greek": "el", "english": "en", "spanish": "es",
    "estonian": "et", "finnish": "fi", "french": "fr", "irish": "ga",
    "gujarati": "gu", "hindi": "hi", "hungarian": "hu", "icelandic": "is",
    "italian": "it", "kannada": "kn", "lithuanian": "lt", "latvian": "lv",
    "malayalam": "ml", "manipuri": "mni", "marathi": "mr", "dutch": "nl",
    "oriya": "or", "punjabi": "pa", "polish": "pl", "portuguese": "pt",
    "romanian": "ro", "russian": "ru", "slovak": "sk", "slovenian": "sl",
    "swedish": "sv", "tamil": "ta", "telugu": "te", "tetum": "tdt",
    "cantonese": "yue", "chinese": "zh"}
_PREFIX_LANGS.update({v: v for v in list(_PREFIX_LANGS.values())})


@functools.lru_cache(maxsize=None)
def _tables():
    out = {}
    with open(os.path.join(_DATA, "perluniprops.txt"),
              encoding="ascii") as f:
        for line in f:
            name, spans = line.rstrip("\n").split("\t")
            ranges = []
            for span in spans.split():
                lo, _, hi = span.partition("-")
                ranges.append((int(lo, 16), int(hi or lo, 16)))
            out[name] = tuple(ranges)
    return out


def char_ranges(name):
    """The closed code-point ranges of Perluniprops class ``name``."""
    return _tables()[name]


def _class(*parts):
    """The body of a regex character class: Perluniprops class names and
    tuples of code points."""
    body = []
    for part in parts:
        ranges = char_ranges(part) if isinstance(part, str) else \
            [(cp, cp) for cp in part]
        for lo, hi in ranges:
            body.append(f"\\U{lo:08x}" if lo == hi
                        else f"\\U{lo:08x}-\\U{hi:08x}")
    return "".join(body)


def _chars(*parts):
    out = set()
    for part in parts:
        if isinstance(part, str):
            for lo, hi in char_ranges(part):
                out.update(map(chr, range(lo, hi + 1)))
        else:
            out.update(map(chr, part))
    return frozenset(out)


def is_cjk(ch):
    cp = ord(ch)
    for start, end in CJK_RANGES:
        if cp < end:
            return cp > start
    return False


@functools.lru_cache(maxsize=None)
def _prefixes(lang):
    """(nonbreaking prefixes, the numeric-only ones) of ``lang``."""
    path = os.path.join(_DATA, "nonbreaking_prefixes",
                        "nonbreaking_prefix." + _PREFIX_LANGS.get(lang, "en"))
    with open(path, encoding="utf-8") as f:
        words = [w for w in (line.strip() for line in f.read().splitlines())
                 if w and not w.startswith("#")]
    numeric = frozenset(w.rpartition(" ")[0] for w in words
                        if re.search(r"[\s]+(\#NUMERIC_ONLY\#)", w))
    return frozenset(words), numeric


_CJK_LETTERS = {"ko": ("Hangul",), "zh": ("Han",),
                "ja": ("Hiragana", "Katakana", "Han"),
                "cjk": ("Hangul", "Han", "Hiragana", "Katakana", "Han")}
_PENN_XML = ((r"&", r"&amp;"), (r"\|", r"&#124;"), (r"<", r"&lt;"),
             (r">", r"&gt;"), (r"\'", r"&apos;"), (r"\"", r"&quot;"),
             (r"\[", r"&#91;"), (r"]", r"&#93;"))


class _Rules(object):
    """A language's compiled tokenizer and detokenizer rules."""

    def __init__(self, lang):
        alnum = ("IsAlnum", VIRAMAS, NUKTAS) + _CJK_LETTERS.get(lang, ())
        alpha = ("IsAlpha", VIRAMAS, NUKTAS)
        isn, a, an = _class("IsN"), _class(*alpha), _class(*alnum)
        self.alpha_chars = _chars(*alpha + _CJK_LETTERS.get(lang, ()))
        self.lower_chars = _chars("IsLower")
        self.prefixes, self.numeric_prefixes = _prefixes(lang)
        c = re.compile
        self.pad_not_alnum = c(rf"([^{an}\s\.'\`\,\-])")
        self.dash_split = c(rf"([{an}])\-(?=[{an}])")
        self.commas = ((c(rf"([^{isn}])[,]"), r"\1 , "),
                       (c(rf"[,]([^{isn}])"), r" , \1"),
                       (c(rf"([{isn}])[,]$"), r"\1 , "))
        if lang == "en":
            self.apostrophes = (
                (c(rf"([^{a}])[']([^{a}])"), r"\1 ' \2"),
                (c(rf"([^{a}{isn}])[']([{a}])"), r"\1 ' \2"),
                (c(rf"([{a}])[']([^{a}])"), r"\1 ' \2"),
                (c(rf"([{a}])[']([{a}])"), r"\1 '\2"),
                (c(rf"([{isn}])[']([s])"), r"\1 '\2"))
        elif lang in ("fr", "it"):
            self.apostrophes = (
                (c(rf"([^{a}])[']([^{a}])"), r"\1 ' \2"),
                (c(rf"([^{a}])[']([{a}])"), r"\1 ' \2"),
                (c(rf"([{a}])[']([^{a}])"), r"\1 ' \2"),
                (c(rf"([{a}])[']([{a}])"), r"\1' \2"))
        else:
            self.apostrophes = ((c(r"\'"), " ' "),)
        self.xml = tuple((c(p), r) for p, r in _PENN_XML)
        # the detokenizer's classes (no viramas, nuktas or CJK letters)
        da, sc = _class("IsAlpha"), _class("IsSc")
        self.currency = c(rf"^[{sc}\(\[\{{\¿\¡]+$")
        self.en_contraction = c(rf"^['][{da}]")
        self.fr_contraction = c(rf"[{da}][']$")
        self.starts_with_alpha = c(rf"^[{da}]")


@functools.lru_cache(maxsize=None)
def _rules(lang):
    return _Rules(lang)


def _replace_multidots(text):
    text = re.sub(r"\.([\.]+)", r" DOTMULTI\1", text)
    while re.search(r"DOTMULTI\.", text):
        text = re.sub(r"DOTMULTI\.([^\.])", r"DOTDOTMULTI \1", text)
        text = re.sub(r"DOTMULTI\.", "DOTDOTMULTI", text)
    return text


def _restore_multidots(text):
    while re.search(r"DOTDOTMULTI", text):
        text = re.sub(r"DOTDOTMULTI", r"DOTMULTI.", text)
    return re.sub(r"DOTMULTI", r".", text)


def _nonbreaking_prefixes(rules, text):
    tokens = text.split()
    n = len(tokens)
    for i, token in enumerate(tokens):
        m = re.search(r"^(\S+)\.$", token)
        if not m:
            continue
        prefix = m.group(1)
        if (("." in prefix and not rules.alpha_chars.isdisjoint(prefix))
                or (prefix in rules.prefixes
                    and prefix not in rules.numeric_prefixes)
                or (i != n - 1 and tokens[i + 1]
                    and tokens[i + 1][0] in rules.lower_chars)):
            pass
        elif (prefix in rules.numeric_prefixes and i + 1 < n
              and re.search(r"^[0-9]+", tokens[i + 1])):
            pass
        else:
            tokens[i] = prefix + " ."
    return " ".join(tokens)


def moses_tokenize(text, lang="en", aggressive_dash_splits=False,
                   escape=True, protected_patterns=None):
    """sacremoses' ``MosesTokenizer(lang).tokenize(text, ...,
    return_str=True)``."""
    rules = _rules(lang)
    text = re.sub(r"\s+", " ", str(text))
    text = re.sub(r"[\000-\037]", "", text)
    protected = []
    if protected_patterns:
        patterns = [re.compile(p, re.IGNORECASE) for p in protected_patterns]
        protected = [m.group() for p in patterns for m in p.finditer(text)]
        if len(protected) > 1000:  # the placeholders count in 3 digits
            raise ValueError(f"{len(protected)} protected tokens in a line; "
                             "at most 1000")
        for i, token in sorted(enumerate(protected),
                               key=lambda pair: len(pair[1]), reverse=True):
            text = text.replace(token, "THISISPROTECTED" + str(i).zfill(3))
    text = rules.pad_not_alnum.sub(r" \1 ", text.strip())
    if aggressive_dash_splits:
        text = rules.dash_split.sub(r"\1 @-@ ", text)
    text = _replace_multidots(text)
    for regexp, sub in rules.commas + rules.apostrophes:
        text = regexp.sub(sub, text)
    text = _nonbreaking_prefixes(rules, text)
    text = re.sub(r"\s+", " ", text).strip()
    text = re.sub(r"\.' ?$", " . ' ", text)
    for i, token in enumerate(protected):
        text = text.replace("THISISPROTECTED" + str(i).zfill(3), token)
    text = _restore_multidots(text)
    if escape:
        for regexp, sub in rules.xml:
            text = regexp.sub(sub, text)
    return text


_UNESCAPE = tuple((re.compile(p), r) for p, r in (
    (r"&bar;", r"|"), (r"&#124;", r"|"), (r"&lt;", r"<"), (r"&gt;", r">"),
    (r"&bra;", r"["), (r"&ket;", r"]"), (r"&quot;", r'"'),
    (r"&apos;", r"'"), (r"&#91;", r"["), (r"&#93;", r"]"),
    (r"&amp;", r"&")))
_FINNISH = re.compile(r"^({})({})?({})$".format(
    "|".join(["N", "n", "A", "a", "\xc4", "\xe4", "ssa", "Ssa", "ss\xe4",
              "Ss\xe4", "sta", "st\xe4", "Sta", "St\xe4", "hun", "Hun",
              "hyn", "Hyn", "han", "Han", "h\xe4n", "H\xe4n", "h\xf6n",
              "H\xf6n", "un", "Un", "yn", "Yn", "an", "An", "\xe4n", "\xc4n",
              "\xf6n", "\xd6n", "seen", "Seen", "lla", "Lla", "ll\xe4",
              "Ll\xe4", "lta", "Lta", "lt\xe4", "Lt\xe4", "lle", "Lle", "ksi",
              "Ksi", "kse", "Kse", "tta", "Tta", "ine", "Ine"]),
    "|".join(["ni", "si", "mme", "nne", "nsa"]),
    "|".join(["ko", "k\xf6", "han", "h\xe4n", "pa", "p\xe4", "kaan",
              "k\xe4\xe4n", "kin"])))
_IS_PUNCT = re.compile(r"^[\,\.\?\!\:\;\\\%\}\]\)]+$")
_IS_OPEN_QUOTE = re.compile(r"""^[\'\"„“`]+$""")


def moses_detokenize(tokens, lang="en"):
    """sacremoses' ``MosesDetokenizer(lang).detokenize(tokens)``: a string
    from a list of tokens, XML entities unescaped."""
    rules = _rules(lang)
    text = re.sub(r" \@\-\@ ", r"-", " {} ".format(" ".join(tokens)))
    for regexp, sub in _UNESCAPE:
        text = regexp.sub(sub, text)
    quote_counts = {"'": 0, '"': 0, "``": 0, "`": 0, "''": 0}
    prepend_space, out = " ", ""
    tokens = text.split()
    for i, token in enumerate(tokens):
        if is_cjk(token[0]) and lang != "ko":
            if i > 0 and is_cjk(tokens[i - 1][-1]):
                out += token
            else:
                out += prepend_space + token
            prepend_space = " "
        elif rules.currency.search(token):
            out += prepend_space + token
            prepend_space = ""
        elif _IS_PUNCT.search(token):
            if lang == "fr" and re.search(r"^[\?\!\:\;\\\%]$", token):
                out += " "
            out += token
            prepend_space = " "
        elif lang == "en" and i > 0 and rules.en_contraction.search(token):
            out += token
            prepend_space = " "
        # sacremoses reads the last two tokens of the line here, not the
        # two before this one
        elif (lang == "cs" and i > 1 and re.search(r"^[0-9]+$", tokens[-2])
              and re.search(r"^[.,]$", tokens[-1])
              and re.search(r"^[0-9]+$", token)):
            out += token
            prepend_space = " "
        elif (lang in ("fr", "it", "ga") and i <= len(tokens) - 2
              and rules.fr_contraction.search(token)
              and rules.starts_with_alpha.search(tokens[i + 1])):
            out += prepend_space + token
            prepend_space = ""
        elif (lang == "cs" and i <= len(tokens) - 3
              and rules.fr_contraction.search(token)
              and re.search(r"^[-–]$", tokens[i + 1])
              and re.search(r"^li$|^mail.*", tokens[i + 2], re.IGNORECASE)):
            # sacremoses calls next() on the token list here, which raises
            raise TypeError("'list' object is not an iterator")
        elif _IS_OPEN_QUOTE.search(token):
            quo = '"' if re.search(r"^[„“”]+$", token) else token
            quote_counts[quo] = quote_counts.get(quo, 0)
            if lang == "cs" and token == "„":
                quote_counts[quo] = 0
            if lang == "cs" and token == "“":
                quote_counts[quo] = 1
            if quote_counts[quo] % 2 == 0:
                if (lang == "en" and token == "'" and i > 0
                        and re.search(r"[s]$", tokens[i - 1])):
                    out += token
                    prepend_space = " "
                else:
                    out += prepend_space + token
                    prepend_space = ""
                    quote_counts[quo] += 1
            else:
                out += token
                prepend_space = " "
                quote_counts[quo] += 1
        elif (lang == "fi" and re.search(r":$", tokens[i - 1])
              and _FINNISH.search(token)):
            out += prepend_space + token
            prepend_space = " "
        else:
            out += prepend_space + token
            prepend_space = " "
    return re.sub(r" {2,}", " ", out).strip()


@register_tokenizer("moses")
class MosesTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None,
                 aggressive_dash_splits=False, escape=False, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._aggressive = aggressive_dash_splits
        self._escape = escape
        _rules(language)  # compile the language's rules now

    def tokenize(self, text, return_str=False):
        out = moses_tokenize(
            self._convert_to_str(text), self._language,
            aggressive_dash_splits=self._aggressive, escape=self._escape,
            protected_patterns=self._glossaries or None)
        return self._output_wrapper(out, return_str)

    def detokenize(self, text, return_str=True):
        out = moses_detokenize(self._convert_to_str(text).split(),
                               self._language)
        return self._output_wrapper(out, return_str)
