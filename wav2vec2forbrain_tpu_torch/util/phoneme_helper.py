"""ARPAbet phoneme definitions + grapheme-to-phoneme conversion (the port's
copy of wav2vec2forbrain_tpu/util/phoneme_helper.py; tests/test_torch_phonemes.py
holds it to the original).

Mirror of the reference phoneme tooling (ref: src/util/phoneme_helper.py:5-91):
39 ARPAbet phones + SIL, SIL inserted at word boundaries and sequence end,
ids shifted +1 so 0 stays the CTC blank.

G2P backend: `g2p_en` when installed (the reference's backend); otherwise a
deterministic rule-based English letter-to-phoneme fallback (documented
divergence — the fallback is NOT lexicon-accurate, it exists so the phoneme
pipeline is runnable/testable in hermetic environments).
"""

import re
from typing import List, NamedTuple

PHONE_DEF = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH",
    "EH", "ER", "EY", "F", "G", "HH", "IH", "IY", "JH", "K",
    "L", "M", "N", "NG", "OW", "OY", "P", "R", "S", "SH",
    "T", "TH", "UH", "UW", "V", "W", "Y", "Z", "ZH",
]

PHONE_DEF_SIL = PHONE_DEF + ["SIL"]

SIL_DEF = ["SIL"]


class PhonemeSeq(NamedTuple):
    phoneme_ids: List[int]
    phonemes: List[str]


# --- fallback G2P -------------------------------------------------------------

# Simple digraph/letter rules (rule-based fallback, not lexicon-accurate).
_DIGRAPHS = [
    ("TCH", ["CH"]), ("SCH", ["SH"]), ("CH", ["CH"]), ("SH", ["SH"]),
    ("PH", ["F"]), ("TH", ["TH"]), ("WH", ["W"]), ("CK", ["K"]),
    ("NG", ["NG"]), ("QU", ["K", "W"]), ("OO", ["UW"]), ("EE", ["IY"]),
    ("EA", ["IY"]), ("AI", ["EY"]), ("AY", ["EY"]), ("OA", ["OW"]),
    ("OU", ["AW"]), ("OW", ["AW"]), ("OY", ["OY"]), ("OI", ["OY"]),
    ("AU", ["AO"]), ("AW", ["AO"]), ("ER", ["ER"]), ("AR", ["AA", "R"]),
    ("OR", ["AO", "R"]),
]
_LETTERS = {
    "A": ["AE"], "B": ["B"], "C": ["K"], "D": ["D"], "E": ["EH"],
    "F": ["F"], "G": ["G"], "H": ["HH"], "I": ["IH"], "J": ["JH"],
    "K": ["K"], "L": ["L"], "M": ["M"], "N": ["N"], "O": ["AA"],
    "P": ["P"], "Q": ["K"], "R": ["R"], "S": ["S"], "T": ["T"],
    "U": ["AH"], "V": ["V"], "W": ["W"], "X": ["K", "S"], "Y": ["Y"],
    "Z": ["Z"],
}


class FallbackG2p:
    """Rule-based word->ARPAbet. Call signature matches g2p_en.G2p: returns a
    token list where ' ' separates words (so SIL insertion matches)."""

    def _word(self, word: str) -> List[str]:
        out: List[str] = []
        i = 0
        w = word.upper()
        while i < len(w):
            for pat, phones in _DIGRAPHS:
                if w.startswith(pat, i):
                    out.extend(phones)
                    i += len(pat)
                    break
            else:
                ch = w[i]
                if ch in _LETTERS:
                    out.extend(_LETTERS[ch])
                i += 1
        return out or ["AH"]

    def __call__(self, text: str) -> List[str]:
        tokens: List[str] = []
        words = [w for w in re.split(r"\s+", text.strip()) if w]
        for wi, word in enumerate(words):
            if wi > 0:
                tokens.append(" ")
            tokens.extend(self._word(re.sub(r"[^A-Za-z']", "", word)))
        return tokens


def make_g2p():
    """The reference's g2p_en backend if available, else the fallback."""
    try:
        from g2p_en import G2p  # type: ignore

        return G2p()
    except ImportError:
        return FallbackG2p()


# --- conversion (exact port of the reference logic) ---------------------------


def get_phoneme_seq(g2p, transcription: str, zero_is_blank: bool = True) -> PhonemeSeq:
    """ref: phoneme_helper.py:59-81 — SIL at spaces and sequence end, stress
    digits stripped, ids shifted +1 for blank=0."""

    def phone_to_id(p):
        return PHONE_DEF_SIL.index(p)

    phonemes: List[str] = []
    if len(transcription) == 0:
        phonemes = list(SIL_DEF)
    else:
        cleaned = transcription.replace("<s>", "").replace("</s>", "").upper()
        for p in g2p(cleaned):
            if p == " ":
                phonemes.append("SIL")
            p = re.sub(r"[0-9]", "", p)
            if re.match(r"[A-Z]+", p):
                phonemes.append(p)
        phonemes.append("SIL")

    phoneme_ids = (
        [phone_to_id(p) + 1 for p in phonemes]
        if zero_is_blank
        else [phone_to_id(p) for p in phonemes]
    )
    return PhonemeSeq(phoneme_ids, phonemes)


def decode_predicted_phoneme_ids(ids, zero_is_blank: bool = True) -> str:
    """ref: phoneme_helper.py:84-91."""
    return " ".join(
        PHONE_DEF_SIL[(i - 1) if zero_is_blank else i]
        for i in ids
        if i > (0 if zero_is_blank else -1)
    )
