"""The port's LM beam-search decode (decode/lm_decode.py and its own copy of
the native decoder) against the JAX package's, on the same logits made
from a numpy seed: the transcripts must be equal strings. Covers the
ambiguous batches of tests/test_decode_parity.py under its four knob
settings on a random 3-gram ARPA (tests/lm_fixtures.py), no LM, lens
truncation and the repeat / blank rules, score_boundary, a kenlm probing
binary (tools/arpa_to_kenlm_binary.py), the missing-path warning, several
threads, the evaluator hook on raw logits, and a build that fails."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "tools"))

from arpa_to_kenlm_binary import write_kenlm_binary  # noqa: E402
from lm_fixtures import WORDS, build_random_arpa  # noqa: E402

from wav2vec2forbrain_tpu.decode import lm_decode as jax_lm  # noqa: E402
from wav2vec2forbrain_tpu_torch.data.tokenizer import Wav2Vec2CTCTokenizer  # noqa: E402
from wav2vec2forbrain_tpu_torch.decode import lm_decode  # noqa: E402

VOCAB = Wav2Vec2CTCTokenizer().get_vocab_list()
V = len(VOCAB)
IDX = {t: i for i, t in enumerate(VOCAB)}
SETTINGS = [
    dict(alpha=0.5, beta=0.5, score_boundary=False),
    dict(alpha=0.5, beta=1.5, score_boundary=True),
    dict(alpha=1.2, beta=0.0, score_boundary=True),
    dict(alpha=0.0, beta=0.5, score_boundary=False),
]
KNOBS = dict(beam_width=24, beam_prune_logp=-12.0, token_min_logp=-3.0)


def ambiguous_logits(rng, t):
    """Noise plus a word sequence's characters, stretched and gapped by
    blanks, plus confusions on random frames (as tests/test_decode_parity.py)."""
    chars = sorted(set("".join(WORDS)))
    x = rng.normal(0.0, 1.0, size=(t, V)).astype(np.float32)
    words = [WORDS[rng.integers(len(WORDS))] for _ in range(rng.integers(1, 4))]
    i = 0
    for ch in "|".join(words):
        if i >= t:
            break
        x[i, IDX[ch]] += rng.uniform(1.0, 4.0)
        if rng.random() < 0.4 and i + 1 < t:
            i += 1
            x[i, IDX[ch]] += rng.uniform(0.5, 3.0)
        if rng.random() < 0.5 and i + 1 < t:
            i += 1
            x[i, IDX["<pad>"]] += rng.uniform(0.5, 3.0)
        i += 1
    for _ in range(t // 2):
        x[rng.integers(t), IDX[chars[rng.integers(len(chars))]]] += rng.uniform(0.5, 3.0)
    return x


def ambiguous_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    lens = rng.integers(12, 40, size=n).astype(np.int32)
    t = int(lens.max())
    batch = np.stack([np.pad(ambiguous_logits(rng, int(n_)), ((0, t - int(n_)), (0, 0))) for n_ in lens])
    return batch, lens


def peaked(tokens, peak=8.0):
    x = np.zeros((len(tokens), V), np.float32)
    for i, tok in enumerate(tokens):
        x[i, IDX[tok]] = peak
    return x


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """(random 3-gram ARPA, its kenlm probing binary, a 2-gram ARPA that
    prefers THE CAT over THE CAR)."""
    d = tmp_path_factory.mktemp("lm")
    arpa = build_random_arpa(str(d / "lm.arpa"), seed=123)
    binary = str(d / "lm.bin")
    write_kenlm_binary(arpa, binary)
    tiny = d / "tiny.arpa"
    tiny.write_text("\n".join([
        "\\data\\", "ngram 1=6", "ngram 2=4", "", "\\1-grams:", "-10.0\t<unk>\t0.0", "-0.5\t<s>\t-0.5",
        "-0.5\t</s>", "-0.8\tTHE\t-0.3", "-1.0\tCAT\t-0.3", "-4.0\tCAR\t-0.3", "", "\\2-grams:",
        "-0.2\t<s> THE", "-0.3\tTHE CAT", "-3.5\tTHE CAR", "-0.2\tCAT </s>", "", "\\end\\",
    ]))
    return arpa, binary, str(tiny)


def both(lm_path=None, **kw):
    return (lm_decode.CTCBeamDecoder(VOCAB, lm_path=lm_path, **kw),
            jax_lm.CTCBeamDecoder(VOCAB, lm_path=lm_path, **kw))


@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_ambiguous_batches_match_jax(lms, setting):
    port, ref = both(lms[0], **SETTINGS[setting])
    assert port.lm_order == ref.lm_order == 3
    batch, lens = ambiguous_batch(1000 + setting)
    got = port.decode_batch(batch, lens, **KNOBS)
    assert got == ref.decode_batch(batch, lens, **KNOBS)
    assert any(got)


def test_no_lm_matches_jax():
    port, ref = both()
    assert port.lm_order == ref.lm_order == 0
    batch, lens = ambiguous_batch(7, n=6)
    knobs = dict(beam_width=16, beam_prune_logp=-10.0, token_min_logp=-4.0)
    assert port.decode_batch(batch, lens, **knobs) == ref.decode_batch(batch, lens, **knobs)


def test_lens_truncation_and_repeat_blank_rules():
    port, ref = both()
    cases = [
        (peaked(list("HI") + ["|"] + list("WORLD")), [2], "HI"),
        (peaked(["H", "E", "L", "<pad>", "L", "O"]), None, "HELLO"),
        (peaked(["H", "H", "E", "E", "<pad>", "E"]), None, "HEE"),
        (peaked(list("HELLO") + ["|"] + list("WORLD")), None, "HELO WORLD"),
    ]
    for frames, lens, want in cases:
        lp = lm_decode.log_softmax(frames[None])
        lens = None if lens is None else np.asarray(lens, np.int32)
        got = port.decode_batch(lp, lens=lens)
        assert got == ref.decode_batch(lp, lens=lens) == [want]


def _cat_car():
    frames = peaked(list("THE") + ["|"] + list("CA") + ["A"])
    frames[-1] = 0.0
    frames[-1, IDX["R"]] = 6.0
    frames[-1, IDX["T"]] = 5.8
    return lm_decode.log_softmax(frames[None])


@pytest.mark.parametrize("alpha,boundary,want", [(0.6, False, "THE CAT"), (0.4, True, "THE CAT"),
                                                 (0.0, False, "THE CAR")])
def test_score_boundary_and_alpha_match_jax(lms, alpha, boundary, want):
    port, ref = both(lms[2], alpha=alpha, beta=0.0, score_boundary=boundary)
    assert port.lm_order == ref.lm_order == 2
    lp = _cat_car()
    assert port.decode_batch(lp) == ref.decode_batch(lp) == [want]


@pytest.mark.parametrize("setting", [0, 2])
def test_kenlm_binary_matches_jax_and_the_arpa(lms, setting):
    arpa, binary, _ = lms
    port_bin, ref_bin = both(binary, **SETTINGS[setting])
    port_arpa = lm_decode.CTCBeamDecoder(VOCAB, lm_path=arpa, **SETTINGS[setting])
    assert port_bin.lm_order == ref_bin.lm_order == 3
    batch, lens = ambiguous_batch(4000 + setting, n=10)
    got = port_bin.decode_batch(batch, lens, **KNOBS)
    assert got == ref_bin.decode_batch(batch, lens, **KNOBS) == port_arpa.decode_batch(batch, lens, **KNOBS)


def test_missing_lm_path_warns_and_decodes_without_lm(capsys):
    port = lm_decode.make_lm_decoder(VOCAB, "/nonexistent/lm.arpa")
    assert "does not exist; decoding without LM" in capsys.readouterr().out
    ref = jax_lm.make_lm_decoder(VOCAB, "/nonexistent/lm.arpa")
    assert "does not exist" in capsys.readouterr().out
    assert port.decoder.lm_order == 0
    frames = peaked(list("HI"))[None]
    assert port(frames, np.asarray([2], np.int32)) == ref(frames, np.asarray([2], np.int32)) == ["HI"]


@pytest.mark.parametrize("n_threads", [1, 2, 3])
def test_threads_give_the_same_transcripts(lms, n_threads):
    port, ref = both(lms[0], **SETTINGS[1])
    batch, lens = ambiguous_batch(55, n=7)
    got = port.decode_batch(batch, lens, n_threads=n_threads, **KNOBS)
    assert got == port.decode_batch(batch, lens, n_threads=1, **KNOBS)
    assert got == ref.decode_batch(batch, lens, n_threads=n_threads, **KNOBS)


def test_evaluator_hook_on_raw_logits_matches_jax(lms):
    kw = dict(beam_width=100, beam_prune_logp=-10.0, token_min_logp=-5.0, alpha=0.5, beta=1.0,
              score_boundary=True)
    port = lm_decode.make_lm_decoder(VOCAB, lms[0], **kw)
    ref = jax_lm.make_lm_decoder(VOCAB, lms[0], **kw)
    assert port.decoder.lm_order == 3
    batch, lens = ambiguous_batch(77, n=5)
    assert port(batch, lens) == ref(batch, lens)


def test_the_library_is_built_into_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = lm_decode.build()
    assert path.parent.parent == lm_decode.BUILD_ROOT and path.parent.name == lm_decode.source_hash()
    assert path.exists()
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "ctc_beam_decoder.cc").write_text("this is not C++\n")
    monkeypatch.setattr(lm_decode, "NATIVE_DIR", broken)
    monkeypatch.setattr(lm_decode, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lm_decode.build()
