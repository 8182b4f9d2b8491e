"""The port's latent analysis (analysis/latent_analysis.py) against the JAX
package's, on the CPU.

A tiny experiment of each package (the fixture of tests/test_torch_trainer.py:
tiny encoders, latent 96, biGRU 2 x 32, batch 3) from the same bridged
initial weights at f32:
- the brain stream of both families: `embed_brain` and
  `embed_brain_representations` (pre, post, and their per-sample means)
  equal the JAX functions' within 1e-5 absolute; pre is embed_brain's
  within 1e-5 and post is not pre;
- the reference's quirk, kept: under --encoder_learnable_inital_state=true
  `embed_brain` runs the GRU from a zero state and leaves the model's
  `pre`, in both packages by the same amount (1e-5);
- the audio stream: a tiny front end (JAX init, bridged) and the w2v
  experiment's encoder: `embed_audio` and `embed_audio_representations`
  within 1e-5 of JAX's, over two batches of different widths (T' 8, 7);
- `representation_statistics` of both packages' embeddings: norms,
  centroid cosine and explained variance within 1e-5 relative (the norms'
  spread also within 1e-5 of their mean: after the post-LN encoder it is
  rounding-level), the PCA
  projections equal up to a sign per component (1e-4 of their largest
  magnitude); on the same inputs the two functions agree bitwise;
- `generate_speech_audio` with injected callables writes the same files
  and returns the same dict as the JAX function; `load_wav_batches` reads
  stdlib-written PCM16 as int16 / 32768 (and 32-bit float WAVs as stored);
  a conformer tree given to `embed_audio_representations` raises.
"""

import os
import struct
import sys
import wave

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_jax_prng import jax_rbg  # noqa: E402,F401

from test_torch_trainer import config, env, yaml_fields  # noqa: E402,F401

import wav2vec2forbrain_tpu.experiments.impl as jax_impl  # noqa: E402
from wav2vec2forbrain_tpu.analysis import latent_analysis as jax_la  # noqa: E402
from wav2vec2forbrain_tpu.args.yaml_config import YamlConfigModel as JaxYaml  # noqa: E402
from wav2vec2forbrain_tpu.models.audio_frontend import FeatureEncoderConfig as JaxFeCfg  # noqa: E402
from wav2vec2forbrain_tpu.models.audio_frontend import init_feature_encoder_params  # noqa: E402
from wav2vec2forbrain_tpu_torch import bridge  # noqa: E402
from wav2vec2forbrain_tpu_torch.analysis import latent_analysis as la  # noqa: E402
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfigModel  # noqa: E402
from wav2vec2forbrain_tpu_torch.experiments import impl  # noqa: E402
from wav2vec2forbrain_tpu_torch.models.audio_frontend import FeatureEncoderConfig  # noqa: E402

TOL = 1e-5
REPS = ("pre", "post", "pre_agg", "post_agg")
FE = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3), hidden_size=96)


@pytest.fixture(scope="module")
def pairs(env):
    """(family, learnable h0) -> (the JAX experiment, the port's experiment
    from its bridged initial weights, on the CPU), each made once. A JAX
    experiment switches JAX's default PRNG to "rbg" for the process
    (util/tpu_setup.py::configure_jax): torch_jax_prng.jax_rbg runs the
    module under "rbg" whatever ran before, and puts the default back after
    it, so later files draw as they would alone."""
    made = {}

    def pair(family, learnable_h0=False):
        key = (family, learnable_h0)
        if key not in made:
            cfg = config(family, encoder_learnable_inital_state=learnable_h0,
                         results_subdir_name=f"analysis_{family}_{learnable_h0}")
            jcls = (jax_impl.B2TGruAndW2VConformerExperiment if family == "conformer"
                    else jax_impl.B2TGruAndW2VExperiment)
            pcls = impl.B2TGruAndW2VConformerExperiment if family == "conformer" else impl.B2TGruAndW2VExperiment
            jexp = jcls(cfg, JaxYaml(**yaml_fields(env)))
            tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), (jexp._merged_params(), jexp.model_state))
            pexp = pcls(cfg, YamlConfigModel(**yaml_fields(env)), device="cpu")
            pexp.adopt_params(*bridge.params_from_jax(*tree, device="cpu"))
            made[key] = (jexp, pexp)
        return made[key]

    return pair


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("family", ["conformer", "w2v"])
def test_brain_stream_matches_jax(pairs, family):
    jexp, pexp = pairs(family)
    pre_only = la.embed_brain(pexp)
    _close(pre_only, jax_la.embed_brain(jexp))
    got, want = la.embed_brain_representations(pexp), jax_la.embed_brain_representations(jexp)
    assert set(got) == set(REPS)
    for k in REPS:
        _close(got[k], want[k])
    # the test split: 6 samples of 4-8 frames after the unfold, each cut at its own length
    assert got["pre"].shape == (int(sum(len_ for len_ in _lens(pexp))), 96)
    assert got["pre_agg"].shape == got["post_agg"].shape == (6, 96)
    _close(got["pre"], pre_only)
    assert not np.allclose(got["post"], got["pre"], atol=1e-3)
    # max_batches: the first batch only
    _close(la.embed_brain(pexp, max_batches=1), jax_la.embed_brain(jexp, max_batches=1))


def _lens(exp):
    for batch in exp.dataloader_test:
        yield from np.maximum((batch.input_lens - 32) // 4, 1)  # preproc_out_lens, cut at max(n, 1)


def test_embed_brain_keeps_the_zero_initial_state_quirk(pairs):
    jexp, pexp = pairs("w2v", learnable_h0=True)
    got, want = la.embed_brain(pexp), jax_la.embed_brain(jexp)
    _close(got, want)
    pre, jax_pre = la.embed_brain_representations(pexp)["pre"], jax_la.embed_brain_representations(jexp)["pre"]
    _close(pre, jax_pre)
    assert np.abs(got - pre).max() > 1e-2  # the learnable h0 is ignored by the pre-only path...
    _close(got - pre, want - jax_pre)  # ...in both packages alike


def _audio_batches():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((2, 90)).astype(np.float32), rng.standard_normal((3, 80)).astype(np.float32)]


def _frontends():
    tree = jax.tree_util.tree_map(np.asarray, init_feature_encoder_params(jax.random.PRNGKey(1), JaxFeCfg(**FE)))
    return tree, bridge.frontend_from_jax(tree, device="cpu")


def test_audio_stream_and_statistics_match_jax(pairs):
    jexp, pexp = pairs("w2v")
    jax_fe, port_fe = _frontends()
    torch.backends.cudnn.allow_tf32 = True  # the analysis turns TF32 off for the front end's convolutions
    _close(la.embed_audio(_audio_batches(), port_fe, FeatureEncoderConfig(**FE), device="cpu"),
           jax_la.embed_audio(_audio_batches(), jax_fe, JaxFeCfg(**FE)))

    jax_enc = jax.device_get(jexp._merged_params())["w2v"]["encoder"]
    got = la.embed_audio_representations(_audio_batches(), port_fe, FeatureEncoderConfig(**FE),
                                         pexp.params["w2v"]["encoder"], pexp.spec.w2v_cfg, device="cpu")
    want = jax_la.embed_audio_representations(_audio_batches(), jax_fe, JaxFeCfg(**FE), jax_enc,
                                              jexp.spec.w2v_cfg)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    for k in REPS:
        _close(got[k], want[k])
    assert got["pre"].shape == (2 * 8 + 3 * 7, 96) and got["pre_agg"].shape == (5, 96)
    assert not np.allclose(got["post"], got["pre"], atol=1e-3)

    brain, jax_brain = la.embed_brain_representations(pexp), jax_la.embed_brain_representations(jexp)
    stats, jax_stats = la.representation_statistics(brain, got), jax_la.representation_statistics(jax_brain, want)
    for space in ("pre", "post"):
        s, r = stats[space], jax_stats[space]
        for side in ("brain", "audio"):
            mean = r[side]["mean_norm"]
            assert s[side]["mean_norm"] == pytest.approx(mean, rel=TOL)
            # post-LN rows all have nearly one norm: their spread is rounding, held at the norms' scale
            assert s[side]["std_norm"] == pytest.approx(r[side]["std_norm"], rel=TOL, abs=TOL * mean)
        assert s["centroid_cosine"] == pytest.approx(r["centroid_cosine"], rel=TOL)
        assert s["pca_explained"] == pytest.approx(r["pca_explained"], rel=TOL)
        assert 0 < sum(s["pca_explained"]) <= 1
        for side in ("brain_pca", "audio_pca"):
            a, b = np.asarray(s[side]), np.asarray(r[side])
            signs = np.sign(np.sum(a * b, axis=0))  # SVD fixes each component up to its sign
            np.testing.assert_allclose(a * signs, b, rtol=0, atol=1e-4 * np.abs(b).max())
    # the same inputs: the same numpy code, bitwise
    same, ref = la.representation_statistics(jax_brain, want), jax_stats
    for space in ("pre", "post"):
        for k, v in ref[space].items():
            assert np.array_equal(np.asarray(same[space][k]), np.asarray(v)) if not isinstance(v, dict) \
                else same[space][k] == v


def test_plot_latent_comparison_writes_a_figure(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    stats = la.latent_statistics(rng.normal(0, 1, (50, 16)), rng.normal(0.5, 1, (60, 16)))
    la.plot_latent_comparison(stats, str(tmp_path / "latent.png"))
    assert (tmp_path / "latent.png").stat().st_size > 0


def test_conformer_tree_raises_on_the_audio_stream(pairs):
    _, pexp = pairs("conformer")
    _, port_fe = _frontends()
    with pytest.raises(ValueError, match="wav2vec2 encoder"):
        la.embed_audio_representations(_audio_batches(), port_fe, FeatureEncoderConfig(**FE),
                                       pexp.params["w2v"]["encoder"], pexp.spec.conformer_cfg, device="cpu")


def _fake_tts(calls):
    def tts(text, mp3_path):
        calls.append(("tts", text))
        with open(mp3_path, "wb") as f:
            f.write(text.encode())

    def convert(mp3_path, wav_path):
        calls.append(("convert", os.path.basename(mp3_path)))
        with open(mp3_path, "rb") as src, open(wav_path, "wb") as dst:
            dst.write(src.read()[::-1])

    return tts, convert


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_generate_speech_audio_matches_jax(tmp_path):
    texts = ["HELLO WORLD", "THE CAT SAT"]
    runs = {}
    for name, module in (("port", la), ("jax", jax_la)):
        root = tmp_path / name
        (root / "wav").mkdir(parents=True)
        (root / "wav" / "2.wav").write_bytes(b"existing")  # reused offline, never regenerated
        calls = []
        tts, convert = _fake_tts(calls)
        outs = [
            module.generate_speech_audio(texts, str(root), tts=tts, mp3_to_wav=convert),
            module.generate_speech_audio(texts, str(root), tts=tts, mp3_to_wav=convert),  # resume: nothing new
            module.generate_speech_audio(texts + ["NEW ONE"], str(root), tts=tts, mp3_to_wav=convert),
            module.generate_speech_audio(texts, str(root), tts=tts, mp3_to_wav=convert, override_existing=True),
            module.generate_speech_audio(texts + ["A", "B"], str(root), tts=None),  # offline: index 3 is missing
        ]
        for out in outs:
            out["wav_paths"] = [None if p is None else os.path.relpath(p, root) for p in out["wav_paths"]]
        runs[name] = (outs, calls, _tree(str(root)))
    assert runs["port"] == runs["jax"]
    outs = runs["port"][0]
    assert [o["newly_generated"] for o in outs] == [2, 0, 1, 2, 0]
    assert outs[4]["missing"] == 1 and outs[4]["wav_paths"][3] is None
    assert la.make_elevenlabs_tts(None) is None and la.make_elevenlabs_tts("<your value here>") is None


def _write_float_wav(path, samples):
    data = np.asarray(samples, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, 16000, 64000, 4, 32)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_load_wav_batches_reads_pcm16_and_float(tmp_path):
    rng = np.random.default_rng(0)
    pcm = [rng.integers(-32768, 32768, n).astype(np.int16) for n in (400, 250, 310)]
    paths = []
    for i, clip in enumerate(pcm):
        paths.append(str(tmp_path / f"{i}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(clip.tobytes())
    floats = rng.uniform(-1, 1, 120).astype(np.float32)
    _write_float_wav(str(tmp_path / "f.wav"), floats)
    batches = list(la.load_wav_batches([paths[0], None, paths[1], paths[2], str(tmp_path / "f.wav")], batch_size=2))
    assert [b.shape for b in batches] == [(2, 400), (2, 310)]
    assert all(b.dtype == np.float32 for b in batches)
    want = [c.astype(np.float32) / 32768 for c in pcm]
    np.testing.assert_array_equal(batches[0][0], want[0])
    np.testing.assert_array_equal(batches[0][1], np.pad(want[1], (0, 150)))
    np.testing.assert_array_equal(batches[1][0], want[2])
    np.testing.assert_array_equal(batches[1][1], np.pad(floats, (0, 190)))
    with wave.open(str(tmp_path / "stereo.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(20, np.int16).tobytes())
    with pytest.raises(ValueError, match="mono"):
        la.read_wav(str(tmp_path / "stereo.wav"))
