"""Latent-space comparison: brain-derived vs audio-derived w2v latents
(counterpart of wav2vec2forbrain_tpu/analysis/latent_analysis.py).

The reference's latent-analysis tooling
(ref: src/analysis/latent_analysis_util.py:39-222): embed neural
recordings through the trained brain encoder and speech through the audio
conv front end, then compare the two latent distributions (cosine
similarity, PCA projections) in BOTH spaces: the pre-encoder features and
the post-w2v-encoder hidden states, per time step and per-sample mean
(latent_analysis_util.py:126-161 audio, :165-214 brain).

Device work runs on the experiment's device (`experiment.device`) or, for
the audio stream, on a `device` argument that defaults to the card, under
`torch.inference_mode()` with TF32 off for cuBLAS and cuDNN
(`ops/select.py::f32_products`, as `predict.py::predict`). The brain
stream goes through the port's kernel modules (preproc, the biGRU, the
encoder's attention and LayerNorm) as the kernel policy
(`ops/select.py`) routes them.

Two behaviours of the JAX functions are kept on purpose:
- `embed_brain` (the "pre"-only path) runs the biGRU with its defaults:
  a zero initial state and f32 products, whatever the spec's
  `gru_learnable_initial_state` and `compute_dtype`. At the CLI's
  defaults it equals `embed_brain_representations(...)["pre"]`; under a
  learnable initial state or bf16 compute it does not.
- `embed_audio_representations` runs the wav2vec2 encoder only, with no
  attention mask over the zero-padded audio; a conformer tree raises.

The ElevenLabs TTS step (`generate_speech_audio`) mirrors the reference's
resume-capable generate -> mp3 -> wav flow and reaches the network only
when an API key is configured; the TTS and mp3 -> wav callables are
injectable. `load_wav_batches` reads WAV files itself (numpy), in
soundfile's float convention.
"""

import os
import struct
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.data.batch import to_device
from wav2vec2forbrain_tpu_torch.models.assembly import forward
from wav2vec2forbrain_tpu_torch.models.audio_frontend import apply_audio_frontend
from wav2vec2forbrain_tpu_torch.models.fc import apply_fc
from wav2vec2forbrain_tpu_torch.models.gru import apply_gru
from wav2vec2forbrain_tpu_torch.models.preprocessing import GAUSS_KERNEL_SIZE, apply_preproc, gaussian_kernel
from wav2vec2forbrain_tpu_torch.models.wav2vec2 import Wav2Vec2EncoderConfig, apply_w2v_encoder
from wav2vec2forbrain_tpu_torch.ops import select
from wav2vec2forbrain_tpu_torch.ops.preproc import apply_preproc_fused
from wav2vec2forbrain_tpu_torch.tree import tree_map

# reference voice/format constants (latent_analysis_util.py:39-46)
ELEVENLABS_VOICE_ID = "pMsXgVXv3BLzUgSXRplE"
ELEVENLABS_OUTPUT_FORMAT = "mp3_22050_32"
AUDIO_SAMPLE_RATE = 16000


def make_elevenlabs_tts(api_key: Optional[str]) -> Optional[Callable]:
    """Real TTS callable (transcription, out_mp3_path) -> None, or None when
    no key / no elevenlabs package is available (offline-safe)."""
    if not api_key or api_key in ("", "<your value here>"):
        return None
    try:
        from elevenlabs.client import ElevenLabs
    except ImportError:
        print("elevenlabs package not installed; skipping TTS generation")
        return None

    client = ElevenLabs(api_key=api_key)

    def tts(transcription: str, out_mp3_path: str):
        audio = client.text_to_speech.convert(
            voice_id=ELEVENLABS_VOICE_ID,
            optimize_streaming_latency="0",
            output_format=ELEVENLABS_OUTPUT_FORMAT,
            text=transcription,
        )
        with open(out_mp3_path, "wb") as f:
            for chunk in audio:
                f.write(chunk)

    return tts


def _default_mp3_to_wav(mp3_path: str, wav_path: str):
    """mp3 -> 16 kHz wav (the reference uses pydub/ffmpeg; gated import)."""
    from pydub import AudioSegment

    audio = AudioSegment.from_file(mp3_path, format="mp3", frame_rate=44100)
    audio = audio.set_frame_rate(AUDIO_SAMPLE_RATE)
    audio.export(wav_path, format="wav")


def generate_speech_audio(
    transcriptions: List[str],
    working_dir: str,
    tts: Optional[Callable] = None,
    mp3_to_wav: Optional[Callable] = None,
    override_existing: bool = False,
) -> Dict[str, object]:
    """TTS generation for the brain-vs-audio comparison, resume-capable like
    the reference (ref: latent_analysis_util.py:55-80): transcript i ->
    mp3/<i>.mp3 -> wav/<i>.wav, skipping files that already exist. Returns
    {"wav_paths": [...], "newly_generated": n, "missing": m}. With no TTS
    callable, existing audio is reused and missing entries reported rather
    than generated (graceful offline behavior)."""
    mp3_dir = os.path.join(working_dir, "mp3")
    wav_dir = os.path.join(working_dir, "wav")
    os.makedirs(mp3_dir, exist_ok=True)
    os.makedirs(wav_dir, exist_ok=True)
    convert = mp3_to_wav or _default_mp3_to_wav

    wav_paths: List[Optional[str]] = []
    newly = 0
    missing = 0
    for i, transcription in enumerate(transcriptions):
        mp3_path = os.path.join(mp3_dir, f"{i}.mp3")
        wav_path = os.path.join(wav_dir, f"{i}.wav")
        if not os.path.exists(mp3_path) or override_existing:
            if tts is None:
                if not os.path.exists(wav_path):
                    missing += 1
                    wav_paths.append(None)
                    continue
                wav_paths.append(wav_path)
                continue
            tts(transcription, mp3_path)
            newly += 1
        if not os.path.exists(wav_path) or override_existing:
            convert(mp3_path, wav_path)
        wav_paths.append(wav_path)
    return {
        "wav_paths": wav_paths,
        "newly_generated": newly,
        "missing": missing,
    }


def read_wav(path: str) -> np.ndarray:
    """A mono WAV file's samples as f32 in soundfile's convention: 16-bit
    PCM as int16 / 32768, 32-bit IEEE float as stored. The RIFF chunks are
    walked here: the stdlib `wave` module reads PCM only."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF / WAVE file")
    fmt = samples = None
    pos = 12
    while pos + 8 <= len(raw):
        chunk, size = raw[pos : pos + 4], struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if chunk == b"fmt ":
            tag, channels, _rate, _byte_rate, _align, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: the sub-format GUID starts with the tag
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, channels, bits)
        elif chunk == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt == (1, 1, 16) and samples is not None:
        return np.frombuffer(samples, "<i2").astype(np.float32) / np.float32(32768.0)
    if fmt == (3, 1, 32) and samples is not None:
        return np.frombuffer(samples, "<f4").astype(np.float32)
    raise ValueError(f"{path}: (format tag, channels, bits) {fmt}; expected mono 16-bit PCM or 32-bit float")


def load_wav_batches(wav_paths: List[Optional[str]], batch_size: int = 8):
    """Yield zero-padded (B, T) float32 audio batches for embed_audio."""
    clips = [read_wav(p) for p in wav_paths if p is not None]
    for i in range(0, len(clips), batch_size):
        chunk = clips[i : i + batch_size]
        t = max(len(c) for c in chunk)
        yield np.stack([np.pad(c, (0, t - len(c))) for c in chunk])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def embed_brain(experiment, max_batches: Optional[int] = None) -> np.ndarray:
    """(N, latent) brain latents: preprocessing chain + GRU + FC, i.e. the
    encoder input the w2v stack sees; the GRU at its defaults (zero initial
    state, f32), as the JAX function runs it (module docstring)."""
    spec, params, dev = experiment.spec, experiment.params, experiment.device
    select.f32_products()
    taps = gaussian_kernel(GAUSS_KERNEL_SIZE, spec.gaussian_smooth_width, dev)
    pre = apply_preproc_fused if select.kernel_enabled("preproc") else apply_preproc
    latents = []
    with torch.inference_mode():
        for i, batch in enumerate(experiment.dataloader_test):
            if max_batches is not None and i >= max_batches:
                break
            b = to_device(batch, dev)
            feats, lens = pre(params["brain"]["preproc"], b.input.float(), b.day_idxs, b.input_lens, taps,
                              spec.unfolder_kernel_len, spec.unfolder_stride_len)
            h = apply_gru(params["brain"]["gru"], feats, spec.gru_hidden_size, spec.gru_num_layers,
                          spec.gru_bidirectional)
            lat = _host(apply_fc(params["brain"]["fc"], h, spec.fc_activation))
            for row, n in zip(lat, lens.cpu().numpy()):
                latents.append(row[: max(int(n), 1)])
    return np.concatenate(latents, axis=0)


def embed_audio(audio_batches, frontend_params, frontend_cfg, device="cuda") -> np.ndarray:
    """(N, hidden) audio latents via the conv feature encoder + projection,
    on `device` (the card unless the caller asks for another)."""
    select.f32_products()
    params = tree_map(lambda t: t.to(device), frontend_params)
    outs = []
    with torch.inference_mode():
        for audio in audio_batches:
            h = _host(apply_audio_frontend(params, torch.as_tensor(audio, dtype=torch.float32).to(device),
                                           frontend_cfg))
            outs.append(h.reshape(-1, h.shape[-1]))
    return np.concatenate(outs, axis=0)


def embed_brain_representations(experiment, max_batches: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Brain stream PRE- and POST-encoder representations, per-timestep and
    per-sample-mean: the reference's Representations(non_aggregated,
    aggregated) with both spaces (ref: src/analysis/latent_analysis_util.py:
    165-214: brain latents go through model.w2v_encoder.forward and the
    returned hidden_states are compared alongside the features). Each
    sample's rows are cut at max(its length, 1); the means take the same
    rows."""
    spec, params, state, dev = experiment.spec, experiment.params, experiment.model_state, experiment.device
    select.f32_products()
    pre_t, post_t, pre_a, post_a = [], [], [], []
    with torch.inference_mode():
        for i, batch in enumerate(experiment.dataloader_test):
            if max_batches is not None and i >= max_batches:
                break
            b = to_device(batch, dev)
            _logits, lens, _state, extras = forward(params, state, spec, b.input, b.day_idxs, b.input_lens,
                                                    rng=None, train=False, return_extras=True)
            lat, hid = _host(extras["latents"]), _host(extras["hidden_states"])
            for row_pre, row_post, n in zip(lat, hid, lens.cpu().numpy()):
                n = max(int(n), 1)
                pre_t.append(row_pre[:n])
                post_t.append(row_post[:n])
                pre_a.append(row_pre[:n].mean(axis=0))
                post_a.append(row_post[:n].mean(axis=0))
    return {
        "pre": np.concatenate(pre_t, axis=0),
        "post": np.concatenate(post_t, axis=0),
        "pre_agg": np.stack(pre_a),
        "post_agg": np.stack(post_a),
    }


def embed_audio_representations(
    audio_batches,
    frontend_params,
    frontend_cfg,
    encoder_params,
    encoder_cfg,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Audio stream PRE- and POST-encoder representations: conv feature
    encoder + projection, then the same w2v transformer encoder
    (ref: latent_analysis_util.py:126-161), at eval, on `device`. Every
    padded frame is kept (reshape(-1, hidden)); the means are over all
    frames of a row. The wav2vec2 encoder only (the port's per-layer tree):
    a conformer raises ValueError."""
    if not isinstance(encoder_cfg, Wav2Vec2EncoderConfig) or "pos_conv" not in encoder_params:
        raise ValueError(
            "embed_audio_representations runs the wav2vec2 encoder (apply_w2v_encoder) only, as the JAX "
            f"package does; got a {type(encoder_cfg).__name__} tree (a conformer has no audio path here)"
        )
    select.f32_products()
    frontend = tree_map(lambda t: t.to(device), frontend_params)
    encoder = tree_map(lambda t: t.to(device), encoder_params)
    pre_t, post_t, pre_a, post_a = [], [], [], []
    with torch.inference_mode():
        for audio in audio_batches:
            feats = apply_audio_frontend(frontend, torch.as_tensor(audio, dtype=torch.float32).to(device),
                                         frontend_cfg)
            hidden = apply_w2v_encoder(encoder, feats, encoder_cfg, train=False)
            feats, hidden = _host(feats), _host(hidden)
            pre_t.append(feats.reshape(-1, feats.shape[-1]))
            post_t.append(hidden.reshape(-1, hidden.shape[-1]))
            pre_a.append(feats.mean(axis=1))
            post_a.append(hidden.mean(axis=1))
    return {
        "pre": np.concatenate(pre_t, axis=0),
        "post": np.concatenate(post_t, axis=0),
        "pre_agg": np.concatenate(pre_a, axis=0),
        "post_agg": np.concatenate(post_a, axis=0),
    }


def representation_statistics(brain: Dict[str, np.ndarray], audio: Dict[str, np.ndarray]) -> Dict[str, object]:
    """latent_statistics for the pre- AND post-encoder spaces (per-timestep
    rows; the _agg per-sample means ride along for plotting)."""
    return {
        "pre": latent_statistics(brain["pre"], audio["pre"]),
        "post": latent_statistics(brain["post"], audio["post"]),
    }


def latent_statistics(brain: np.ndarray, audio: np.ndarray, n_pca: int = 2) -> Dict[str, object]:
    """Distribution comparison: norms, centroid cosine, PCA projections of
    both sets in the joint principal space."""

    def _norm_stats(x):
        n = np.linalg.norm(x, axis=-1)
        return {"mean_norm": float(n.mean()), "std_norm": float(n.std())}

    stats: Dict[str, object] = {
        "brain": _norm_stats(brain),
        "audio": _norm_stats(audio),
    }
    cb, ca = brain.mean(axis=0), audio.mean(axis=0)
    stats["centroid_cosine"] = float(np.dot(cb, ca) / (np.linalg.norm(cb) * np.linalg.norm(ca) + 1e-9))
    joint = np.concatenate([brain, audio], axis=0)
    joint = joint - joint.mean(axis=0)
    # PCA via SVD of the joint set
    _u, s, vt = np.linalg.svd(joint, full_matrices=False)
    proj = vt[:n_pca]
    stats["pca_explained"] = [float(v) for v in (s[:n_pca] ** 2 / np.sum(s**2))]
    # as the JAX function: `joint` is centred already, so its mean here is ~0
    stats["brain_pca"] = (brain - joint.mean(axis=0)) @ proj.T
    stats["audio_pca"] = (audio - joint.mean(axis=0)) @ proj.T
    return stats


def plot_latent_comparison(stats: Dict[str, object], out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    bp = np.asarray(stats["brain_pca"])
    ap = np.asarray(stats["audio_pca"])
    ax.scatter(bp[:, 0], bp[:, 1], s=4, alpha=0.4, label="brain latents")
    ax.scatter(ap[:, 0], ap[:, 1], s=4, alpha=0.4, label="audio latents")
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.legend()
    ax.set_title(f"centroid cosine = {stats['centroid_cosine']:.3f}")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
