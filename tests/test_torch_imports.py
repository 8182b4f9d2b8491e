"""Import hygiene of the PyTorch port, its tokenizer against the JAX
package's, and the refusal of chip_smoke.py and of the port's CLI
(run.py) to run without a CUDA card unless asked for the CPU.

The GPU machine has no jax, pydantic, yaml, flax, optax, msgpack,
transformers, safetensors, huggingface_hub, soundfile, pydub, elevenlabs
or matplotlib, so neither the port nor chip_smoke.py may import them when
a module is imported, not even indirectly (the analysis and the plots
import matplotlib, pydub and elevenlabs inside the functions that use
them); nor do they import the JAX package itself, or the repository's
sweep.py (the port's sweep runner reads the sweep YAMLs itself)."""

import os
import pkgutil
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from wav2vec2forbrain_tpu.data.tokenizer import W2V_CTC_VOCAB as JAX_VOCAB
from wav2vec2forbrain_tpu.data.tokenizer import Wav2Vec2CTCTokenizer as JaxTokenizer
from wav2vec2forbrain_tpu_torch.data.tokenizer import W2V_CTC_VOCAB, Wav2Vec2CTCTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "pydantic", "optax", "flax", "transformers", "yaml", "sweep", "msgpack", "safetensors",
           "huggingface_hub", "soundfile", "pydub", "elevenlabs", "matplotlib")


def _port_modules():
    import wav2vec2forbrain_tpu_torch

    names = ["wav2vec2forbrain_tpu_torch"]
    for info in pkgutil.walk_packages(wav2vec2forbrain_tpu_torch.__path__, "wav2vec2forbrain_tpu_torch."):
        names.append(info.name)
    return names


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def test_port_and_chip_smoke_import_without_jax_or_pydantic():
    modules = _port_modules()
    assert {"wav2vec2forbrain_tpu_torch.ops.kernels", "wav2vec2forbrain_tpu_torch.predict",
            "wav2vec2forbrain_tpu_torch.bridge", "wav2vec2forbrain_tpu_torch.ops.hash_dropout",
            "wav2vec2forbrain_tpu_torch.models.seeds", "wav2vec2forbrain_tpu_torch.train.optim",
            "wav2vec2forbrain_tpu_torch.train.steps", "wav2vec2forbrain_tpu_torch.train.train_loop",
            "wav2vec2forbrain_tpu_torch.profile_train", "wav2vec2forbrain_tpu_torch.tree",
            "wav2vec2forbrain_tpu_torch.ops.layernorm", "wav2vec2forbrain_tpu_torch.models.wav2vec2",
            "wav2vec2forbrain_tpu_torch.run", "wav2vec2forbrain_tpu_torch.args.flags",
            "wav2vec2forbrain_tpu_torch.args.argparsing", "wav2vec2forbrain_tpu_torch.args.yaml_config",
            "wav2vec2forbrain_tpu_torch.experiments.impl", "wav2vec2forbrain_tpu_torch.experiments.registry",
            "wav2vec2forbrain_tpu_torch.data.dataset", "wav2vec2forbrain_tpu_torch.data.loader",
            "wav2vec2forbrain_tpu_torch.data.preprocessing", "wav2vec2forbrain_tpu_torch.train.checkpoint",
            "wav2vec2forbrain_tpu_torch.train.logger", "wav2vec2forbrain_tpu_torch.models.pretrained",
            "wav2vec2forbrain_tpu_torch.util.seq", "wav2vec2forbrain_tpu_torch.sweep",
            "wav2vec2forbrain_tpu_torch.decode.lm_decode", "wav2vec2forbrain_tpu_torch.train.buckets",
            "wav2vec2forbrain_tpu_torch.parallel.distributed", "wav2vec2forbrain_tpu_torch.parallel.mesh",
            "wav2vec2forbrain_tpu_torch.parallel.zero",
            "wav2vec2forbrain_tpu_torch.train.evaluator", "wav2vec2forbrain_tpu_torch.train.msgpack_codec",
            "wav2vec2forbrain_tpu_torch.models.convert", "wav2vec2forbrain_tpu_torch.models.hf_snapshot",
            "wav2vec2forbrain_tpu_torch.convert", "wav2vec2forbrain_tpu_torch.models.audio_frontend",
            "wav2vec2forbrain_tpu_torch.analysis", "wav2vec2forbrain_tpu_torch.analysis.latent_analysis",
            "wav2vec2forbrain_tpu_torch.analysis.results_analysis",
            "wav2vec2forbrain_tpu_torch.analysis.raw_data_analysis",
            "wav2vec2forbrain_tpu_torch.train.jax_train_state", "wav2vec2forbrain_tpu_torch.ops.ctc",
            "wav2vec2forbrain_tpu_torch.probe_determinism",
            "wav2vec2forbrain_tpu_torch.train.device_cache"} <= set(modules)
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED or m.split(".")[0] == "wav2vec2forbrain_tpu")
        assert not leaked, leaked
        print("clean", len({modules!r}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


@pytest.mark.parametrize("text", ["HELLO WORLD", "IT'S  A TEST", "zz? Q", ""])
def test_port_tokenizer_matches_jax_tokenizer(text):
    assert W2V_CTC_VOCAB == JAX_VOCAB
    port, ref = Wav2Vec2CTCTokenizer(), JaxTokenizer()
    assert port.encode(text) == ref.encode(text)
    rng = np.random.default_rng(len(text))
    ids = rng.integers(0, 32, (4, 25))
    ids[:, 3:6] = ids[:, 3:4]  # repeats for the CTC collapse
    for group in (True, False):
        assert port.batch_decode(ids, group_tokens=group) == ref.batch_decode(ids, group_tokens=group)
    assert port.decode(port.encode(text), group_tokens=False) == ref.decode(ref.encode(text), group_tokens=False)


def test_port_tokenizer_batches_and_resolves_like_jax(tmp_path):
    texts = ["HELLO WORLD", "A", "", "IT'S"]
    port, ref = Wav2Vec2CTCTokenizer(), JaxTokenizer()
    np.testing.assert_array_equal(port(texts).input_ids, ref(texts).input_ids)
    assert port(texts).input_ids.dtype == ref(texts).input_ids.dtype
    assert port.get_vocab_list() == ref.get_vocab_list() and port.eos_token_id == ref.eos_token_id
    (tmp_path / "vocab.json").write_text('{"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "X": 5}')
    for name in ("facebook/wav2vec2-base-100h", "some/unknown-checkpoint", str(tmp_path)):
        assert Wav2Vec2CTCTokenizer.from_pretrained(name).vocab == JaxTokenizer.from_pretrained(name).vocab


def test_run_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """The CLI builds its experiment on the card: where there is none it
    raises before touching any data; it never goes on on the CPU unasked."""
    import torch

    from wav2vec2forbrain_tpu_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(
        "".join(f"{k}: {tmp_path}/{k}\n" for k in ("cache_dir", "fig_dir", "n3gram_lm_model_path",
                                                   "n5gram_lm_model_path", "dataset_splits_dir"))
        + "wandb_api_key: offline\n")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.main(["--experiment_type=b2p2t_gru+w2v_conformer", "--w2v_skip_loading_weights=true"])
    assert not (tmp_path / "cache_dir").exists()


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    """On a machine without a CUDA card it fails and prints no result, both
    from the repository and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cmd, cwd, env in (
        ([sys.executable, "chip_smoke.py"], REPO, _env()),
        ([sys.executable, str(alone)], str(tmp_path), None),
    ):
        proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        assert "FAIL" in proc.stderr
