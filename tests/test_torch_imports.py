"""Import hygiene of the PyTorch port, its tokenizer against the JAX
package's, and chip_smoke.py's refusal to run without a CUDA card.

The GPU machine has no jax and no pydantic, so neither the port nor
chip_smoke.py may import them, not even indirectly; nor do they import the
JAX package itself."""

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
BLOCKED = ("jax", "jaxlib", "pydantic", "optax", "flax", "transformers")


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
            "wav2vec2forbrain_tpu_torch.ops.layernorm", "wav2vec2forbrain_tpu_torch.models.wav2vec2"} <= set(modules)
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
