"""Offline reader of Hugging Face checkpoints in a local hub cache, without
transformers, huggingface_hub or safetensors.

`snapshot_dir` finds a checkpoint as `from_pretrained(checkpoint,
cache_dir=...)` does offline: `<cache_dir>/models--{org}--{name}/refs/main`
names the revision, whose files are in `snapshots/<revision>/`; a
checkpoint that is itself a directory is read from there. `read_state_dict`
reads its weights in transformers' order of preference:
1. model.safetensors (an 8-byte little-endian header length, a JSON
   header of {name: {dtype, shape, data_offsets}}, the raw bytes);
2. model.safetensors.index.json (its weight_map's shards);
3. pytorch_model.bin (torch.load, weights_only);
4. pytorch_model.bin.index.json.
Floating tensors come out at f32, as `from_pretrained` hands them to the
JAX package's converter. A checkpoint that is not in the cache raises
FileNotFoundError naming where it looked; nothing is downloaded.
"""

import json
import os
from typing import Dict, Optional

import torch

SAFETENSORS = "model.safetensors"
BIN = "pytorch_model.bin"
WEIGHT_FILES = (SAFETENSORS, SAFETENSORS + ".index.json", BIN, BIN + ".index.json")
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64}


def hub_cache_dir(cache_dir: Optional[str]) -> str:
    """`cache_dir`, else the hub cache transformers would use
    ($HF_HUB_CACHE, else $HF_HOME/hub, else ~/.cache/huggingface/hub)."""
    if cache_dir:
        return cache_dir
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def snapshot_dir(checkpoint: str, cache_dir: Optional[str] = None) -> str:
    """The directory that holds the checkpoint's files."""
    if os.path.isdir(checkpoint):
        return checkpoint
    repo = os.path.join(hub_cache_dir(cache_dir), "models--" + checkpoint.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        raise FileNotFoundError(
            f"pretrained checkpoint {checkpoint!r} is not in the local hub cache: no {ref} "
            "(put its snapshot there, see README; nothing is downloaded)")
    with open(ref) as f:
        revision = f.read().strip()
    path = os.path.join(repo, "snapshots", revision)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"pretrained checkpoint {checkpoint!r}: refs/main names {revision}, "
                                f"but {path} does not exist")
    return path


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: short read")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has the unsupported dtype {info['dtype']}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end > len(data):
            raise ValueError(f"{path}: {name} lies past the end of the file")
        flat = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize, offset=begin) \
            if end > begin else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def _read_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_state_dict(checkpoint: str, cache_dir: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The checkpoint's flat state dict, floating tensors at f32."""
    root = snapshot_dir(checkpoint, cache_dir)
    name = next((n for n in WEIGHT_FILES if os.path.isfile(os.path.join(root, n))), None)
    if name is None:
        raise FileNotFoundError(f"pretrained checkpoint {checkpoint!r}: none of {', '.join(WEIGHT_FILES)} "
                                f"in {root}")
    path = os.path.join(root, name)
    if name.endswith(".index.json"):
        with open(path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd = {}
        for shard in shards:
            sd.update(_read_file(os.path.join(root, shard)))
    else:
        sd = _read_file(path)
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
