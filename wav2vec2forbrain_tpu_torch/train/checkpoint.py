"""Checkpoint I/O for the port's param / state trees (counterpart of
wav2vec2forbrain_tpu/train/checkpoint.py, which writes flax msgpack).

A checkpoint is {"params": tree, "state": tree} (a subtree such as the
brain encoder: {"params": tree}): nested dicts and lists of CPU tensors, in
the JAX package's tree structure and key names (bridge.py). The file's
suffix picks its format:
- `.pt`: `torch.save`, read back with `torch.load(weights_only=True)`;
- `.msgpack`: the JAX package's own files (flax msgpack, lists as
  {"0": ...} maps; train/msgpack_codec.py), read and written without
  flax; a scan-stacked encoder (`layers_stacked`) is read as the per-layer
  list (bridge.py::unstack_encoder).
The results dir keeps the JAX package's layout with `.pt` for `.msgpack`:
model.pt, brain_encoder.pt, train_state/state.pt.
"""

import os
from typing import Optional, Tuple

import torch

from wav2vec2forbrain_tpu_torch.bridge import unstack_encoder
from wav2vec2forbrain_tpu_torch.parallel.tensor import split_tree
from wav2vec2forbrain_tpu_torch.train.msgpack_codec import read_msgpack, relistify, to_state_dict, write_msgpack
from wav2vec2forbrain_tpu_torch.tree import tree_map


def to_cpu(tree):
    """A detached CPU copy of a tensor tree (None leaves stay None)."""
    return tree_map(lambda t: None if t is None else t.detach().to("cpu", copy=True), tree)


def save_tree(path: str, bundle) -> None:
    """torch.save through a temporary file, so a reader never sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)


def load_tree(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_bundle(path: str, bundle: dict) -> None:
    """A checkpoint bundle in the format of the path's suffix."""
    if path.endswith(".msgpack"):
        write_msgpack(path, to_state_dict(to_cpu(bundle)))
    else:
        save_tree(path, to_cpu(bundle))


def load_bundle(path: str) -> dict:
    """A checkpoint bundle of either format, as CPU tensor trees."""
    if not path.endswith(".msgpack"):
        return load_tree(path)
    bundle = relistify(read_msgpack(path))
    if "state" in bundle:  # a whole model: its encoder per layer
        bundle["params"], bundle["state"] = unstack_encoder(bundle["params"], bundle["state"])
    return bundle


def save_checkpoint(path: str, params: dict, state: Optional[dict] = None) -> None:
    save_bundle(path, {"params": params, "state": state or {}})


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """(params, state) as CPU tensor trees."""
    bundle = load_bundle(path)
    return bundle["params"], bundle.get("state", {})


def load_into(path: str, params: dict, state: dict, tp=None) -> None:
    """Copy a checkpoint's params (and BN state, where it has one) into the
    given trees in place. A file holds whole trees; with tp (a
    parallel/tensor.py::TensorShard) params holds this rank's pieces, and
    the file's are split to them."""
    loaded, loaded_state = load_checkpoint(path)
    copy_into(params, split_tree(loaded, tp))
    if loaded_state:
        copy_into(state, loaded_state)


def save_subtree(path: str, subtree: dict) -> None:
    """e.g. the brain encoder alone (--store_brain_encoder)."""
    save_bundle(path, {"params": subtree})


def copy_into(dst, src, where: str = "") -> None:
    """Copy a loaded tree into `dst`'s tensors in place; the structure and
    the shapes must match (a strict load)."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError(f"checkpoint tree mismatch at {where or '/'}: "
                             f"{sorted(dst) if isinstance(dst, dict) else dst} vs "
                             f"{sorted(src) if isinstance(src, dict) else type(src).__name__}")
        for k in dst:
            copy_into(dst[k], src[k], f"{where}/{k}")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError(f"checkpoint tree mismatch at {where}: a list of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            copy_into(d, s, f"{where}/{i}")
    elif dst is None:
        if src is not None:
            raise ValueError(f"checkpoint tree mismatch at {where}: expected no tensor")
    else:
        if not isinstance(src, torch.Tensor) or tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint tree mismatch at {where}: shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
