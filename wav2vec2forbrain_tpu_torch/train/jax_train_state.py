"""The JAX package's train state, read and written without jax or flax
(counterpart of wav2vec2forbrain_tpu/train/train_loop.py::
Trainer._save_train_state and restore_train_state).

`train_state/state.msgpack` (flax msgpack, train/msgpack_codec.py), with
history.json beside it, holds
- params: the merged params as a flax state dict, the encoder per layer
  or scan-stacked (`layers_stacked`, under --scan_layers);
- state: the BatchNorm state the same way ({"encoder": {}} for wav2vec2);
- opt_leaves: {"0": ..., "n-1": ...}, the optax state's leaves in
  jax.tree_util.tree_flatten order;
- rng: the raw step key (uint32);
- epoch: the last epoch trained.

The leaf order (`opt_leaf_layout`). make_optimizer is an optax
multi_transform over the labels "brain", "frozen" and "w2v", whose inner
states flatten in sorted key order. "frozen" (set_to_zero) keeps no leaves.
A trained group is a MaskedState around its chain: add_decayed_weights
where weight_decay != 0 (an EmptyState, no leaves), then
ScaleByAdamState(count, mu, nu), mu and nu each spanning the trainable
params tree with masked nodes (no leaves) outside the group. So the
leaves are brain's count, its mu leaves and its nu leaves, then w2v's,
the moments in the params' flatten order (dict keys sorted, lists in
order). A group with no trained leaf still has its count; SGD has no
leaves, and a state read from it restarts the port's count (which SGD
does not use) at 0. The groups step together, so their counts agree: the
port keeps one AdamState(count, mu, nu), moments in their storage dtypes
(--adam_mu_dtype / --adam_nu_dtype).

The step key does not cross: jax.random's streams are not torch's. The
port drops a JAX state's key and runs its streams as a fresh run with that
--seed does (Trainer.restore_train_state). A state written for the JAX
package carries the key a fresh JAX run starts from, PRNGKey(seed + 1)
(wav2vec2forbrain_tpu/experiments/impl.py), in the "rbg" implementation
that the JAX package's configure_jax makes the default: [0, s, 0, s].
"""

import os
from typing import List, Tuple

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.bridge import stack_encoder, unstack_encoder
from wav2vec2forbrain_tpu_torch.models.assembly import param_labels
from wav2vec2forbrain_tpu_torch.train.msgpack_codec import read_msgpack, relistify, to_state_dict, write_msgpack

GROUPS = ("brain", "w2v")  # the trained groups, in multi_transform's (sorted) order; "frozen" has no leaves
STACKED, PER_LAYER = "layers_stacked", "layers"


def _flat(tree, path: tuple = ()) -> List[Tuple[tuple, object]]:
    """(path, leaf) pairs in jax.tree_util's flatten order: dict keys
    sorted, lists in order, None skipped."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flat(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _map(fn, tree, path: tuple = ()):
    """fn(path, leaf) over a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def opt_leaf_layout(params: dict, labels: dict, optimizer: str) -> List[Tuple[str, str, tuple]]:
    """(group, "count" | "mu" | "nu", params path or None) of each leaf of
    make_optimizer's state over `params` (in the layout the JAX run keeps:
    per layer or scan-stacked) with these labels, in flatten order."""
    if optimizer != "adam":
        return []
    label_of = dict(_flat(labels))
    layout = []
    for group in GROUPS:
        mine = [path for path, _ in _flat(params) if label_of[path] == group]
        layout += [(group, "count", None)] + [(group, "mu", p) for p in mine] + [(group, "nu", p) for p in mine]
    return layout


def _per_layer_path(path: tuple, leaf):
    """A JAX-layout moment leaf as (port path, tensor) pairs: one per layer
    where the encoder is scan-stacked."""
    if STACKED not in path:
        return [(path, leaf)]
    j = path.index(STACKED)
    return [(path[:j] + (PER_LAYER, i) + path[j + 1:], leaf[i]) for i in range(leaf.shape[0])]


def read_jax_train_state(path: str, unfreeze_strategy: str, optimizer: str) -> dict:
    """A JAX state.msgpack as the port's train-state bundle: {"params",
    "state"} per layer, "opt": {"count", "mu", "nu"} (moment trees like the
    params, None where no group trains a leaf; None under SGD), "epoch"
    (CPU tensors)."""
    bundle = relistify(read_msgpack(path))
    params_j, state_j = bundle["params"], bundle["state"]
    leaves = bundle["opt_leaves"]
    if isinstance(leaves, dict):  # relistify leaves {} (no leaves) a map
        leaves = [leaves[str(i)] for i in range(len(leaves))]
    layout = opt_leaf_layout(params_j, param_labels(params_j, unfreeze_strategy), optimizer)
    if len(leaves) != len(layout):
        raise ValueError(f"{path}: {len(leaves)} optimizer leaves, but --optimizer={optimizer} "
                         f"--unfreeze_strategy={unfreeze_strategy} over its params make {len(layout)}")
    counts, moments = {}, {"mu": {}, "nu": {}}
    for (group, field, p), leaf in zip(layout, leaves):
        if field == "count":
            counts[group] = int(leaf)
            continue
        want = tuple(_get(params_j, p).shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"{path}: opt leaf {group} {field} /{'/'.join(map(str, p))} has shape "
                             f"{tuple(leaf.shape)}, its param {want}")
        moments[field].update(_per_layer_path(p, leaf))
    if len(set(counts.values())) > 1:
        raise ValueError(f"{path}: the groups disagree on the step count {counts}")
    params, state = unstack_encoder(params_j, state_j)
    opt = {"count": next(iter(counts.values()), 0), "mu": None, "nu": None}
    if optimizer == "adam":
        for field, found in moments.items():
            opt[field] = _map(lambda p, _leaf, found=found: found.get(p), params)
    return {"params": params, "state": state, "opt": opt, "epoch": int(bundle["epoch"])}


def jax_step_key(seed: int) -> np.ndarray:
    """The raw data of the JAX package's fresh step key, PRNGKey(seed + 1),
    under its default "rbg" implementation (two threefry seeds: a 32-bit
    seed s gives [0, s, 0, s])."""
    s = seed + 1
    if not -(2**31) <= s < 2**31:
        raise ValueError(f"seed {seed}: the JAX package's seeds are 32-bit")
    return np.array([0, s % 2**32, 0, s % 2**32], dtype=np.uint32)


def write_jax_train_state(path: str, params: dict, state: dict, opt: dict, epoch: int, seed: int,
                          unfreeze_strategy: str, optimizer: str, stacked: bool = False) -> None:
    """A port train state (params, BN state, opt {"count", "mu", "nu"}, per
    layer) as the JAX package's state.msgpack, its encoder per layer or
    scan-stacked (`stacked`, the JAX run's --scan_layers)."""
    mu, nu = opt["mu"], opt["nu"]
    if stacked:
        params, state = stack_encoder(params, state)
        if mu is not None:
            mu, nu = stack_encoder(mu, {})[0], stack_encoder(nu, {})[0]
    leaves = []
    for group, field, p in opt_leaf_layout(params, param_labels(params, unfreeze_strategy), optimizer):
        if field == "count":
            leaves.append(torch.tensor(int(opt["count"]), dtype=torch.int32))
            continue
        leaf = _get(mu if field == "mu" else nu, p)
        if leaf is None:
            raise ValueError(f"the port state has no {field} for /{'/'.join(map(str, p))} ({group})")
        leaves.append(leaf)
    bundle = {
        "params": to_state_dict(params),
        "state": to_state_dict(state),
        "opt_leaves": {str(i): leaf for i, leaf in enumerate(leaves)},
        "rng": jax_step_key(seed),
        "epoch": int(epoch),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_msgpack(path, bundle)
