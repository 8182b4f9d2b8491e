"""Params bridge between the JAX package and the port (the layout side of
wav2vec2forbrain_tpu/models/convert.py).

The port keeps the JAX parameter structure, key names and (in, out) kernel
layouts, so a leaf crosses unchanged: numpy array <-> tensor, bit for bit.
This holds for both encoder families: the conformer (params and its
BatchNorm state) and wav2vec2 (pos_conv weight_g / weight_v / bias, the
layers, the encoder LN, lm_head; its state is {"encoder": {}}). The one
layout difference is the scan-stacked encoder (`layers_stacked`,
conformer.py::stack_conformer_layers, wav2vec2.py::stack_w2v_layers),
which the port holds as the per-layer list. `params_to_jax(...,
stacked=True)` restacks it.

The optimizer state crosses too: the JAX make_optimizer state (an optax
multi_transform with one Adam state per trained group, each holding count,
mu and nu over its own leaves) <-> the port's train/optim.py AdamState (one
count, and mu / nu trees over all trained leaves). The optax containers are
walked by duck typing, so this module imports neither jax nor optax.

The audio front end of the latent analysis crosses the same way
(`frontend_from_jax` / `frontend_to_jax`).

No jax import: the JAX side is passed as pytrees of numpy arrays
(`jax.tree_util.tree_map(np.asarray, tree)`).
"""

from typing import Tuple

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.tree import tree_leaves, tree_map


def _unstack(stacked: dict) -> list:
    """{leaf: (L, ...)} -> [{leaf: (...)}] * L."""
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(first.shape[0])]


def _stack(items: list):
    """[{leaf: (...)}] * L -> {leaf: (L, ...)}: numpy arrays or tensors; a
    None leaf (a moment tree's frozen leaf) stays None."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    if items[0] is None:
        return None
    return torch.stack(items) if isinstance(items[0], torch.Tensor) else np.stack(items)


def unstack_encoder(params: dict, state: dict) -> Tuple[dict, dict]:
    """A model's (params, state) with a scan-stacked encoder
    (`layers_stacked` in params["w2v"]["encoder"] and state["encoder"]) as
    the per-layer list; other trees (no "w2v" subtree) as they are."""
    if "w2v" not in params:
        return params, state
    enc, enc_state = dict(params["w2v"]["encoder"]), dict(state.get("encoder", {}))
    if "layers_stacked" in enc:
        enc["layers"] = _unstack(enc.pop("layers_stacked"))
    if "layers_stacked" in enc_state:
        enc_state["layers"] = _unstack(enc_state.pop("layers_stacked"))
    return dict(params, w2v=dict(params["w2v"], encoder=enc)), dict(state, encoder=enc_state)


def stack_encoder(params: dict, state: dict) -> Tuple[dict, dict]:
    """Inverse of unstack_encoder: the encoder's per-layer list (and the
    conformer's BatchNorm state list) as `layers_stacked`, the JAX
    package's --scan_layers layout. Also for a moment tree like the params
    (with state {})."""
    enc, enc_state = dict(params["w2v"]["encoder"]), dict(state.get("encoder", {}))
    if "layers" in enc:
        enc["layers_stacked"] = _stack(enc.pop("layers"))
    if "layers" in enc_state:
        enc_state["layers_stacked"] = _stack(enc_state.pop("layers"))
    return dict(params, w2v=dict(params["w2v"], encoder=enc)), dict(state, encoder=enc_state)


def params_from_jax(params: dict, state: dict, device="cuda") -> Tuple[dict, dict]:
    """JAX (params, state) as numpy pytrees -> the port's (params, state),
    tensors on `device` (the card unless the caller asks for another;
    raises where there is no card). Accepts per-layer and scan-stacked
    encoders."""
    params, state = unstack_encoder(params, state)

    def to_tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return tree_map(to_tensor, params), {"encoder": tree_map(to_tensor, state["encoder"])}


def frontend_from_jax(tree: dict, device="cuda") -> dict:
    """A JAX audio front-end tree (models/audio_frontend.py's, as numpy) ->
    the port's, tensors on `device` (the card unless the caller asks for
    another); the same structure and layouts, bit for bit."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def frontend_to_jax(tree: dict) -> dict:
    """Inverse of frontend_from_jax: numpy arrays in the JAX layout."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def params_to_jax(params: dict, state: dict, stacked: bool = False) -> Tuple[dict, dict]:
    """Inverse of params_from_jax: numpy pytrees in the JAX layout;
    stacked=True emits the scan-stacked conformer layout."""
    np_params = tree_map(lambda t: t.detach().cpu().numpy(), params)
    np_state = tree_map(lambda t: t.detach().cpu().numpy(), state)
    return stack_encoder(np_params, np_state) if stacked else (np_params, np_state)


# --- optimizer state and labels ---------------------------------------------------


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _adam_states(node):
    """Every optax ScaleByAdamState-like node (count, mu, nu) in an optax
    state (duck-typed: no optax import)."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return [node]
    if isinstance(node, dict):
        return [s for v in node.values() for s in _adam_states(v)]
    if isinstance(node, (list, tuple)):
        return [s for v in node for s in _adam_states(v)]
    return []


def _merge_moments(trees, params, device, dtype_of):
    """Leaf-wise union of the per-group moment trees (arrays where the group
    owns the leaf, optax MaskedNode / None elsewhere) in params' structure;
    None where no group owns the leaf."""

    def go(p, subs):
        if isinstance(p, dict):
            return {k: go(p[k], [None if s is None or not isinstance(s, dict) else s.get(k) for s in subs]) for k in p}
        if isinstance(p, (list, tuple)):
            return [go(v, [s[i] if isinstance(s, (list, tuple)) and len(s) > i else None for s in subs])
                    for i, v in enumerate(p)]
        for s in subs:
            if _is_array(s):
                a = np.asarray(s)
                # numpy has no native bf16 (ml_dtypes): cross as f32, exactly
                host = a.astype(np.float32) if str(a.dtype) == "bfloat16" else np.array(a, copy=True)
                return torch.from_numpy(host).to(device=device, dtype=dtype_of(a))
        return None

    return go(params, trees)


def opt_state_from_jax(jax_opt_state, params: dict, device=None):
    """A JAX optimizer state (make_optimizer's multi_transform over the
    trainable tree, pulled to the host with jax.device_get) -> the port's
    train/optim.py AdamState for `params` (the port's tree), its moments on
    `device`, by default the device of `params`. Moments keep their dtype
    (f32, or bf16 under --adam_mu_dtype / --adam_nu_dtype)."""
    from wav2vec2forbrain_tpu_torch.train.optim import AdamState

    if device is None:
        device = tree_leaves(params)[0].device

    states = _adam_states(jax_opt_state)
    if not states:
        raise ValueError("opt_state_from_jax: no Adam state (count, mu, nu) found")
    counts = {int(np.asarray(s.count)) for s in states}
    if len(counts) != 1:
        raise ValueError(f"opt_state_from_jax: the groups disagree on the step count {counts}")

    def dtype_of(a):
        return torch.bfloat16 if str(a.dtype) == "bfloat16" else getattr(torch, str(a.dtype))

    mu = _merge_moments([s.mu for s in states], params, device, dtype_of)
    nu = _merge_moments([s.nu for s in states], params, device, dtype_of)
    return AdamState(counts.pop(), mu, nu)


def opt_state_to_jax(state, template):
    """The port's AdamState -> a JAX optimizer state with `template`'s
    structure (e.g. jax.device_get(tx.init(trainable))): count, mu and nu
    of every group replaced, as numpy arrays in the template's dtypes."""

    def fill(tmpl, ours):
        if isinstance(tmpl, dict):
            return {k: fill(v, ours[k]) for k, v in tmpl.items()}
        if isinstance(tmpl, list):
            return [fill(v, ours[i]) for i, v in enumerate(tmpl)]
        if _is_array(tmpl):
            return ours.detach().float().cpu().numpy().astype(tmpl.dtype)
        return tmpl  # MaskedNode / None: a leaf the group does not own

    def rebuild(node):
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            return node._replace(
                count=np.asarray(state.count, dtype=np.asarray(node.count).dtype),
                mu=fill(node.mu, state.mu),
                nu=fill(node.nu, state.nu),
            )
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(rebuild(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return node

    return rebuild(template)


def labels_from_jax(labels: dict) -> dict:
    """The JAX param_labels tree of a per-layer (unstacked) model -> the
    port's: the same nested dict / list of "brain" / "w2v" / "frozen"."""
    if "layers_stacked" in labels["w2v"]["encoder"]:
        raise ValueError("labels_from_jax: label the per-layer (unstacked) JAX params")
    return tree_map(lambda x: x, labels)
