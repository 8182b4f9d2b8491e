"""Checkpoint converter (counterpart of tools/convert_checkpoint.py):

    # a pretrained HF encoder (+ lm_head, + BatchNorm state), read offline
    # from the hub cache under --cache_dir (models/hf_snapshot.py):
    python -m wav2vec2forbrain_tpu_torch.convert hf facebook/wav2vec2-base-960h out.pt [--cache_dir DIR]

    # the original reference repo's brain_encoder.pt -> params["brain"]:
    python -m wav2vec2forbrain_tpu_torch.convert brain brain_encoder.pt out.pt

    # the reference's full model.pt (family and encoder layer count):
    python -m wav2vec2forbrain_tpu_torch.convert model model.pt out.pt [--family wav2vec2|conformer --layers N]

    # a model.* or brain_encoder.* checkpoint from one package to the other:
    python -m wav2vec2forbrain_tpu_torch.convert to-msgpack model.pt model.msgpack
    python -m wav2vec2forbrain_tpu_torch.convert to-pt model.msgpack model.pt

    # a port run's train_state/ (state.pt) -> the JAX package's layout
    # (state.msgpack and history.json in OUT_DIR), for its --resume_train_state;
    # --scan_layers: the encoder scan-stacked, for a JAX run at --scan_layers
    python -m wav2vec2forbrain_tpu_torch.convert train-state <results>/train_state OUT_DIR [--scan_layers]

An output that ends in .msgpack is written in the JAX package's format
(flax msgpack, which its --from_checkpoint / --brain_encoder_path read),
any other as the port's torch file (train/checkpoint.py). A .msgpack input
with a scan-stacked encoder comes out per layer. train-state reads the
experiment type, --unfreeze_strategy, --optimizer and --seed from the run's
config.json beside train_state/ (train/jax_train_state.py). The converter
moves weights only: it runs no model, so it needs no card and sets no
numerics flags. The other direction needs no converter: the port's
--resume_train_state takes a state.msgpack.
"""

import argparse
import json
import os
import shutil
import sys

import torch

from wav2vec2forbrain_tpu_torch.args.flags import validate
from wav2vec2forbrain_tpu_torch.experiments.registry import experiments
from wav2vec2forbrain_tpu_torch.models.convert import brain_encoder_from_torch, full_model_from_torch, state_dict_from
from wav2vec2forbrain_tpu_torch.models.pretrained import load_pretrained_encoder
from wav2vec2forbrain_tpu_torch.train.checkpoint import load_bundle, load_tree, save_bundle, save_checkpoint, save_subtree
from wav2vec2forbrain_tpu_torch.train.jax_train_state import write_jax_train_state


def _reference_state_dict(path: str):
    """A reference repo's torch.save(model.state_dict()) file."""
    return state_dict_from(torch.load(path, map_location="cpu", weights_only=True))


def convert_hf(checkpoint: str, out: str, cache_dir=None) -> None:
    enc, head, state = load_pretrained_encoder(checkpoint, cache_dir)
    save_checkpoint(out, {"encoder": enc, "lm_head": head}, state)


def convert_brain(src: str, out: str) -> None:
    save_subtree(out, brain_encoder_from_torch(_reference_state_dict(src)))


def convert_model(src: str, out: str, family: str, layers: int) -> None:
    params, state = full_model_from_torch(_reference_state_dict(src), family, layers)
    save_checkpoint(out, params, state)


def convert_format(src: str, out: str) -> None:
    """A checkpoint bundle ({"params"[, "state"]}) in the other format."""
    save_bundle(out, load_bundle(src))


def convert_train_state(src: str, out_dir: str, scan_layers: bool = False) -> str:
    """A port train_state/ directory -> OUT_DIR/state.msgpack (and its
    history.json); returns the .msgpack's path."""
    src = os.path.abspath(src)
    with open(os.path.join(os.path.dirname(src), "config.json")) as f:
        raw = json.load(f)
    cfg = validate(experiments[raw["experiment_type"]].get_args_model(), raw)
    bundle = load_tree(os.path.join(src, "state.pt"))
    out = os.path.join(out_dir, "state.msgpack")
    write_jax_train_state(out, bundle["params"], bundle["state"], bundle["opt"], bundle["epoch"], cfg.seed,
                          cfg.unfreeze_strategy, cfg.optimizer, stacked=scan_layers)
    history = os.path.join(src, "history.json")
    if os.path.exists(history) and os.path.abspath(out_dir) != src:
        shutil.copyfile(history, os.path.join(out_dir, "history.json"))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m wav2vec2forbrain_tpu_torch.convert",
                                     description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    hf = sub.add_parser("hf", help="a pretrained HF encoder from the local hub cache")
    hf.add_argument("--cache_dir", default=None, help="the hub cache (config.yaml's cache_dir)")
    sub.add_parser("brain", help="the reference's brain_encoder.pt")
    model = sub.add_parser("model", help="the reference's full model.pt")
    model.add_argument("--family", choices=("wav2vec2", "conformer"), default="conformer")
    model.add_argument("--layers", type=int, default=24)
    sub.add_parser("to-msgpack", help="a port .pt checkpoint -> the JAX package's .msgpack")
    sub.add_parser("to-pt", help="a JAX package .msgpack checkpoint -> the port's .pt")
    state = sub.add_parser("train-state", help="a port train_state/ -> the JAX package's state.msgpack in OUT")
    state.add_argument("--scan_layers", action="store_true", help="write the encoder scan-stacked")
    for p in sub.choices.values():
        p.add_argument("src")
        p.add_argument("out")
    args = parser.parse_args(argv)
    if args.mode == "train-state":
        print(f"wrote {convert_train_state(args.src, args.out, args.scan_layers)}")
        return
    if args.mode == "hf":
        convert_hf(args.src, args.out, args.cache_dir)
    elif args.mode == "brain":
        convert_brain(args.src, args.out)
    elif args.mode == "model":
        convert_model(args.src, args.out, args.family, args.layers)
    else:
        want = ".msgpack" if args.mode == "to-msgpack" else ".pt"
        if not args.out.endswith(want) or args.src.endswith(want):
            parser.error(f"{args.mode} writes a {want} file from the other format: got {args.src} -> {args.out}")
        convert_format(args.src, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
