"""Two-stage argparse CLI (counterpart of
wav2vec2forbrain_tpu/args/argparsing.py).

Stage 1 parses the base flags to learn `experiment_type`; stage 2 builds the
full parser from that experiment's flags dataclass (args/flags.py). The
flag types are the JAX package's: a `Literal` is a string with choices, a
bool goes through `str_to_bool`, a list through `str_to_list`, int / float /
str are themselves, and anything else (the `Union` flags) stays a string
for `flags.validate` to coerce, as pydantic coerces it.
"""

import argparse
import dataclasses
import json
import typing
from typing import Any, Literal, Optional

from wav2vec2forbrain_tpu_torch.args.flags import BaseExperimentArgsModel, defaults_of, unwrap_optional
from wav2vec2forbrain_tpu_torch.args.yaml_config import YamlConfig


def str_to_bool(value: str):
    if value.lower() in ["true", "t"]:
        return True
    elif value.lower() in ["false", "f"]:
        return False
    elif value.lower() in ["none", "n"]:
        return None
    else:
        raise argparse.ArgumentTypeError("Invalid boolean value: {}".format(value))


def str_to_list(value: str):
    parsed = json.loads(value)
    if not isinstance(parsed, list):
        raise argparse.ArgumentTypeError("Invalid list value: {}".format(value))
    return parsed


def _type_args_for(annotation: Any) -> dict:
    annotation = unwrap_optional(annotation)
    origin = typing.get_origin(annotation)
    if origin is Literal:
        return {"type": str, "choices": typing.get_args(annotation)}
    if annotation is bool:
        return {"type": str_to_bool}
    if origin is list or annotation is list:
        return {"type": str_to_list}
    if annotation in (int, float, str):
        return {"type": annotation}
    return {"type": str}


def _parser_from_model(parser: argparse.ArgumentParser, model) -> argparse.ArgumentParser:
    """Add a flags dataclass's fields as CLI flags."""
    defaults = defaults_of(model)
    for f in dataclasses.fields(model):
        parser.add_argument(f"--{f.name}", dest=f.name, default=defaults[f.name], **_type_args_for(f.type))
    return parser


def _get_experiments():
    from wav2vec2forbrain_tpu_torch.experiments.registry import experiments

    return experiments


def _create_arg_parser(argv: Optional[list] = None) -> argparse.ArgumentParser:
    base_parser = argparse.ArgumentParser(add_help=False)
    base_parser = _parser_from_model(base_parser, BaseExperimentArgsModel)
    base_args, _ = base_parser.parse_known_args(argv)

    experiments = _get_experiments()
    if base_args.experiment_type not in experiments:
        raise KeyError(
            f"Unknown experiment_type {base_args.experiment_type!r}. "
            f"Registered: {sorted(experiments.keys())}"
        )
    experiment_model = experiments[base_args.experiment_type].get_args_model()
    parser = argparse.ArgumentParser(description="Machine Learning Experiment Configuration")
    return _parser_from_model(parser, experiment_model)


def get_experiment_from_args(argv: Optional[list] = None, device: str = "cuda"):
    """Parse argv (sys.argv by default), read ./config.yaml and build the
    experiment on `device` (the card unless the caller asks for another)."""
    arg_parser = _create_arg_parser(argv)
    args = arg_parser.parse_args(argv)
    yaml_config = YamlConfig()
    experiments = _get_experiments()
    return experiments[args.experiment_type](vars(args), yaml_config.config, device=device)
