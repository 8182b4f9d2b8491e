"""The port's CLI surface (args/flags.py, args/argparsing.py,
args/yaml_config.py, experiments/registry.py) against the JAX package's
pydantic models and parser: every flag's name, default, type and choices;
str_to_bool / str_to_list; the two-stage parse of the verify recipe's
command line; pydantic's coercion of the Union flags; the config.yaml
template, its bootstrap exit and the flat reader against yaml.safe_load."""

import argparse
import dataclasses
import os
import sys
import typing

import pytest
import yaml
from pydantic_core import PydanticUndefined

from wav2vec2forbrain_tpu.args import argparsing as jax_argparsing
from wav2vec2forbrain_tpu.args import base_args as jax_base
from wav2vec2forbrain_tpu.args import yaml_config as jax_yaml
from wav2vec2forbrain_tpu.experiments import args_models as jax_models
from wav2vec2forbrain_tpu.experiments.registry import experiments as jax_experiments
from wav2vec2forbrain_tpu.models import configs as jax_configs
from wav2vec2forbrain_tpu_torch.args import argparsing, flags, yaml_config
from wav2vec2forbrain_tpu_torch.experiments.registry import experiments

PAIRS = [
    (flags.B2TDatasetArgsModel, jax_base.B2TDatasetArgsModel),
    (flags.BaseExperimentArgsModel, jax_base.BaseExperimentArgsModel),
    (flags.B2P2TBrainFeatureExtractorArgsModel, jax_configs.B2P2TBrainFeatureExtractorArgsModel),
    (flags.W2VBrainEncoderModelArgs, jax_configs.W2VBrainEncoderModelArgs),
    (flags.B2TArgsModel, jax_models.B2TArgsModel),
    (flags.B2TGruAndW2VArgsModel, jax_models.B2TGruAndW2VArgsModel),
    (flags.B2TGruAndW2VConformerArgsModel, jax_models.B2TGruAndW2VConformerArgsModel),
]
UNION_FLAGS = ("scan_layers", "multi_step_chunk", "length_buckets")
# the tiny CPU training command line of the repository's verify recipe
RECIPE = ["--experiment_type=b2p2t_gru+w2v", "--epochs=2", "--batch_size=2", "--limit_samples=4",
          "--w2v_skip_loading_weights=true", "--encoder_gru_hidden_size=64", "--encoder_num_gru_layers=1"]


def _named(type_args: dict) -> dict:
    """argparse kwargs with the type converter by name (str_to_bool is a
    function of each package)."""
    return {k: getattr(v, "__name__", v) for k, v in type_args.items()}


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p.__name__ for p, _ in PAIRS])
def test_flags_mirror_the_pydantic_models(port, ref):
    fields = {f.name: f for f in dataclasses.fields(port)}
    assert list(fields) == list(ref.model_fields)  # same names, same order
    defaults = flags.defaults_of(port)
    for name, info in ref.model_fields.items():
        default = None if info.default is PydanticUndefined else info.default
        assert defaults[name] == default and type(defaults[name]) is type(default), name
        assert fields[name].type == info.annotation, name
        assert _named(argparsing._type_args_for(fields[name].type)) == _named(
            jax_argparsing._type_args_for(info.annotation)), name
    assert dataclasses.asdict(flags.validate(port, {})) == ref().model_dump()


def test_latent_sizes_and_registry_match():
    assert flags.PRETRAINED_LATENT_SIZES == jax_base.PRETRAINED_LATENT_SIZES
    assert sorted(experiments) == sorted(jax_experiments)
    for name in experiments:
        assert [f.name for f in dataclasses.fields(experiments[name].get_args_model())] == list(
            jax_experiments[name].get_args_model().model_fields)
    for registry in (experiments, jax_experiments):
        with pytest.raises(KeyError):
            registry["b2p2t_gru"]


@pytest.mark.parametrize("value", ["true", "T", "f", "FALSE", "none", "N", "yes", "0", ""])
def test_str_to_bool_and_str_to_list_match(value):
    def outcome(fn, v):
        try:
            return fn(v)
        except (argparse.ArgumentTypeError, ValueError) as e:
            return type(e).__name__

    assert outcome(argparsing.str_to_bool, value) == outcome(jax_argparsing.str_to_bool, value)
    for text in ("[256]", '[1, 2, "a"]', "[]", "3", "{}", "nope"):
        assert outcome(argparsing.str_to_list, text) == outcome(jax_argparsing.str_to_list, text)


@pytest.mark.parametrize("argv", [
    RECIPE,
    RECIPE + ["--scan_layers=false", "--multi_step_chunk=32", "--length_buckets=exact",
              "--encoder_fc_hidden_sizes=[256, 128]", "--gradient_clipping=1.0", "--use_wandb=t"],
    ["--experiment_type=b2p2t_gru+w2v_conformer", "--unfreeze_strategy=brain_encoder+w2v",
     "--w2v_learning_rate=1e-4", "--early_stopping_patience=3", "--multi_step_chunk=off", "--scan_layers=auto",
     "--adjust_global_lr_to_w2v_postwarmup_lr=n"],
], ids=["recipe", "recipe_unions", "conformer"])
def test_two_stage_parse_gives_the_same_values(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    ref_ns = jax_argparsing._create_arg_parser().parse_args(argv)
    got_ns = argparsing._create_arg_parser(argv).parse_args(argv)
    assert vars(got_ns) == vars(ref_ns)
    exp_type = vars(ref_ns)["experiment_type"]
    ref = jax_experiments[exp_type].get_args_model()(**vars(ref_ns)).model_dump()
    got = dataclasses.asdict(flags.validate(experiments[exp_type].get_args_model(), vars(got_ns)))
    assert got == ref
    for name in UNION_FLAGS:
        assert type(got[name]) is type(ref[name])


@pytest.mark.parametrize("name", UNION_FLAGS + ("batch_size", "use_wandb", "learning_rate", "area"))
@pytest.mark.parametrize("value", ["32", "auto", "off", "exact", "true", "false", "1", "0", "yes", "abc", "3.5",
                                   3.0, 7, True, None, "6v", "44"])
def test_pydantic_coercion_agrees(name, value):
    model, ref_model = flags.B2TGruAndW2VArgsModel, jax_models.B2TGruAndW2VArgsModel

    def outcome(fn):
        try:
            v = fn()
            return ("ok", v, type(v))
        except Exception:
            return ("error",)

    got = outcome(lambda: getattr(flags.validate(model, {name: value}), name))
    ref = outcome(lambda: getattr(ref_model(**{name: value}), name))
    assert got == ref, (name, value)


def test_pallas_kernels_are_checked_against_the_port_policy():
    for policy in ("auto", "none", "attention,gru", "preproc , layernorm"):
        assert flags.validate(flags.B2TGruAndW2VArgsModel, {"pallas_kernels": policy}).pallas_kernels == policy
        jax_models.B2TGruAndW2VArgsModel(pallas_kernels=policy)
    for policy in ("fast", "gru,nope", ","):
        with pytest.raises(ValueError):
            flags.validate(flags.B2TGruAndW2VArgsModel, {"pallas_kernels": policy})
        with pytest.raises(ValueError):
            jax_models.B2TGruAndW2VArgsModel(pallas_kernels=policy)


def _bootstrap(module, path):
    with pytest.raises(SystemExit) as info:
        module.YamlConfig(str(path))
    assert info.value.code == 0
    return path.read_text()


def test_missing_config_writes_the_template_and_exits_0(tmp_path):
    got = _bootstrap(yaml_config, tmp_path / "port.yaml")
    assert got == _bootstrap(jax_yaml, tmp_path / "jax.yaml")
    assert [f.name for f in dataclasses.fields(yaml_config.YamlConfigModel)] == list(
        jax_yaml.YamlConfigModel.model_fields)
    assert yaml_config.read_flat_yaml(str(tmp_path / "port.yaml")) == yaml.safe_load(got)


EDITED = """cache_dir: /tmp/ws/cache
fig_dir: '/tmp/ws/figs'
n3gram_lm_model_path: "/tmp/ws/lm 3gram.arpa"
n5gram_lm_model_path: ~
# a comment line
dataset_splits_dir: /tmp/ws/t12

wandb_api_key: offline
timit_dataset_splits_dir: some/dir
elevenlabs_api_key: null
"""


@pytest.mark.parametrize("text", [
    EDITED,
    EDITED.replace("n5gram_lm_model_path: ~", "n5gram_lm_model_path: /x/5gram.arpa"),
    EDITED + "wandb_entity: me\nunknown_key: kept-out\n",
], ids=["edited", "all_strings", "extra_keys"])
def test_flat_reader_agrees_with_yaml_and_the_schema(text, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    ref_content = yaml.safe_load(text)
    assert yaml_config.read_flat_yaml(str(path)) == ref_content

    def outcome(module):
        try:
            cfg = module.YamlConfig(str(path)).config
        except Exception:
            return "error"
        return {k: getattr(cfg, k) for k in ref_content if hasattr(cfg, k)}

    assert outcome(yaml_config) == outcome(jax_yaml)


@pytest.mark.parametrize("line", ["cache_dir: 123", "cache_dir: true", "cache_dir: [a, b]", "cache_dir: {a: 1}",
                                  "cache_dir:\n  nested: x", "- item", "cache_dir: &anchor x", "cache_dir: |",
                                  "cache_dir: a # comment", "cache_dir: 1.5e+3"])
def test_flat_reader_raises_on_anything_but_flat_strings(line, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(line + "\n")
    with pytest.raises(ValueError):
        yaml_config.read_flat_yaml(str(path))


def test_template_timit_line_reads_as_none_in_both(tmp_path):
    """The template's empty timit_dataset_splits_dir reads as None, which
    the str field refuses in both packages: a filled-in template must set it
    or drop the line."""
    text = _bootstrap(yaml_config, tmp_path / "t.yaml")
    assert "timit_dataset_splits_dir: \n" in text
    assert yaml_config.read_flat_yaml(str(tmp_path / "t.yaml"))["timit_dataset_splits_dir"] is None
    for module in (yaml_config, jax_yaml):
        with pytest.raises(Exception):
            module.YamlConfig(str(tmp_path / "t.yaml"))
    assert typing.get_type_hints(yaml_config.YamlConfigModel)["timit_dataset_splits_dir"] is str
    assert os.path.exists(tmp_path / "t.yaml")
