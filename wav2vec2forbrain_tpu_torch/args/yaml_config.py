"""The environment's config.yaml (counterpart of
wav2vec2forbrain_tpu/args/yaml_config.py).

Same fields and defaults. The first run writes a template (one
`name: value` line a field, defaults filled in where they exist) and exits
with status 0 so that the user can edit it; every later run reads the file
and checks it against the schema. The GPU machine has no `yaml`, so the
file is read by `read_flat_yaml`: flat `name: value` lines whose values are
plain or quoted strings (an empty value, `~` or `null` is None, as YAML has
it). Anything else (nesting, lists, flow or block scalars, anchors, tags,
values YAML would read as a number or a boolean) raises: the reader does
not guess.
"""

import dataclasses
import os
import re
from dataclasses import dataclass
from typing import Optional

from wav2vec2forbrain_tpu_torch.args.flags import coerce

default_value = "<your value here>"
_REQUIRED = object()


@dataclass
class YamlConfigModel:
    cache_dir: str
    fig_dir: str
    n3gram_lm_model_path: str
    n5gram_lm_model_path: str
    dataset_splits_dir: str
    wandb_api_key: str
    wandb_project_name: str = "brain2text"
    wandb_entity: str = "machine-learning-hpi"
    timit_dataset_splits_dir: str = ""
    elevenlabs_api_key: Optional[str] = None
    latent_analysis_working_dir: str = "latent_analysis"


def _check(config: dict) -> YamlConfigModel:
    errors, kwargs = [], {}
    for f in dataclasses.fields(YamlConfigModel):
        if f.name not in config:
            if f.default is dataclasses.MISSING:
                errors.append(f"{f.name}: field required")
            continue
        value = config[f.name]
        # strict strings: pydantic does not turn a number into a str
        if value is not None and not isinstance(value, str):
            errors.append(f"{f.name}: {value!r} is not a valid string")
            continue
        try:
            kwargs[f.name] = coerce(f.type, value)
        except ValueError as e:
            errors.append(f"{f.name}: {e}")
    if errors:
        raise ValueError("; ".join(errors))
    return YamlConfigModel(**kwargs)


_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")
_NULL = {"", "~", "null", "Null", "NULL"}
# plain scalars YAML 1.1 (PyYAML) resolves to something other than a string
_NOT_STR = re.compile(
    r"^(?:y|Y|yes|Yes|YES|n|N|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF"
    r"|[-+]?(?:0|[1-9][0-9_]*)|0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+"
    r"|[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?|=|<<|\d{4}-\d\d?-\d\d?.*)$"
)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _scalar(text: str, lineno: int):
    text = text.strip()
    if text in _NULL:
        return None
    if text[0] in "'\"":
        quote = text[0]
        if len(text) < 2 or text[-1] != quote or quote in text[1:-1] or "\\" in text[1:-1]:
            raise ValueError(f"line {lineno}: unsupported quoted value {text!r}")
        return text[1:-1]
    if text[0] in _INDICATORS or " #" in text or ": " in text or text.endswith(":") or "\t" in text:
        raise ValueError(f"line {lineno}: {text!r} is not a plain string value")
    if _NOT_STR.match(text):
        raise ValueError(f"line {lineno}: {text!r} would not read as a string")
    return text


def read_flat_yaml(path: str) -> dict:
    """{name: str or None} from flat `name: value` lines (see the module's
    docstring); raises ValueError on anything else."""
    out = {}
    with open(path, "r") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.rstrip("\n").rstrip("\r")
            if not line.strip() or line.lstrip().startswith("#") or line.strip() in ("---", "..."):
                continue
            m = _KEY.match(line.rstrip())
            if m is None:
                raise ValueError(f"{path} line {lineno}: not a flat 'name: value' line: {line!r}")
            name, value = m.group(1), m.group(2) or ""
            if name in out:
                raise ValueError(f"{path} line {lineno}: {name} given twice")
            out[name] = _scalar(value, lineno)
    return out


class YamlConfig:
    def __init__(self, config_path: str = "config.yaml"):
        self.config_path = config_path
        self.config = self._load_config()

    def _template_lines(self):
        for f in dataclasses.fields(YamlConfigModel):
            default = f.default
            if default is dataclasses.MISSING or default is None:
                default = default_value
            yield f"{f.name}: {default}\n"

    def _load_config(self) -> YamlConfigModel:
        if not os.path.exists(self.config_path):
            with open(self.config_path, "w") as f:
                f.writelines(self._template_lines())
            print(
                f"\nWrote a starter {self.config_path} to the project root — "
                "edit the placeholder values, then rerun."
            )
            raise SystemExit(0)
        file_content = read_flat_yaml(self.config_path)
        try:
            return _check(file_content)
        except Exception as e:
            raise Exception(f"{self.config_path} failed schema validation:\n{e}")
