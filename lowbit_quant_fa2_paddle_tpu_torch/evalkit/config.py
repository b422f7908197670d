"""Layered inference config with documented precedence
(reference inferenceKit utils/config.py:46-93 and README §模型配置:
runtime args > command args > model args > config file > defaults)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class InferenceConfig:
    model: str = "tiny"
    dataset: str = "simple"
    batch_size: int = 8
    max_new_tokens: int = 32
    attn_impl: str = "int8"
    resume: bool = True
    output_dir: str = "eval_out"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def resolve(
        cls,
        config_file: Optional[str] = None,
        model_args: Optional[Dict[str, Any]] = None,
        command_args: Optional[Dict[str, Any]] = None,
        runtime_args: Optional[Dict[str, Any]] = None,
    ) -> "InferenceConfig":
        """Merge the four layers, later layers winning:
        defaults < config file < model args < command args < runtime args."""
        merged: Dict[str, Any] = {}
        if config_file:
            with open(config_file) as f:
                merged.update(json.load(f))
        for layer in (model_args, command_args, runtime_args):
            if layer:
                merged.update({k: v for k, v in layer.items() if v is not None})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in merged.items() if k in known}
        extra = {k: v for k, v in merged.items() if k not in known}
        cfg = cls(**kwargs)
        cfg.extra.update(extra)
        return cfg
