"""Layered configuration: the port's copy of ``dvdx_tpu/utils/config.py``.

The same composed dataclass tree, sections, fields and defaults (so a JSON
file written by either package loads in the other), over the port's own
``economics.params.EconParams``:

  DVDXConfig.default()                  — programmatic defaults
  DVDXConfig.from_args(argv)            — argparse overlay (--section.field)
  DVDXConfig.from_dict / to_dict        — JSON round-trip
  env overlay                           — DVDX_<SECTION>_<FIELD>=value

Sections: neuron (common), diffusion (miner generation), validator (MD-VQS
weights, spot-check), economics. ``neuron.device`` keeps the reference's
default; nothing reads it (the port's entry points take ``--device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional

from ..economics.params import EconParams


@dataclasses.dataclass
class NeuronConfig:
    """Common neuron flags."""

    netuid: int = 0
    name: str = "dvdx-neuron"
    device: str = "tpu"
    epoch_length: int = 100
    mock: bool = False
    results_dir: str = "generated_videos"


@dataclasses.dataclass
class DiffusionConfig:
    """Miner generation flags."""

    model: str = "zeroscope-v2-576w"
    num_steps: int = 25
    guidance_scale: float = 7.5
    eta: float = 0.0
    width: int = 576
    height: int = 320
    num_frames: int = 16
    fps: int = 8


@dataclasses.dataclass
class ValidatorSection:
    """Validator flags."""

    sample_size: int = 3
    num_checkpoints: int = 3
    challenge_bytes: int = 32
    timeout_s: float = 300.0
    ema_alpha: float = 0.1
    kappa_limit: float = 0.1
    # MD-VQS weights (scoring.py 0.4/0.3/0.3)
    mdvqs_alpha: float = 0.4
    mdvqs_beta: float = 0.3
    mdvqs_gamma: float = 0.3
    atol: float = 5e-2


@dataclasses.dataclass
class DVDXConfig:
    neuron: NeuronConfig = dataclasses.field(default_factory=NeuronConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    validator: ValidatorSection = dataclasses.field(default_factory=ValidatorSection)
    economics: EconParams = dataclasses.field(default_factory=EconParams)

    # -- construction --

    @classmethod
    def default(cls) -> "DVDXConfig":
        return cls()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DVDXConfig":
        cfg = cls()
        for section_name, section_vals in d.items():
            section = getattr(cfg, section_name, None)
            if section is None or not isinstance(section_vals, dict):
                continue
            updated = dataclasses.replace(
                section, **{k: v for k, v in section_vals.items()
                            if k in {f.name for f in dataclasses.fields(section)}})
            setattr(cfg, section_name, updated)
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "DVDXConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    # -- argparse + env overlays --

    def add_args(self, parser: argparse.ArgumentParser):
        for section_name in ("neuron", "diffusion", "validator", "economics"):
            section = getattr(self, section_name)
            for f in dataclasses.fields(section):
                val = getattr(section, f.name)
                flag = f"--{section_name}.{f.name}"
                if isinstance(val, bool):
                    parser.add_argument(flag, type=lambda s: s.lower() in
                                        ("1", "true", "yes"), default=None)
                else:
                    parser.add_argument(flag, type=type(val), default=None)

    @classmethod
    def from_args(cls, argv=None,
                  parser: Optional[argparse.ArgumentParser] = None) -> "DVDXConfig":
        cfg = cls.default()._apply_env()
        parser = parser or argparse.ArgumentParser()
        cfg.add_args(parser)
        ns, _ = parser.parse_known_args(argv)
        for key, val in vars(ns).items():
            if val is None or "." not in key:
                continue
            section_name, field = key.split(".", 1)
            section = getattr(cfg, section_name)
            setattr(cfg, section_name, dataclasses.replace(section, **{field: val}))
        return cfg

    def _apply_env(self) -> "DVDXConfig":
        for section_name in ("neuron", "diffusion", "validator", "economics"):
            section = getattr(self, section_name)
            for f in dataclasses.fields(section):
                env_key = f"DVDX_{section_name.upper()}_{f.name.upper()}"
                if env_key in os.environ:
                    raw = os.environ[env_key]
                    typ = type(getattr(section, f.name))
                    val = raw.lower() in ("1", "true") if typ is bool else typ(raw)
                    section = dataclasses.replace(section, **{f.name: val})
            setattr(self, section_name, section)
        return self
