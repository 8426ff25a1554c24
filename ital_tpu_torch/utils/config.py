"""Experiment configuration: typed dataclasses + .ini files + CLI overrides.

Port of ``ital_tpu.utils.config``: the same ``configs/*.ini`` files and
``SECTION.key=value`` overrides load into the same dataclasses.  Strategy
options in ``[METHOD]`` are checked against the port's strategy registry.
"""

from __future__ import annotations

import configparser
import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class GPConfig:
    length_scale: float = 1.0
    var: float = 1.0
    noise: float = 0.1
    cap: int = 64  # labeled-slot capacity; 0 = auto (1 + n_rounds * batch_size)
    # The remaining keys mirror the reference's [GP] section so its configs
    # load unchanged: the session reads matmul_precision and corpus_dtype,
    # the runner chol2d_threshold (the mesh's large-cap path), the learn_*
    # keys (the re-learn every learn_every rounds) and refit_every.
    chol2d_threshold: int = 1024
    learn_every: int = 0
    learn_steps: int = 50
    learn_lr: float = 0.05
    learn_noise: bool = True
    learn_prior_strength: float = 0.0
    learn_noise_floor: float = 0.0
    refit_every: int = 0
    # "" or "highest": full f32 matmuls.  "default" or "high": TF32 allowed
    # (see apply_matmul_precision).
    matmul_precision: str = ""
    # Corpus storage dtype ("" = keep the dataset's float32, or "bfloat16").
    corpus_dtype: str = ""


@dataclasses.dataclass
class UserConfig:
    label_prob: float = 1.0
    mistake_prob: float = 0.0
    obs_noise: float = 0.0


@dataclasses.dataclass
class ExperimentConfig:
    task: str = "retrieval"  # "retrieval" | "regression"
    dataset: str = "toy"
    dataset_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    method: str = "ital"
    method_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 4
    n_rounds: int = 10
    repetitions: int = 1
    queries_per_class: int = 1
    max_classes: int = 0  # 0 = all classes
    seed: int = 0
    gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    user: UserConfig = dataclasses.field(default_factory=UserConfig)
    log_jsonl: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    deterministic: bool = True
    profile_dir: Optional[str] = None
    mesh_devices: int = 0
    query_batch: int = 0
    fused_sessions: bool = False

    @property
    def cap(self) -> int:
        if self.gp.cap:
            return self.gp.cap
        raw = 1 + self.n_rounds * self.batch_size
        return -(-raw // 8) * 8


def _coerce(value: str) -> Any:
    """str -> bool/int/float/str by trial (ini values are untyped)."""
    low = value.strip().lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", ""):
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def _apply_section(obj: Any, section: configparser.SectionProxy):
    for key, raw in section.items():
        if not hasattr(obj, key):
            valid = ", ".join(sorted(f.name for f in dataclasses.fields(obj)))
            raise ValueError(
                f"unknown key {key!r} in [{section.name}] — valid keys: {valid}. "
                f"Strategy kwargs (n_qmc, pool_size, ...) belong in [METHOD], "
                f"dataset loader kwargs in [DATA]."
            )
        setattr(obj, key, _coerce(raw))


def load_config(path: Optional[str] = None, overrides: tuple[str, ...] = ()) -> ExperimentConfig:
    """Read an .ini experiment config and apply ``SECTION.key=value`` overrides.

    Sections: ``[EXPERIMENT]``, ``[GP]``, ``[USER]``, ``[DATA]`` (dataset
    loader kwargs), ``[METHOD]`` (strategy kwargs).
    """
    cfg = ExperimentConfig()
    parser = configparser.ConfigParser()
    parser.optionxform = str  # keep key case
    if path is not None:
        with open(path) as fh:
            parser.read_file(fh)
    for ov in overrides:
        if "=" not in ov or "." not in ov.split("=", 1)[0]:
            raise ValueError(f"override must look like SECTION.key=value, got {ov!r}")
        lhs, value = ov.split("=", 1)
        section, key = lhs.split(".", 1)
        if not parser.has_section(section):
            parser.add_section(section)
        parser.set(section, key, value)

    if parser.has_section("EXPERIMENT"):
        _apply_section(cfg, parser["EXPERIMENT"])
    if parser.has_section("GP"):
        _apply_section(cfg.gp, parser["GP"])
    if parser.has_section("USER"):
        _apply_section(cfg.user, parser["USER"])
    if parser.has_section("DATA"):
        for key, raw in parser["DATA"].items():
            cfg.dataset_kwargs[key] = _coerce(raw)
    if parser.has_section("METHOD"):
        for key, raw in parser["METHOD"].items():
            cfg.method_kwargs[key] = _coerce(raw)
    if cfg.gp.learn_prior_strength < 0 or cfg.gp.learn_noise_floor < 0:
        raise ValueError(
            "GP.learn_prior_strength and GP.learn_noise_floor must be >= 0, "
            f"got {cfg.gp.learn_prior_strength!r} / {cfg.gp.learn_noise_floor!r}"
        )
    if cfg.gp.matmul_precision not in (None, "", "default", "high", "highest"):
        raise ValueError(
            f"GP.matmul_precision must be one of default/high/highest (or "
            f"empty), got {cfg.gp.matmul_precision!r}"
        )
    if cfg.gp.corpus_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(
            f"GP.corpus_dtype must be empty, float32 or bfloat16, got "
            f"{cfg.gp.corpus_dtype!r}"
        )
    if cfg.gp.corpus_dtype == "bfloat16" and cfg.gp.matmul_precision == "highest":
        warnings.warn(
            "GP.corpus_dtype=bfloat16 with GP.matmul_precision=highest: the "
            "corpus is quantized at storage, so the highest-precision matmul "
            "cannot recover f32 inputs.",
            stacklevel=2,
        )
    _warn_coarse_mi_lattice(cfg)
    return cfg


def _warn_coarse_mi_lattice(cfg: ExperimentConfig) -> None:
    """Warn when a large MI batch meets a coarse QMC lattice.

    The reference measured that at m >= 7 the greedy decision stage needs
    n_qmc >= 256 (the refine stage when ``refine_top`` > 0, else the base
    scan).
    """
    if cfg.task != "retrieval" or cfg.batch_size < 7:
        return
    import ital_tpu_torch.select  # noqa: F401  (registers the strategies)
    from ital_tpu_torch.select.base import declared_method_kwargs

    try:
        declared = declared_method_kwargs(cfg.method)
    except KeyError:
        return  # an unknown strategy fails loudly where the session is built
    if "n_qmc" not in declared:
        return
    base = int(cfg.method_kwargs.get("n_qmc", 128) or 0)
    refine_top = int(cfg.method_kwargs.get("refine_top", 0) or 0)
    refine_n_qmc = int(cfg.method_kwargs.get("refine_n_qmc", 512) or 0)
    decision_n_qmc = refine_n_qmc if refine_top > 0 else base
    if decision_n_qmc < 256:
        warnings.warn(
            f"batch_size={cfg.batch_size} with a coarse QMC lattice: the "
            f"greedy decision stage runs at n_qmc={decision_n_qmc}; at m >= 7 "
            f"use n_qmc >= 256 there (raise [METHOD] n_qmc, or set "
            f"refine_top > 0 with refine_n_qmc >= 256).",
            stacklevel=2,
        )


def apply_matmul_precision(cfg: ExperimentConfig) -> None:
    """Set PyTorch's TF32 switches from ``GP.matmul_precision``.

    Both ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` are False (full f32) unless the
    config asks for ``default`` or ``high``, which allow TF32.
    """
    allow = cfg.gp.matmul_precision in ("default", "high")
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
