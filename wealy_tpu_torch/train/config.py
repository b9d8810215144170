"""Config dataclasses covering the reference's implied OmegaConf schema: a
copy of ``wealy_tpu.train.config`` (stdlib only; PyYAML is imported only
when a YAML file is read).

Every key reconstructed from the reference's access sites (SURVEY.md §5.6) has
a field here. The reference threads an OmegaConf DictConfig through every
Phase-B class (lib/embedding_dataset/metadata_loaders.py:8, OmegaConf.select
at :29, :272); this module accepts the same configs natively:

- ``Config.from_yaml`` loads a reference-style YAML file, resolving
  OmegaConf ``${dotted.path}`` interpolations;
- ``Config.from_file`` dispatches on extension (.yaml/.yml/.json);
- :func:`select` mirrors ``OmegaConf.select(conf, "path.meta")`` — dotted
  access with a default — over both Config objects and nested dicts.

No omegaconf dependency: the subset the reference exercises (nested keys,
select, string interpolation) is implemented over pyyaml.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Optional

_INTERP = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise KeyError(dotted)
    return cur


def resolve_interpolations(d: dict) -> dict:
    """Resolve OmegaConf-style ``${a.b.c}`` string interpolations in a nested
    dict (the one OmegaConf feature YAML configs commonly rely on). A string
    that is exactly one interpolation keeps the referenced value's type;
    embedded interpolations substitute as text. Cycles raise ValueError."""

    def resolve(value, stack: tuple):
        if isinstance(value, dict):
            return {k: resolve(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, stack) for v in value]
        if isinstance(value, str):
            m = _INTERP.fullmatch(value)
            if m:
                return resolve_path(m.group(1), stack)
            return _INTERP.sub(
                lambda mm: str(resolve_path(mm.group(1), stack)), value
            )
        return value

    def resolve_path(dotted: str, stack: tuple):
        if dotted in stack:
            raise ValueError(f"interpolation cycle through ${{{dotted}}}")
        return resolve(_lookup(d, dotted), stack + (dotted,))

    return resolve(d, ())


def select(conf, dotted: str, default=None):
    """``OmegaConf.select``-compatible dotted access over Config dataclasses
    or nested dicts (reference usage: metadata_loaders.py:29, :272)."""
    cur = conf
    for part in dotted.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return default
            cur = cur[part]
        elif dataclasses.is_dataclass(cur) and not isinstance(cur, type):
            if not hasattr(cur, part):
                return default
            cur = getattr(cur, part)
        else:
            return default
    return default if cur is None else cur


@dataclasses.dataclass
class PathConfig:
    data: Optional[str] = None  # audio root (filters.py:20-24)
    hidden_states: Optional[str] = None  # embedding root (path_manager.py:17)
    meta: Optional[str] = None  # metadata cache file (metadata_loaders.py:29)
    cache: Optional[str] = None  # processed-dataset cache dir (cache_manager.py:20)
    working_dir: Optional[str] = None
    shs_data: Optional[str] = None  # shs_data.csv
    shs_splits: Optional[str] = None  # SHS100K-{TRAIN,VAL,TEST} dir
    lyric_covers_data: Optional[str] = None
    discogs_vi_data: Optional[str] = None
    checkpoints: Optional[str] = None  # train checkpoints (torch.save payloads in the port)


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "shs"  # {shs, lyric-covers, discogs-vi}
    embedding_type: str = "last_hidden_states"  # base_dataset.py:99-126 values
    embedding_format: str = "concat"  # {concat, all}
    chunk_size: int = 1000  # collate_functions.py:713
    use_random_chunks: bool = True
    use_avg_pooling: bool = False
    use_avg_clews: bool = False
    apply_masks_with_padding: bool = False
    overlap_percentage: float = 0.9  # test-time chunk overlap
    n_per_class: int = 2
    p_samesong: float = 0.0
    augment: bool = False
    fullsongs: bool = False  # base_dataset.py:20-22: no chunking, full sequences
    whisper_set: str = "turbo_nothing_whisper_42"  # dataset.py:17-19 default


@dataclasses.dataclass
class ModelConfig:
    name: str = "whisper"  # the 7 names (collate_functions.py:428-430)
    zdim: int = 512
    whisper_size: str = "tiny"  # extraction model (tiny..large-v3-turbo)
    scan_layers: bool = True  # nn.scan encoder stack (compile-scalable)
    cqt_method: str = "pseudo"  # CLEWS frontend: {pseudo, multirate (exact CQT)}


@dataclasses.dataclass
class TrainConfig:
    loss: str = "clews"  # {clews, ntxent, triplet}
    # loss constructor kwargs, forwarded to get_loss(loss, **loss_params) —
    # the reference's constructor surface (lib/losses.py:185-200: CLEWS
    # gamma/b/uniformity_weight/warmup_steps; ntxent temperature; triplet
    # margin). Empty dict = the reference defaults.
    loss_params: dict = dataclasses.field(default_factory=dict)
    batch_size: int = 32
    # >1: GradCache-style two-pass step — the full batch_size keeps its
    # exact in-batch negative set while activations live one
    # batch_size/grad_accum chunk at a time (train/step.py)
    grad_accum: int = 1
    lr: float = 1e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 1000
    max_steps: int = 100_000
    seed: int = 0
    log_every: int = 50
    eval_every: int = 1000
    val_group: int = 0  # val-hook streaming group size; 0 = max(4, batch_size)
    checkpoint_every: int = 1000
    debug_nans: bool = False  # the port's train: torch.autograd anomaly detection
    metrics_jsonl: str = ""  # when set, MetricsWriter appends one JSON
    # record per step to this path (SURVEY.md §5.5 metrics persistence)


@dataclasses.dataclass
class Config:
    path: PathConfig = dataclasses.field(default_factory=PathConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            return klass(**{k: v for k, v in (sub or {}).items() if k in fields})

        return cls(
            path=build(PathConfig, d.get("path")),
            data=build(DataConfig, d.get("data")),
            model=build(ModelConfig, d.get("model")),
            train=build(TrainConfig, d.get("train")),
        )

    @classmethod
    def from_json(cls, path: str | Path) -> "Config":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        """Load a reference-style OmegaConf YAML config (SURVEY.md §5.6),
        resolving ``${...}`` interpolations."""
        import yaml

        raw = yaml.safe_load(Path(path).read_text()) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: top level must be a mapping")
        return cls.from_dict(resolve_interpolations(raw))

    @classmethod
    def from_file(cls, path: str | Path) -> "Config":
        """Dispatch on extension: .yaml/.yml -> YAML, anything else JSON."""
        suffix = Path(path).suffix.lower()
        if suffix in (".yaml", ".yml"):
            return cls.from_yaml(path)
        return cls.from_json(path)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
