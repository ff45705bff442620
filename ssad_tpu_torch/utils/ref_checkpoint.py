"""Reference Lightning checkpoints (``best_model.ckpt``), read and written.

Counterpart of ssad_tpu/utils/ref_checkpoint.py:99-204.  The JAX package
converts a reference checkpoint into its own Flax trees; the port's
PeraNet has the reference's state-dict layout, so the file's
``state_dict`` loads as it is (``strict=True``).  The port also writes its
checkpoints in this layout, which makes the reference format its own.

A checkpoint is a torch pickle with:
  state_dict        feature_extractor.*, concatenator.*, latent_space.*,
                    classifier.*                   (models.py:58-99)
  memory_bank       (R, 512) tensor, rows oldest → newest (models.py:199)
  hyper_parameters  PeraNet.__init__ kwargs (models.py:33); the port adds
                    ``compute_dtype`` when it writes one
  train_config      (the port's own checkpoints, train/checkpoint.py) the
                    TrainConfig JSON; when present its ModelConfig is the
                    checkpoint's
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ssad_tpu_torch.config import ModelConfig, TrainConfig
from ssad_tpu_torch.train.memory_bank import MemoryBank


def bank_from_rows(rows, capacity: int = 1000) -> MemoryBank:
    """Reference memory-bank rows (oldest → newest) → a ring MemoryBank
    whose ``newest_first`` view is the rows reversed."""
    rows = torch.as_tensor(np.asarray(rows, np.float32))
    r = rows.shape[0]
    cap = max(capacity, r)
    data = torch.zeros((cap, rows.shape[1] if rows.ndim == 2 else 512), dtype=torch.float32)
    if r:
        data[:r] = rows
    return MemoryBank(
        data=data,
        cursor=torch.tensor(r % cap, dtype=torch.int32),
        count=torch.tensor(r, dtype=torch.int32),
    )


def model_config_from_hparams(hparams: Optional[Dict[str, Any]]) -> ModelConfig:
    """hyper_parameters (models.py:21-33) → ModelConfig."""
    hp = dict(hparams or {})
    base_dim = int(hp.get("latent_space_layers_base_dim", 512))
    if base_dim != 512:
        raise ValueError(
            f"latent_space_layers_base_dim={base_dim}: the reference always "
            "projects the latent MLP to a fixed 512-d embedding "
            "(models.py:137) while ModelConfig uses one latent_dim for both "
            "hidden and embedding width"
        )
    # the reference concatenates taps in fixed ascending order
    # (models.py:240-245), whatever the order of the list in hparams
    taps = tuple(sorted(set(hp.get("layer_outputs", ("layer2", "layer3")))))
    return ModelConfig(
        backbone="resnet18",  # hardcoded in the reference (models.py:35)
        layer_outputs=taps,
        latent_space_layers=int(hp.get("latent_space_layers", 5)),
        latent_dim=base_dim,
        num_classes=int(hp.get("num_classes", 4)),
        memory_bank_size=int(hp.get("memory_bank_dim", 1000)),
        compute_dtype=str(hp.get("compute_dtype", ModelConfig.compute_dtype)),
    )


def load_checkpoint(
    path: str | Path, allow_pickle: bool = False
) -> Tuple[Dict[str, torch.Tensor], Optional[MemoryBank], ModelConfig, Optional[TrainConfig]]:
    """A ``best_model.ckpt`` → (state_dict, bank or None, ModelConfig,
    TrainConfig or None: only the port's own checkpoints carry one).

    Tries the safe loader first; ``allow_pickle=True`` permits full
    unpickling of a file you trust (Lightning checkpoints sometimes carry
    non-tensor objects, e.g. an hparams AttributeDict)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except OSError:
        raise  # missing/unreadable file — not an unpickling problem
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"safe load of {path} failed ({type(e).__name__}: {e}); if "
                "this is a Lightning checkpoint carrying non-tensor objects, "
                "re-run with allow_pickle=True / --allow-pickle if you trust "
                "the file"
            ) from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" not in ckpt:
        raise ValueError(f"{path} has no 'state_dict' — not a Lightning checkpoint")
    train_cfg = None
    if ckpt.get("train_config"):
        train_cfg = TrainConfig.from_json(ckpt["train_config"])
        cfg = train_cfg.model
    else:
        cfg = model_config_from_hparams(ckpt.get("hyper_parameters"))
    bank = None
    mb = ckpt.get("memory_bank")
    if mb is not None:
        mb = torch.as_tensor(mb)
        if mb.ndim == 2 and mb.shape[0] > 0:
            bank = bank_from_rows(mb.numpy(), capacity=cfg.memory_bank_size)
    return dict(ckpt["state_dict"]), bank, cfg, train_cfg


def save_reference_checkpoint(
    path: str | Path,
    state_dict: Dict[str, torch.Tensor],
    bank_rows=None,
    cfg: Optional[ModelConfig] = None,
    train_config: Optional[TrainConfig] = None,
) -> str:
    """Write a checkpoint in the reference layout.  ``bank_rows`` are
    oldest → newest, as the reference stores them.  With ``train_config``
    its JSON is stored too, and its ModelConfig is the one written."""
    if train_config is not None:
        cfg = train_config.model
    cfg = cfg or ModelConfig()
    hparams = {
        "layer_outputs": list(cfg.layer_outputs),
        "latent_space_layers": cfg.latent_space_layers,
        "latent_space_layers_base_dim": cfg.latent_dim,
        "num_classes": cfg.num_classes,
        "memory_bank_dim": cfg.memory_bank_size,
        "compute_dtype": cfg.compute_dtype,
    }
    bank = torch.zeros((0, cfg.latent_dim)) if bank_rows is None else torch.as_tensor(
        np.asarray(bank_rows, np.float32)
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    ckpt = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "memory_bank": bank,
        "hyper_parameters": hparams,
    }
    if train_config is not None:
        ckpt["train_config"] = train_config.to_json()
    torch.save(ckpt, path)
    return str(path)
