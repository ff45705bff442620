"""JAX training state → the port's: PeraNet variables as a reference-layout
state dict, an optax ``trace`` state as the port's optimizer state, and a
memory bank.

``state_dict_from_jax`` is the inverse of
ssad_tpu/utils/ref_checkpoint.py::convert_peranet_state_dict and
utils/torch_weights.py::convert_resnet_state_dict, so a model trained by
the JAX package can be served by the port, and a JAX run can be continued
mid-stage in the port (``load_optax_momentum``, ``bank_from_numpy``).
Everything takes nested dicts of NUMPY arrays (``np.asarray`` each JAX
leaf first); nothing of JAX is imported:

  conv   kernel (kh, kw, I, O)  → weight (O, I, kh, kw)
  dense  kernel (I, O)          → weight (O, I)
  bn     scale/bias, mean/var   → weight/bias, running_mean/running_var
  backbone/layer{s}_{b}         → feature_extractor.layer{s}.{b}
  downsample_conv/_bn           → downsample.{0,1}
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ssad_tpu_torch.train.memory_bank import MemoryBank


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))  # HWIO → OIHW


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping]) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` → a reference-layout state dict.
    With ``batch_stats=None`` only the parameters' entries are made (any
    tree shaped like ``params``, e.g. an optimizer's momentum, converts)."""
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, p: Mapping, s: Optional[Mapping]):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        if s is not None:
            sd[f"{prefix}.running_mean"] = _t(s["mean"])
            sd[f"{prefix}.running_var"] = _t(s["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def stats(tree: Optional[Mapping], key: str):
        return None if tree is None else tree[key]

    def dense(prefix: str, p: Mapping):
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)  # (I, O) → (O, I)
        if "bias" in p:
            sd[f"{prefix}.bias"] = _t(p["bias"])

    pre = "feature_extractor"
    if "backbone" in params:  # absent from a frozen backbone's momentum
        bb, bbs = params["backbone"], stats(batch_stats, "backbone")
        sd[f"{pre}.conv1.weight"] = _conv(bb["conv1"]["kernel"])
        bn(f"{pre}.bn1", bb["bn1"], stats(bbs, "bn1"))
        for name in sorted(k for k in bb if re.fullmatch(r"layer\d+_\d+", k)):
            stage, block = name[len("layer"):].split("_")
            p, s = bb[name], stats(bbs, name)
            tp = f"{pre}.layer{stage}.{block}"
            for conv in sorted(k for k in p if re.fullmatch(r"conv\d+", k)):
                c = conv[len("conv"):]
                sd[f"{tp}.conv{c}.weight"] = _conv(p[conv]["kernel"])
                bn(f"{tp}.bn{c}", p[f"bn{c}"], stats(s, f"bn{c}"))
            if "downsample_conv" in p:
                sd[f"{tp}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                bn(f"{tp}.downsample.1", p["downsample_bn"], stats(s, "downsample_bn"))

    dense("concatenator.0", params["concatenator_dense"])
    bn("concatenator.1", params["concatenator_bn"], stats(batch_stats, "concatenator_bn"))
    n = 0
    while f"latent_{n}_dense" in params:
        dense(f"latent_space.{n}.0", params[f"latent_{n}_dense"])
        bn(f"latent_space.{n}.1", params[f"latent_{n}_bn"], stats(batch_stats, f"latent_{n}_bn"))
        n += 1
    dense(f"latent_space.{n}", params["latent_out_dense"])
    bn(f"latent_space.{n + 1}", params["latent_out_bn"], stats(batch_stats, "latent_out_bn"))
    dense("classifier", params["classifier"])
    return sd


def load_optax_momentum(optimizer, model: torch.nn.Module, trace: Mapping,
                        count: Optional[int] = None) -> None:
    """Carry the JAX optimizer's state into a ``train.optim.StageOptimizer``
    of the same stage: ``trace`` is the optax ``trace`` momentum tree,
    shaped like the trained parameters (a frozen backbone's subtree
    dropped), and ``count`` the schedule's step count where the chain has
    one.  Every trained parameter must get a buffer."""
    momentum = state_dict_from_jax(trace, None)
    names = {id(p): n for n, p in model.named_parameters()}
    for p in optimizer.params:
        name = names[id(p)]
        if name not in momentum:
            raise KeyError(f"no momentum for the trained parameter {name}")
        optimizer.sgd.state[p]["momentum_buffer"] = momentum[name].to(p.device, p.dtype)
    if count is not None:
        optimizer.count = int(count)


def bank_from_numpy(data, cursor, count, device=None) -> MemoryBank:
    """A JAX ``MemoryBank``'s (data, cursor, count), as numpy → the port's."""
    return MemoryBank(
        data=torch.from_numpy(np.array(data, np.float32, copy=True)).to(device),
        cursor=torch.tensor(int(cursor), dtype=torch.int32, device=device),
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
    )
