"""JAX PeraNet variables → the port's reference-layout state dict.

The inverse of ssad_tpu/utils/ref_checkpoint.py::convert_peranet_state_dict
and utils/torch_weights.py::convert_resnet_state_dict, so a model trained
by the JAX package can be served by the port.  It takes the variable
trees as nested dicts of NUMPY arrays (``np.asarray`` each JAX leaf
first) and imports nothing of JAX:

  conv   kernel (kh, kw, I, O)  → weight (O, I, kh, kw)
  dense  kernel (I, O)          → weight (O, I)
  bn     scale/bias, mean/var   → weight/bias, running_mean/running_var
  backbone/layer{s}_{b}         → feature_extractor.layer{s}.{b}
  downsample_conv/_bn           → downsample.{0,1}
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))  # HWIO → OIHW


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, p: Mapping, s: Mapping):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def dense(prefix: str, p: Mapping):
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)  # (I, O) → (O, I)
        if "bias" in p:
            sd[f"{prefix}.bias"] = _t(p["bias"])

    bb, bbs = params["backbone"], batch_stats["backbone"]
    pre = "feature_extractor"
    sd[f"{pre}.conv1.weight"] = _conv(bb["conv1"]["kernel"])
    bn(f"{pre}.bn1", bb["bn1"], bbs["bn1"])
    for name in sorted(k for k in bb if re.fullmatch(r"layer\d+_\d+", k)):
        stage, block = name[len("layer"):].split("_")
        p, s = bb[name], bbs[name]
        tp = f"{pre}.layer{stage}.{block}"
        for conv in sorted(k for k in p if re.fullmatch(r"conv\d+", k)):
            c = conv[len("conv"):]
            sd[f"{tp}.conv{c}.weight"] = _conv(p[conv]["kernel"])
            bn(f"{tp}.bn{c}", p[f"bn{c}"], s[f"bn{c}"])
        if "downsample_conv" in p:
            sd[f"{tp}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            bn(f"{tp}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    dense("concatenator.0", params["concatenator_dense"])
    bn("concatenator.1", params["concatenator_bn"], batch_stats["concatenator_bn"])
    n = 0
    while f"latent_{n}_dense" in params:
        dense(f"latent_space.{n}.0", params[f"latent_{n}_dense"])
        bn(f"latent_space.{n}.1", params[f"latent_{n}_bn"], batch_stats[f"latent_{n}_bn"])
        n += 1
    dense(f"latent_space.{n}", params["latent_out_dense"])
    bn(f"latent_space.{n + 1}", params["latent_out_bn"], batch_stats["latent_out_bn"])
    dense("classifier", params["classifier"])
    return sd
