"""Where do the JAX package's and the port's trainings of one subject part?

    python tests/_torch_fit_hunt.py [--subject bottle] [--dtype float32|bfloat16]

Both packages train one subject of the parity generator's 15-category
tree (seed 0, here at 64²) with the same schedule from the same start,
the port handed the JAX run's draws: every key the JAX ``Trainer.fit``
gives its train and eval steps is recorded, in order, and the port's
``upload_draws`` turns the next one into the same batch indices and
``SynthDraws`` (``_torch_synth.jax_draws``); the port's model starts from
the JAX init (``jax_bridge.state_dict_from_jax``).  Stage by stage:

* ``data``: ``prepare_pretext_data`` of both (images, split, masks; the
  IoU of the fixed-pose masks);
* ``batches``: the pretext batch of the first step of each stage, both
  engines from the same key (of the denormalised pixel values: the share
  within 2⁻⁷, the share not equal, the mean |Δ| and mean Δ, the largest);
* ``step0_loss``: the first step's loss of the JAX init on JAX's batch in
  JAX, and in the port on JAX's batch and on its own; ``by_dtype``: that
  loss in f32 and in bf16 in each package (how far bf16 moves each from
  its f32 loss, beside how far the packages are apart);
* ``steps``: every step's train loss and every eval step's loss, JAX
  against the port, and the first step whose loss parts by more than
  1e-3;
* ``params``: the largest |Δ| of each stage's final weights;
* ``bank``: the harvested memory bank (rows, largest |Δ| newest first);
* ``scores``: both final models, each with its bank, through the port's
  ``evaluate_category`` at image level on the subject's test split with
  one fit permutation (so only the training differs): image AUROC, F1
  and the largest |Δ| of the test images' scores.

``--same-batches`` hands the port JAX's batches themselves, so that only
the steps' arithmetic differs.  ``--declared`` compiles the JAX steps and
batch maker at declared precision (``_torch_train.declared_jit``: every
bf16 intermediate the source declares rounded, as the port rounds it),
for a bf16 hunt (``--dtype bfloat16 --imsize 256 --batch 32``).
``--tpu-one-pass`` adds the TPU's own roundings to the JAX side
(``_torch_train.tpu_one_pass``: every f32 dot and convolution at DEFAULT
precision, as the head's dense layers, the bank insert and the
synthesizer's line dots are, takes bf16 operands); the JAX numbers of a
run with it against one without say how far those roundings alone move
JAX's training.  Prints one JSON line.  It imports both packages, so it lives with the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_synth import jax_draws  # noqa: E402
from _torch_train import declared_jit, tpu_one_pass  # noqa: E402

from ssad_tpu.config import DataConfig as JDataConfig  # noqa: E402
from ssad_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from ssad_tpu.config import OptimConfig as JOptimConfig  # noqa: E402
from ssad_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from ssad_tpu.data import mvtec as jmvtec  # noqa: E402
from ssad_tpu.train import trainer as jtrainer  # noqa: E402
from ssad_tpu.train.memory_bank import newest_first as jnewest  # noqa: E402
from ssad_tpu_torch import constants  # noqa: E402
from ssad_tpu_torch.config import (  # noqa: E402
    DataConfig, EvalConfig, ModelConfig, OptimConfig, TrainConfig,
)
from ssad_tpu_torch.data import mvtec  # noqa: E402
from ssad_tpu_torch.evaluation import evaluator  # noqa: E402
from ssad_tpu_torch.evaluation.inference import InferenceEngine  # noqa: E402
from ssad_tpu_torch.models.peranet import build_model  # noqa: E402
from ssad_tpu_torch.parity import generate_parity_dataset  # noqa: E402
from ssad_tpu_torch.train import trainer as ptrainer  # noqa: E402
from ssad_tpu_torch.train.memory_bank import newest_first  # noqa: E402
from ssad_tpu_torch.utils.jax_bridge import bank_from_numpy, state_dict_from_jax  # noqa: E402

MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)
PART = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_delta(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a
               if not k.endswith("num_batches_tracked"))


def _losses_by_dtype(init, init_sd, jx, jy, jit) -> dict:
    """The train-mode loss of the JAX init on one batch in each package and
    dtype (JAX's jitted with ``jit``): how far bf16 moves each package from
    its f32 loss beside how far the packages are apart in each dtype."""
    import optax

    from ssad_tpu.models.peranet import build_model as jbuild_model

    x, y = jnp.asarray(np.array(jx)), jnp.asarray(np.array(jy))
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jbuild_model(JModelConfig(compute_dtype=dt))
        logits = jit(jax.jit(lambda p, st, x: jm.apply(
            {"params": p, "batch_stats": st}, x, train=True,
            mutable=["batch_stats"])[0]["classifier"]))(init.params, init.batch_stats, x)
        model = build_model(ModelConfig(compute_dtype=dt))
        model.load_state_dict(init_sd, strict=True)
        model.train()
        with torch.no_grad():
            port = torch.nn.functional.cross_entropy(
                model(torch.from_numpy(np.array(jx)))["classifier"],
                torch.from_numpy(np.array(jy)).long())
        out[dt] = {"jax": float(optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()), "port": float(port)}
    return out


def run(subject: str, dtype: str, imsize: int, batch: int, min_len: int, epochs,
        same_batches: bool = False, declared: bool = False, one_pass: bool = False) -> dict:
    torch.manual_seed(0)
    tmp = Path(tempfile.mkdtemp(prefix="fit_hunt_"))
    tree = generate_parity_dataset(tmp / "tree", list(constants.ALL_CATEGORIES), imsize=imsize,
                                   seed=0)
    out = {"subject": subject, "dtype": dtype, "imsize": imsize, "batch": batch,
           "epochs": list(epochs), "same_batches": same_batches, "declared": declared,
           "tpu_one_pass": one_pass}
    jit = declared_jit if declared else (lambda f: f)
    if one_pass:
        compile_ = jit

        def jit(f):
            return compile_(tpu_one_pass(f))

    # ---- data ------------------------------------------------------------------
    jdata = jmvtec.prepare_pretext_data(str(tree), subject, imsize=(imsize, imsize),
                                        val_fraction=0.2, seed=0)
    pdata = mvtec.prepare_pretext_data(tree, subject, imsize=(imsize, imsize), val_fraction=0.2,
                                       seed=0)
    fields = ("train_images", "val_images", "fixed_mask", "fixed_coords", "cut_pool")
    out["data_equal"] = {f: bool(np.array_equal(np.asarray(getattr(jdata, f)),
                                                np.asarray(getattr(pdata, f))))
                         for f in fields}
    jm, pm = np.asarray(jdata.fixed_mask) > 0, np.asarray(pdata.fixed_mask) > 0
    out["fixed_mask_iou"] = float((jm & pm).sum() / max((jm | pm).sum(), 1))

    jcfg = JTrainConfig(
        data=JDataConfig(dataset_dir=str(tree), subject=subject, imsize=(imsize, imsize),
                         batch_size=batch, min_dataset_length=min_len),
        model=JModelConfig(compute_dtype=dtype),
        optim=JOptimConfig(projection_epochs=epochs[0], fine_tune_epochs=epochs[1]))
    pcfg = TrainConfig(
        data=DataConfig(dataset_dir=str(tree), subject=subject, imsize=(imsize, imsize),
                        batch_size=batch, min_dataset_length=min_len),
        model=ModelConfig(compute_dtype=dtype),
        optim=OptimConfig(projection_epochs=epochs[0], fine_tune_epochs=epochs[1]))

    # ---- the JAX run, every step key recorded ----------------------------------
    jt = jtrainer.Trainer(jcfg, jdata)
    record = []  # (kind, key data, loss)
    get = jt._get_step_fns

    def recording_step_fns(stage):
        train_step, eval_step, tx, steps = get(stage)
        train_step, eval_step = jit(train_step), jit(eval_step)

        def tstep(state, key, *rest):
            new, m = train_step(state, key, *rest)
            record.append(("train", stage, np.asarray(jax.random.key_data(key)), float(m["loss"])))
            return new, m

        def estep(params, stats, key, *rest):
            m = eval_step(params, stats, key, *rest)
            record.append(("eval", stage, np.asarray(jax.random.key_data(key)), float(m["loss"])))
            return m

        return tstep, estep, tx, steps

    jt._get_step_fns = recording_step_fns
    init = jt.init_state(jax.random.fold_in(jax.random.key(0), 0), "projection")
    init_sd = state_dict_from_jax(_np(init.params), _np(init.batch_stats))
    stage_params = {}
    run_stage = jt.run_stage

    def keep_stage(state, stage, *a, **kw):
        state = run_stage(state, stage, *a, **kw)
        stage_params[stage] = state_dict_from_jax(_np(state.params), _np(state.batch_stats))
        return state

    jt.run_stage = keep_stage
    jres = jt.fit(seed=0, verbose=False)

    # ---- the port, handed those keys -------------------------------------------
    pt = ptrainer.Trainer(pcfg, pdata, torch.device("cpu"))
    keys = iter(record)
    p_losses = []

    def upload_draws(generator, dd):
        kind, stage, kd, _ = next(keys)
        key = jax.random.wrap_key_data(jnp.asarray(kd))
        k_idx, k_syn = jax.random.split(key)
        idx = np.asarray(jax.random.randint(k_idx, (batch,), 0, dd.images.shape[0]))
        draws = jax_draws(pt.spec, jax.random.split(k_syn, batch), dd.pool.shape[0])
        return torch.from_numpy(idx.astype(np.int64)), draws

    pt.upload_draws = upload_draws
    if same_batches:  # JAX's own batch for each key: only the steps' arithmetic differs
        tr_j, va_j = jt._device_data("train"), jt._device_data("val")
        make_j = jit(jax.jit(jt._make_batch))
        n_train = pdata.train_images.shape[0]

        def upload_key(generator, dd):
            return (next(keys), dd.images.shape[0] == n_train)

        def jax_batch(dd, rec, train):
            key = jax.random.wrap_key_data(jnp.asarray(rec[2]))
            x, y, orig = (torch.from_numpy(np.array(a)) for a in
                          make_j(key, *(tr_j if train else va_j)))
            return x, y.long(), orig

        pt.upload_draws, pt.make_batch = upload_key, jax_batch
    init_state = pt.init_state

    def from_jax_init(stage, seed=0, generator=None):
        state = init_state(stage, seed, generator)
        pt.model.load_state_dict(init_sd, strict=True)
        return state

    pt.init_state = from_jax_init
    train_step, eval_step = pt.train_step, pt.eval_step
    p_stage = {}

    def tstep(state, uploaded, dd, fill):
        state, m = train_step(state, uploaded, dd, fill)
        p_losses.append(float(m["loss"]))
        return state, m

    def estep(model, uploaded, dd):
        m = eval_step(model, uploaded, dd)
        p_losses.append(float(m["loss"]))
        return m

    pt.train_step, pt.eval_step = tstep, estep
    prun = pt.run_stage

    def keep_pstage(state, stage, *a, **kw):
        state = prun(state, stage, *a, **kw)
        p_stage[stage] = ptrainer._cpu_state_dict(state.model)
        return state

    pt.run_stage = keep_pstage
    pres = pt.fit(seed=0, verbose=False)
    if len(p_losses) != len(record):
        raise SystemExit(f"the port made {len(p_losses)} steps, JAX {len(record)}")

    # ---- batches: each stage's first step, both engines on one key; the loss of
    # the JAX init on each batch (step 0 of the projection stage) --------------
    tr = jt._device_data("train")
    make = jit(jax.jit(jt._make_batch))
    dd = pt.device_data("train")
    out["batches"] = {}
    for stage in ("projection", "fine_tune"):
        first = next(r for r in record if r[0] == "train" and r[1] == stage)
        jx, jy, _ = make(jax.random.wrap_key_data(jnp.asarray(first[2])), *tr)
        keys = iter([first])
        px, py, _ = ptrainer.Trainer.make_batch(pt, dd, *upload_draws(None, dd))
        signed = (px.numpy() * STD + MEAN) - (np.asarray(jx) * STD + MEAN)
        diff = np.abs(signed)
        out["batches"][stage] = {
            "labels_equal": bool(np.array_equal(py.numpy(), np.asarray(jy))),
            "min_share_within_2^-7": float((diff <= 2.0**-7).reshape(batch, -1).mean(1).min()),
            "share_not_equal": float((diff > 0).mean()), "mean_abs": float(diff.mean()),
            "mean_signed": float(signed.mean()),
            "max_abs": float(diff.max())}
        if stage == "projection":
            model = build_model(ModelConfig(compute_dtype=dtype))
            model.load_state_dict(init_sd, strict=True)
            model.train()
            y = torch.from_numpy(np.array(jy)).long()
            with torch.no_grad():
                on_jax_x = torch.nn.functional.cross_entropy(
                    model(torch.from_numpy(np.array(jx)))["classifier"], y)
                model.load_state_dict(init_sd, strict=True)
                on_port_x = torch.nn.functional.cross_entropy(model(px)["classifier"], y)
            out["step0_loss"] = {"jax": first[3], "port_on_jax_batch": float(on_jax_x),
                                 "port_on_port_batch": float(on_port_x),
                                 "by_dtype": _losses_by_dtype(init, init_sd, jx, jy, jit)}

    # ---- steps -------------------------------------------------------------------
    deltas = [abs(p - r[3]) for p, r in zip(p_losses, record)]
    parted = next((i for i, d in enumerate(deltas) if d > PART), None)
    out["steps"] = {
        "count": len(record),
        "first_parting": None if parted is None else {
            "index": parted, "kind": record[parted][0], "stage": record[parted][1],
            "jax_loss": record[parted][3], "port_loss": p_losses[parted]},
        "loss_delta_by_step": [round(d, 6) for d in deltas],
        "jax_train_losses": [round(r[3], 4) for r in record if r[0] == "train"],
        "port_train_losses": [round(p, 4) for p, r in zip(p_losses, record)
                              if r[0] == "train"]}
    out["params"] = {stage: _max_delta(p_stage[stage], stage_params[stage])
                     for stage in p_stage}
    out["history"] = {k: {"jax": [round(float(v), 4) for v in jres.history[k]],
                          "port": [round(float(v), 4) for v in pres.history[k]]}
                      for k in ("fine_tune_val_loss", "fine_tune_train_accuracy")}

    # ---- bank --------------------------------------------------------------------
    jrows = np.asarray(jnewest(jres.bank))
    prows = newest_first(pres.bank).numpy()
    out["bank"] = {"jax_rows": int(jres.bank.count), "port_rows": int(pres.bank.count)}
    if jrows.shape == prows.shape and jrows.size:
        out["bank"]["max_abs_delta"] = float(np.abs(jrows - prows).max())

    # ---- scores: both models through the port's evaluator ------------------------
    test = mvtec.prepare_mvtec_test_data(tree, subject, imsize=(imsize, imsize))
    ecfg = EvalConfig(imsize=(imsize, imsize), seed=0)
    jbank = bank_from_numpy(np.asarray(jres.bank.data), jres.bank.cursor, jres.bank.count)
    jsd = state_dict_from_jax(_np(jres.params), _np(jres.batch_stats))
    out["scores"] = {}
    for name, sd, bank in (("jax_trained", jsd, jbank),
                           ("port_trained", pres.state_dict, pres.bank)):
        model = build_model(ModelConfig(compute_dtype=dtype))
        model.load_state_dict(sd, strict=True)
        r = evaluator.evaluate_category(InferenceEngine(model, torch.device("cpu")), bank,
                                        pdata, test, ecfg, subject, with_artificial=False)
        out["scores"][name] = {"image_auroc": r.image_auroc, "image_f1": r.image_f1}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subject", default="bottle")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--imsize", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--min-len", type=int, default=64)
    ap.add_argument("--epochs", default="2,6")
    ap.add_argument("--same-batches", action="store_true",
                    help="hand the port JAX's batches, not only its draws")
    ap.add_argument("--declared", action="store_true",
                    help="compile the JAX side at declared precision")
    ap.add_argument("--tpu-one-pass", action="store_true",
                    help="round the JAX side's f32 DEFAULT-precision dots' operands to bf16")
    args = ap.parse_args()
    torch.set_num_threads(4)
    epochs = tuple(int(e) for e in args.epochs.split(","))
    print(json.dumps(run(args.subject, args.dtype, args.imsize, args.batch, args.min_len,
                         epochs, args.same_batches, args.declared,
                         args.tpu_one_pass)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
