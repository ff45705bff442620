#!/usr/bin/env python3
"""The port's ``cli parity`` on the JAX run's own random stream, beside the
port's own generators: does the JAX package's one TPU run sit inside the
spread of the port's runs?

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_parity_replay.py [--jax-seeds 0,1,2] [--port-seeds 3,4,5]
        [--out chiprun_out/parity_replay] [--artificial 2048] [--subjects all]
        [--variants plain,one_pass,kmeans1,…]

Writes the seed-0 15-category tree once (the parity generator's, byte for
byte the JAX package's), then runs ``cli parity --dataset-dir <tree>
--subjects … --modes image --seed s`` in process at its defaults (256²,
batch 96, ResNet-18, bf16, 5 + 15 epochs) under PyTorch's default TF32
flags, once per seed, through the port's own seams (``seams``):

* a JAX seed trains and evaluates on the JAX package's random stream for
  that seed (``tests/_torch_jax_random.py``, numpy, no JAX): each
  ``Trainer`` loads JAX's ``init_model`` weights after ``init_state`` and
  its ``upload_draws`` returns the next batch of ``JaxTrainStream(seed,
  …)`` (indices and synthesis draws of every train and validation step, in
  the JAX trainer's order) without touching its generator; the evaluation
  synthesizes JAX's artificial batches and fits on JAX's permutation;
* a port seed runs the port's own generators, as
  ``scripts/torch_parity_all.py --seeds`` does.

Every run's artificial set holds ``--artificial`` samples (the JAX
package's 256 are its first 256 on a JAX stream: the batches are drawn in
the same order), so per-class pretext recall reads to about ±0.01.
``--variants`` runs each seed once per entry: ``plain``; ``one_pass``
gives the port the roundings a TPU makes in the JAX program and the port
does not (``tpu_one_pass``: the head's dense layers with bf16 operands,
forward and backward; the bank's rows in bf16); ``kmeans<s>`` draws the
cable's k-means from seed ``s`` (``cable_kmeans``: JAX's ``cv2.kmeans``
is unseeded, so its run took one of the same few cable masks at random).

Prints one JSON line per run (per subject: image AUROC and F1, the
pretext set's accuracy, macro-F1 and per-class recall on all samples and
on the first 256, the fine-tune history at epochs 5 / 10 / 15 read from
the run's log beside the JAX run's log
``outputs/parity15/image_refresh_r5.log``), then one summary line
(``summarize``).  Everything is also written under ``--out``.  ``--device
cpu`` with small ``--imsize``/``--batch-size``/``--epochs``/``--subjects``
rehearses it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
import torch_parity_all  # noqa: E402

JAX_LOG = ROOT / "outputs" / "parity15" / "image_refresh_r5.log"
JAX_TABLE = ROOT / "outputs" / "parity15" / "image_level" / "tables" / "markdown" / \
    "artificial_all_scores.md"
HISTORY_EPOCHS = (5, 10, 15)
HISTORY_KEYS = ("train_loss", "train_accuracy", "val_loss", "val_accuracy")
JAX_PREFIX = 256


def log_history(text: str) -> dict:
    """The fine-tune lines of a training log (the JAX run's, or the port's:
    both print ``[subject/fine_tune] epoch e/E loss … acc … val_loss …
    val_acc …``): subject → epoch → the four metrics."""
    pat = re.compile(r"\[(\w+)/fine_tune\] epoch (\d+)/\d+ loss ([\d.]+) acc ([\d.]+) "
                     r"val_loss ([\d.]+) val_acc ([\d.]+)")
    out: dict = {}
    for line in text.splitlines():
        m = pat.match(line)
        if m:
            out.setdefault(m.group(1), {})[int(m.group(2))] = dict(
                zip(HISTORY_KEYS, (float(v) for v in m.groups()[2:])))
    return out


def jax_table(path: Path = JAX_TABLE) -> dict:
    """The JAX run's pretext table: subject → accuracy, macro-F1, AUROC."""
    rows = {}
    for line in path.read_text().splitlines()[2:]:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 4 and cells[0] != "mean":
            rows[cells[0]] = dict(zip(("accuracy", "f1", "auroc"), map(float, cells[1:])))
    return rows


def regime(subject: str) -> str:
    from ssad_tpu_torch import constants

    if constants.is_texture(subject):
        return "texture"
    return "non_fixed" if constants.is_non_fixed_object(subject) else "fixed_pose"


def pretext(outputs, n=None) -> dict:
    """Accuracy, macro-F1 and per-class recall of (the first ``n`` of) an
    artificial set's outputs."""
    from types import SimpleNamespace

    from ssad_tpu_torch.evaluation.evaluator import evaluate_artificial

    cut = slice(None) if n is None else slice(0, n)
    s = evaluate_artificial(SimpleNamespace(y_true_multiclass=outputs.y_true_multiclass[cut],
                                            raw_predictions=outputs.raw_predictions[cut]))
    return {"n": int(outputs.y_true_multiclass[cut].shape[0]), "accuracy": s.accuracy,
            "macro_f1": s.f1_macro, "recall": {k: v[1] for k, v in s.per_class.items()},
            "support": {k: v[3] for k, v in s.per_class.items()}}


@contextlib.contextmanager
def patched(*patches):
    """Set each ``(owner, name, value)`` for the block, then restore."""
    saved = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for o, n, v in patches:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in reversed(saved):
            setattr(o, n, v)


def seams(jax_seed, n_artificial: int, record: dict) -> list:
    """The patches of one run, all at the port's own seams.  Every run's
    artificial set holds ``n_artificial`` samples (``num_samples``), kept
    in ``record``.  On a JAX seed, each ``Trainer`` loads JAX's init after
    its ``init_state`` and its ``upload_draws`` returns the next batch of
    ``JaxTrainStream(seed, …)`` without touching its generator; the
    evaluation synthesizes JAX's artificial batches and fits on JAX's
    permutation (``attach_anomaly_scores(perm=)``)."""
    import _torch_jax_random as jr

    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.train.trainer import Trainer
    from ssad_tpu_torch.utils.jax_bridge import state_dict_from_jax

    predict_artificial, init_state = inf.predict_artificial, Trainer.init_state
    attach = inf.attach_anomaly_scores

    def predict_artificial_n(engine, data, spec, num_samples=500, batch_size=32, seed=0):
        out = predict_artificial(engine, data, spec, num_samples=n_artificial,
                                 batch_size=batch_size, seed=seed)
        record.setdefault(spec.subject, {})["artificial"] = out
        return out

    patches = [(inf, "predict_artificial", predict_artificial_n)]
    if jax_seed is None:
        return patches
    init_sd = {}

    def init_from_jax(self, stage, seed=0, generator=None):
        state = init_state(self, stage, seed, generator)
        if "sd" not in init_sd:
            init_sd["sd"] = state_dict_from_jax(*jr.init_params(jax_seed, self.cfg.model))
        self.model.load_state_dict(init_sd["sd"], strict=True)
        return state

    def upload_jax_draws(self, generator, dd):
        cfg, d = self.cfg, self.data
        mine = record.setdefault(cfg.data.subject, {})
        if "stream" not in mine:
            n = (d.train_images.shape[0], d.val_images.shape[0])
            mine["n"], mine["steps"] = n, 0
            mine["stream"] = jr.JaxTrainStream(
                jax_seed, *n, cfg.data.batch_size,
                epochs=(cfg.optim.projection_epochs, cfg.optim.fine_tune_epochs),
                min_len=cfg.data.min_dataset_length, val_batches=cfg.optim.val_batches,
            ).batches(self.spec, d.cut_pool.shape[0])
        kind, idx, draws = next(mine["stream"])
        if dd.images.shape[0] != mine["n"][kind != "train"]:
            raise RuntimeError(f"{cfg.data.subject}: the stream's {kind} step met a split of "
                               f"{dd.images.shape[0]} images")
        mine["steps"] += 1
        return idx.to(self.device), draws.to(self.device)

    def attach_on_jax_perm(outputs, normality, *a, seed=0, perm=None, **kw):
        perm = jr.fit_permutation(seed, normality.shape[0]) if perm is None else perm
        return attach(outputs, normality, *a, seed=seed, perm=perm, **kw)

    return patches + [(Trainer, "init_state", init_from_jax),
                      (Trainer, "upload_draws", upload_jax_draws),
                      (inf, "artificial_batches", jr.artificial_batches),
                      (inf, "attach_anomaly_scores", attach_on_jax_perm)]


class _OnePassLinear(torch.autograd.Function):
    """``F.linear`` as a TPU runs an f32 dense layer at DEFAULT precision:
    each of the forward's and the backward's three products takes bf16
    operands and sums in f32 (TF32 stays off: a cuBLAS f32 GEMM of bf16
    values is exact in its products, as the MXU is)."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _bf16(x), _bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = b is not None
        return torch.nn.functional.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _bf16(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def tpu_one_pass() -> list:
    """The patches that give the port the TPU's own roundings of the JAX
    program (scripts/tpu_precision_census.py: the f32 dots at DEFAULT
    precision): the head's dense layers (forward, backward, the bank fill
    and the evaluation's forward) through ``_OnePassLinear``, and the
    bank's rows rounded to bf16 as the one-hot insert rounds them
    (ssad_tpu/train/memory_bank.py:65).  The synthesizer's line dots are
    left in f32 (tests/test_torch_synth_256.py bounds their effect)."""
    from ssad_tpu_torch.train import trainer as ptrainer

    insert = ptrainer.insert

    def forward(self, x):
        return _OnePassLinear.apply(x, self.weight, self.bias)

    def insert_bf16_rows(bank, embeddings, mask):
        return insert(bank, _bf16(embeddings), mask)

    return [(torch.nn.Linear, "forward", forward), (ptrainer, "insert", insert_bf16_rows)]


def cable_kmeans(seed: int) -> list:
    """The patch that draws the cable's k-means (its posterization, hence
    its object mask and the defects' coordinates) from
    ``numpy.random.Generator(seed)`` instead of seed 0: the JAX package's
    ``cv2.kmeans`` is unseeded, so its run took one of the same few masks
    at random."""
    from ssad_tpu_torch.data import masks

    posterize = masks.posterize_cable

    def posterize_seeded(image_u8, n_segments=5):
        return posterize(image_u8, n_segments, seed)

    return [(masks, "posterize_cable", posterize_seeded)]


def variant_patches(variant: str) -> list:
    """``plain``; ``one_pass`` (``tpu_one_pass``); ``kmeans<s>``
    (``cable_kmeans(s)``)."""
    if variant == "plain":
        return []
    if variant == "one_pass":
        return tpu_one_pass()
    m = re.fullmatch(r"kmeans(\d+)", variant)
    if m is None:
        raise SystemExit(f"unknown variant {variant!r}")
    return cable_kmeans(int(m.group(1)))


def run_one(tree: Path, work: Path, seed: int, jax_stream: bool, variant: str, args,
            jax: dict, jlog: dict) -> dict:
    """One ``cli parity`` run → its record (and the summary's metrics)."""
    from ssad_tpu_torch import cli

    record: dict = {}
    argv = ["parity", "--subjects", args.subjects, "--outputs-dir", str(work),
            "--modes", "image", "--dataset-dir", str(tree), "--seed", str(seed),
            "--imsize", str(args.imsize), "--batch-size", str(args.batch_size),
            "--projection-epochs", str(args.epochs[0]),
            "--fine-tune-epochs", str(args.epochs[1]), "--device", args.device]
    patches = seams(seed if jax_stream else None, args.artificial, record) + \
        variant_patches(variant)
    chip_smoke._zero_launches()
    t0 = time.perf_counter()
    tf32 = chip_smoke.torch_default_tf32() if args.device == "cuda" else contextlib.nullcontext()
    log = io.StringIO()
    with patched(*patches), tf32, contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sys.stderr.write(log.getvalue())
    if rc != 0:
        raise SystemExit(f"cli parity returned {rc}")
    for subject, r in record.items():
        if "stream" in r and next(r["stream"], None) is not None:
            raise RuntimeError(f"{subject}: the port stopped before the JAX stream's end")
    history = log_history(log.getvalue())
    summary = json.loads((work / "parity_summary.json").read_text())
    per_subject = {}
    for subject, m in summary["image"]["per_subject"].items():
        r = record[subject]
        per_subject[subject] = {
            "regime": regime(subject), "image_auroc": m["image_auroc"],
            "image_f1": m["image_f1"],
            "jax_tpu": {k: jax["image"]["per_subject"].get(subject, {}).get(k)
                        for k in ("image_auroc", "image_f1")},
            "pretext": pretext(r["artificial"]),
            "pretext_first_256": pretext(r["artificial"], JAX_PREFIX),
            "history": {e: history.get(subject, {}).get(e) for e in HISTORY_EPOCHS},
            "jax_history": {e: jlog.get(subject, {}).get(e) for e in HISTORY_EPOCHS},
            "stream_steps": r.get("steps", 0)}
    card = chip_smoke.card_line() if args.device == "cuda" else "cpu"
    return {"seed": seed, "stream": "jax" if jax_stream else "port", "variant": variant,
            "card": card, "n_artificial": args.artificial,
            "image_auroc_mean": summary["image"]["image_auroc"],
            "per_subject": per_subject, "launches": chip_smoke._eval_launches(),
            "wall_s": wall}


def run_name(r: dict) -> str:
    variant = r.get("variant", "plain")
    return f"{r['stream']}{r['seed']}" + ("" if variant == "plain" else f"_{variant}")


def summarize(runs: list, jtab: dict, earlier: dict = None) -> dict:
    """Per subject each run's image AUROC; the fault rule (port mean more
    than GAP below JAX's TPU run, every run below) over the port's own
    seeds here and those of ``earlier`` (a ``torch_parity_all.py --seeds``
    record), and over those and the port's runs on JAX's streams; the
    spread of the port on JAX's streams (context, not a reference: it is
    the port's arithmetic on JAX's draws); each run of another
    ``--variants`` entry beside the same seed's plain run; the pretext
    macro-F1 gap against JAX's 256-sample table by regime, over the JAX
    streams and on stream 0 alone (the TPU run's own draws and artificial
    set)."""
    gap = torch_parity_all.GAP
    subjects = sorted(runs[0]["per_subject"])
    plain = [r for r in runs if r.get("variant", "plain") == "plain"]
    on_jax = [r for r in plain if r["stream"] == "jax"]
    stream0 = [r for r in on_jax if r["seed"] == 0]
    table, gaps, gaps0 = {}, {}, {}
    faults = {"port_seeds": [], "all_port_runs": []}
    for s in subjects:
        vals = {run_name(r): r["per_subject"][s]["image_auroc"] for r in runs}
        port = {run_name(r): vals[run_name(r)] for r in plain if r["stream"] == "port"}
        if earlier:
            port.update({f"port{k}": v for k, v in
                         earlier["per_subject"][s]["image_auroc"]["seeds"].items()})
        jv = [r["per_subject"][s]["image_auroc"] for r in on_jax]
        f1 = [r["per_subject"][s]["pretext_first_256"]["macro_f1"] for r in on_jax]
        tpu = runs[0]["per_subject"][s]["jax_tpu"]["image_auroc"]
        row = table[s] = {"regime": regime(s), "image_auroc": vals, "port_seeds": port,
                          "port_on_jax_streams_min_max": [min(jv), max(jv)] if jv else None,
                          "port_on_jax_streams_mean": sum(jv) / len(jv) if jv else None,
                          "jax_tpu": tpu, "pretext_f1_port_on_jax_streams_256": f1,
                          "pretext_f1_jax_tpu_256": jtab.get(s, {}).get("f1")}
        other = {run_name(r): [vals[run_name(r)], vals.get(run_name({**r, "variant": "plain"}))]
                 for r in runs if r.get("variant", "plain") != "plain"}
        if other:
            row["variant_vs_plain"] = other
        for name, group in (("port_seeds", port),
                            ("all_port_runs", {**port, **{run_name(r): vals[run_name(r)]
                                                          for r in on_jax}})):
            if group and tpu is not None:
                pm = sum(group.values()) / len(group)
                row[f"{name}_mean"] = pm
                if pm < tpu - gap and max(group.values()) < tpu:
                    faults[name].append([s, pm, tpu, len(group)])
        if f1 and s in jtab:
            gaps.setdefault(regime(s), {})[s] = sum(f1) / len(f1) - jtab[s]["f1"]
        if stream0 and s in jtab:
            gaps0.setdefault(regime(s), {})[s] = (
                stream0[0]["per_subject"][s]["pretext_first_256"]["macro_f1"] - jtab[s]["f1"])

    def by_regime(g):
        return {k: {"subjects": v, "mean": sum(v.values()) / len(v),
                    "below": sum(x < 0 for x in v.values()), "of": len(v)} for k, v in g.items()}

    return {"per_subject": table, "pretext_f1_gap_by_regime": by_regime(gaps),
            "pretext_f1_gap_stream0_by_regime": by_regime(gaps0),
            "fault_rule": f"against JAX's TPU run: port mean more than {gap} below, "
                          "every run below",
            "faults": faults}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-seeds", default="0,1,2")
    ap.add_argument("--port-seeds", default="3,4,5")
    ap.add_argument("--out", default="chiprun_out/parity_replay")
    ap.add_argument("--artificial", type=int, default=2048)
    ap.add_argument("--subjects", default="all")
    ap.add_argument("--imsize", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=96)
    ap.add_argument("--epochs", default="5,15")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default="plain",
                    help="each seed's runs: plain, one_pass (the TPU's own roundings, "
                         "tpu_one_pass), kmeans<s> (the cable's k-means from seed s)")
    ap.add_argument("--merge-only", action="store_true",
                    help="run nothing: summarize the run records already under --out")
    ap.add_argument("--earlier-port-seeds", default=None,
                    help="a torch_parity_all.py --seeds record (parity_seeds.json) whose "
                         "seeds join the port's in the fault rule")
    args = ap.parse_args()
    args.epochs = tuple(int(e) for e in args.epochs.split(","))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    jax = json.loads(torch_parity_all.JAX_SUMMARY.read_text())
    jlog, jtab = log_history(JAX_LOG.read_text()), jax_table()
    earlier = json.loads(Path(args.earlier_port_seeds).read_text()) \
        if args.earlier_port_seeds else None
    if args.merge_only:
        runs = sorted((json.loads(p.read_text()) for p in out.glob("*.json")
                       if re.fullmatch(r"(jax|port)\d+(_\w+)?\.json", p.name)),
                      key=lambda r: (r["stream"] != "jax", r["seed"], run_name(r)))
        summary = {"runs": [run_name(r) for r in runs], "dataset_seed": 0,
                   "n_artificial": sorted({r["n_artificial"] for r in runs}),
                   **summarize(runs, jtab, earlier), "cards": sorted({r["card"] for r in runs})}
        (out / "replay_summary.json").write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary), flush=True)
        return 0
    variants = args.variants.split(",")
    for v in variants:
        variant_patches(v)
    seeds = [(int(s), True) for s in args.jax_seeds.split(",") if s] + \
        [(int(s), False) for s in args.port_seeds.split(",") if s]
    t0 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        from ssad_tpu_torch import constants
        from ssad_tpu_torch.parity import generate_parity_dataset

        tree = Path(tmp) / "synthetic_dataset"
        subjects = list(constants.ALL_CATEGORIES)
        generate_parity_dataset(tree, subjects, imsize=args.imsize, seed=0)
        manifest = json.loads((tree / "manifest.json").read_text())
        want = {**torch_parity_all.JAX_MANIFEST, "subjects": sorted(subjects),
                "imsize": args.imsize}
        if manifest != want:
            raise SystemExit(f"the tree's manifest {manifest} is not JAX's {want}")
        for seed, jax_stream in seeds:
            for variant in variants:
                name = run_name({"stream": "jax" if jax_stream else "port", "seed": seed,
                                 "variant": variant})
                work = Path(tmp) / name
                rec = run_one(tree, work, seed, jax_stream, variant, args, jax, jlog)
                torch_parity_all.keep(work, out / name)
                (out / f"{name}.json").write_text(json.dumps(rec, indent=1))
                runs.append(rec)
                print(json.dumps(rec), flush=True)
    card = chip_smoke.card_line() if args.device == "cuda" else "cpu"
    summary = {"runs": [run_name(r) for r in runs], "dataset_seed": 0,
               "n_artificial": args.artificial, **summarize(runs, jtab, earlier),
               "wall_s": time.perf_counter() - t0, "card": card}
    (out / "replay_summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
