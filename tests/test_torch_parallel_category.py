"""Category-parallel training (parallel/category_parallel.py) on the CPU.

The JAX policies against the JAX functions: ``group_compatible_subjects``
for all 15 subjects in both modes, and ``stack_category_data``'s
truncation to the smallest count and shared cut pool, on the same inputs.
The stacked step against the single-category ``Trainer.train_step`` on
the same draws and stacked data: bit for bit per category.  Then
``fit_categories`` end to end (two fixed objects in one chunk, a
one-category chunk equal to ``Trainer.fit`` bit for bit), a killed and
resumed run equal to an uninterrupted one, and a snapshot of another
stack failing loudly.  64², batch 4, f32, 1 + 2 epochs of one step."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parallel import write_tree

from ssad_tpu_torch import constants
from ssad_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from ssad_tpu_torch.data import mvtec
from ssad_tpu_torch.parallel import category_parallel as cp
from ssad_tpu_torch.parallel.mesh import make_mesh
from ssad_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

SIZE, BATCH = 64, 4
MESH = make_mesh(1, world=1)


def fit(*args, **kw):
    return cp.fit_categories(*args, device="cpu", **kw)


def _cfg(**optim):
    return TrainConfig(
        data=DataConfig(imsize=(SIZE, SIZE), batch_size=BATCH, min_dataset_length=BATCH),
        model=ModelConfig(compute_dtype="float32", memory_bank_size=16),
        optim=OptimConfig(**{"projection_epochs": 1, "fine_tune_epochs": 2,
                             "checkpoint_every_n_epochs": 1, "val_batches": 1, **optim}))


@pytest.fixture(scope="module")
def datas(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("tree"))
    out = {s: mvtec.prepare_pretext_data(root, s, imsize=(SIZE, SIZE))
           for s in ("bottle", "cable", "carpet")}
    # a smaller cable split: the stack cuts every category to the smallest
    out["cable"] = dataclasses.replace(out["cable"], train_images=out["cable"].train_images[:2])
    return out


@pytest.mark.parametrize("patch", [False, True], ids=["image", "patch"])
def test_grouping_equals_jax_for_all_subjects(patch):
    from ssad_tpu.parallel.category_parallel import group_compatible_subjects as jax_groups

    for subjects in (list(constants.ALL_CATEGORIES), list(reversed(constants.ALL_CATEGORIES))):
        assert cp.group_compatible_subjects(subjects, patch) == jax_groups(subjects, patch)


@pytest.mark.parametrize("split", ["train", "val"])
def test_stacking_truncates_and_shares_the_pool_as_jax(datas, split):
    from ssad_tpu.parallel.category_parallel import stack_category_data as jax_stack
    from ssad_tpu.parallel.mesh import make_mesh as jax_mesh

    chunk = [datas["bottle"], datas["cable"]]
    got = cp.stack_category_data(chunk, split)
    want = jax_stack(chunk, jax_mesh(n_model=2), split)
    for name in cp.CategoryData._fields:
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), name
    if split == "train":
        assert got.images.shape[:2] == (2, 2)  # cut to cable's 2 images
    assert np.array_equal(got.cut_pool, datas["bottle"].cut_pool)


def test_stacked_step_equals_the_single_category_step(datas):
    cfg = _cfg()
    chunk = cp._chunk_data([datas["bottle"], datas["cable"]])
    spec = Trainer(cfg, chunk[0], "cpu").spec
    trainers, states, singles = [], [], []
    for p, data in enumerate(chunk):
        t = Trainer(cfg, data, "cpu")
        t.spec = spec
        states.append(t.make_state("fine_tune"))  # PyTorch's init: cheaper, as good here
        trainers.append(t)
        singles.append(copy.deepcopy((t, states[-1])))  # a single-category trainer, same init
    gens = [cp.category_generator(0, 2, p) for p in range(2)]
    single_gens = [copy.deepcopy(g) for g in gens]
    dds = [t.device_data("train") for t in trainers]
    new, metrics = cp.stacked_step(trainers, states, gens, dds, fill=True)
    for p, ((one, st), g) in enumerate(zip(singles, single_gens)):
        dd = one.device_data("train")
        st, m = one.train_step(st, one.upload_draws(g, dd), dd, True)
        assert torch.equal(m["loss"], metrics[p]["loss"]), p
        assert torch.equal(m["logits"], metrics[p]["logits"]), p
        a, b = st.model.state_dict(), new[p].model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), p
        for name, param in st.model.named_parameters():
            assert torch.equal(param.grad, dict(new[p].model.named_parameters())[name].grad)
        assert all(torch.equal(u, v) for u, v in zip(st.bank, new[p].bank)), p
    assert not torch.equal(metrics[0]["loss"], metrics[1]["loss"])


@pytest.fixture(scope="module")
def two_categories(datas):
    """(an uninterrupted stacked run of bottle and cable, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = fit(_cfg(), ["bottle", "cable"], [datas["bottle"], datas["cable"]], MESH,
                      stack_size=2, verbose=True)
    return results, buf.getvalue()


def test_two_categories_end_to_end(two_categories, tmp_path):
    from ssad_tpu_torch.evaluation import inference as inf
    from ssad_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _cfg()
    results, printed = two_categories
    assert set(results) == {"bottle", "cable"}
    assert "[bottle+cable/fine_tune] epoch 2/2" in printed and "padding" not in printed
    a, b = (results[s].state_dict["classifier.weight"] for s in ("bottle", "cable"))
    assert not torch.equal(a, b)
    for r in results.values():
        for key, n in (("projection_train_loss", 1), ("projection_val_loss", 1),
                       ("fine_tune_train_loss", 2), ("fine_tune_val_accuracy", 2),
                       ("fine_tune_images_per_sec", 2)):
            assert len(r.history[key]) == n, key
        assert r.best_state_dict is not None and np.isfinite(r.best_val_loss)
    path = save_checkpoint(tmp_path / "bottle", results["bottle"].state_dict,
                           results["bottle"].bank, cfg)
    engine, _, _ = inf.load_engine(path, "cpu")
    logits, emb = engine.predict_batch(torch.zeros(2, SIZE, SIZE, 3))
    assert logits.shape == (2, 4) and emb.shape == (2, 512)


def _same(a, b):
    assert set(a.state_dict) == set(b.state_dict)
    for k in a.state_dict:
        assert torch.equal(a.state_dict[k], b.state_dict[k]), k
    for k in a.best_state_dict:
        assert torch.equal(a.best_state_dict[k], b.best_state_dict[k]), k
    assert all(torch.equal(u, v) for u, v in zip(a.bank, b.bank))
    for key in a.history:
        if not key.endswith("images_per_sec"):
            assert a.history[key] == b.history[key], key


def test_one_category_chunk_is_the_trainer_fit(datas):
    cfg = _cfg()
    data = cp._chunk_data([datas["bottle"]])[0]
    whole = Trainer(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, subject="bottle")),
                    data, "cpu").fit(seed=0, verbose=False)
    got = fit(cfg, ["bottle"], [datas["bottle"]], MESH, verbose=False)["bottle"]
    _same(got, whole)
    assert got.best_val_loss == whole.best_val_loss


def test_kill_and_resume_equals_an_uninterrupted_run(datas, two_categories, tmp_path,
                                                    monkeypatch):
    cfg = _cfg()
    subjects, ds = ["bottle", "cable"], [datas["bottle"], datas["cable"]]
    base = two_categories[0]
    real = cp._save_group_snapshot

    class Kill(RuntimeError):
        pass

    def killing(path, payload):
        real(path, payload)
        if payload["stage"] == "fine_tune" and payload["epoch"] == 1:
            raise Kill()

    monkeypatch.setattr(cp, "_save_group_snapshot", killing)
    with pytest.raises(Kill):
        fit(cfg, subjects, ds, MESH, stack_size=2, verbose=False,
                          resume_dir=str(tmp_path))
    monkeypatch.setattr(cp, "_save_group_snapshot", real)
    resumed = fit(cfg, subjects, ds, MESH, stack_size=2, verbose=False,
                                resume_dir=str(tmp_path))
    for s in subjects:
        _same(resumed[s], base[s])


def test_a_snapshot_of_another_stack_fails_loudly(datas, tmp_path, capsys):
    """The snapshot path names the group's subjects only: one written with
    --stack 4 must stop a --stack 2 run with a clear error.  (A
    1-category group in a stack of 2 is padded with a duplicate, and the
    run says so first.)"""
    snap = cp._group_snapshot_path(tmp_path, ["carpet"])
    cp._save_group_snapshot(snap, {"stage": "fine_tune", "epoch": 1, "categories": {},
                                   "histories": {}, "stack": 4, "backbone": "resnet18"})
    with pytest.raises(SystemExit, match="stack=4"):
        fit(_cfg(), ["carpet"], [datas["carpet"]], MESH, stack_size=2, verbose=True,
            resume_dir=str(tmp_path))
    assert "[carpet] padding 1-category chunk to stack=2" in capsys.readouterr().out
