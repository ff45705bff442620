"""The rank grid (parallel/mesh.py) and the multi-process layer
(parallel/distributed.py): grid shapes as the JAX mesh's over the tests'
8 virtual devices, indivisible and oversized grids refused, the layout a
checkpoint's MeshConfig rebuilds; the barrier a no-op in one process,
``global_any`` across two gloo ranks, and ``launch_local``'s exit codes."""

import operator

import pytest
import torch
from _torch_parallel import run_ranks

from ssad_tpu_torch.config import MeshConfig, TrainConfig
from ssad_tpu_torch.parallel import distributed as dist_mod
from ssad_tpu_torch.parallel.mesh import (
    Mesh, ShardingError, local_devices, make_mesh, mesh_from_config, new_groups, shard_devices,
)


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_grid_shapes_equal_the_jax_mesh(n_model):
    import jax

    from ssad_tpu.parallel.mesh import make_mesh as jax_mesh

    world = len(jax.devices())
    assert make_mesh(n_model, world=world).shape == dict(jax_mesh(n_model=n_model).shape)


def test_grid_layout_is_row_major():
    m = make_mesh(2, world=6)
    assert (m.n_model, m.n_data, m.size) == (2, 3, 6)
    assert [m.coords(r) for r in range(6)] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert m.data_ranks(1) == [3, 4, 5] and m.model_ranks(2) == [2, 5]
    assert make_mesh(world=1) == Mesh(1, 1)  # no process group: a world of one


@pytest.mark.parametrize("n_model, n_data, world", [(3, None, 8), (2, 8, 8), (0, None, 4)])
def test_indivisible_or_oversized_grids_raise(n_model, n_data, world):
    with pytest.raises(ValueError):
        make_mesh(n_model, n_data, world=world)


def test_mesh_config_rebuilds_the_layout():
    cfg = TrainConfig(mesh=MeshConfig(data_axis=-1, model_axis=2))
    back = TrainConfig.from_json(cfg.to_json())
    assert mesh_from_config(back.mesh, world=8) == Mesh(2, 4)
    assert mesh_from_config(MeshConfig(data_axis=2, model_axis=2), world=8) == Mesh(2, 2)


def test_cpu_shards_take_a_core_each():
    cores = len(local_devices("cpu"))
    assert cores >= 1 and set(local_devices("cpu")) == {torch.device("cpu")}
    assert shard_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ShardingError, match=f"exceeds {cores} available devices"):
        shard_devices(cores + 1, "cpu", "category_shards")


def test_barrier_is_a_noop_in_one_process():
    assert not dist_mod.is_multiprocess()
    dist_mod.barrier("test", timeout_s=0.1)  # no process group
    with dist_mod.process_group(f"127.0.0.1:{dist_mod.free_port()}", 1, 0, "cpu", 30):
        assert not dist_mod.is_multiprocess() and dist_mod.rank() == 0
        dist_mod.barrier("test", timeout_s=0.1)
        assert dist_mod.global_any(True) and not dist_mod.global_any(False)
        assert dist_mod.to_host({"a": 1}) == [{"a": 1}] and dist_mod.put_global(3) == 3
        groups = new_groups(Mesh(1, 1))
        assert (groups.data, groups.model, groups.model_index) == (None, None, 0)
    assert not torch.distributed.is_initialized()


def test_global_any_across_two_ranks(tmp_path):
    torch.save({}, tmp_path / "inputs.pt")
    outs = run_ranks("global_any", 2, tmp_path / "inputs.pt", tmp_path)
    # rank r raises its flag in round r; the last round nobody does
    assert [o["any"] for o in outs] == [[True, True, False]] * 2


def test_launch_local_exit_codes():
    """Ranks run ``target(rank, *args)``: both return 0 → 0; rank 1
    returns 75 (a drain) → 75; rank 0 raises → its code, the other stopped."""
    assert dist_mod.launch_local(operator.mul, 1, 0, (75,)) == 0  # in process
    assert dist_mod.launch_local(operator.mul, 2, 0, (75,)) == 75
    assert dist_mod.launch_local(operator.truediv, 2, 0, (0,)) == 1
