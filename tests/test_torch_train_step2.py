"""A second fine-tune step of the port from a JAX training state carried
across (``utils/jax_bridge``: the momentum tree, the schedule's count and
the bank), against the JAX package's second step under its decisions:
loss, logits, every gradient, the update, statistics and bank.  Setup and limits:
tests/test_torch_train_step.py and tests/_torch_train.py."""

import pytest
import _torch_train as T


@pytest.fixture(scope="module")
def jax_side():
    return T.make_jax_side()


def test_second_fine_tune_step_from_a_carried_jax_state(jax_side):
    """Under the JAX forward's decisions at the carried parameters
    (``_torch_train.Pinned``; unpinned, one layer-3 ReLU input of 1.8e-6
    sits on the two sides in the two packages and layer 3's and earlier
    gradients differ by up to 12 % of a tensor's scale): every gradient,
    the new parameters and statistics and the bank to ``CPU_LIMITS``
    (measured 9.8e-5 of scale, 4.6e-6, 3.1e-5), 1 flip 0.17 of its
    layer's spread from the boundary; and every new parameter equals the JAX one after
    swapping the JAX gradient for the port's, new = jax_new −
    lr₁·(g_port − g_jax), to 1e-6 (dropping the momentum or keeping epoch
    0's lr moves it by about 1e-3)."""
    from ssad_tpu.train.optim import cosine_warm_restarts as jax_schedule

    j1, *_ = jax_side.step("fine_tune", jax_side.init_state("fine_tune"), T.seeded_batch(1))
    carried = T.to_np(j1)  # read before the next step donates j1
    trace, count = carried.opt_state[1].trace, int(carried.opt_state[2].count)
    assert count == 1  # the second step runs at epoch 1's lr
    batch = T.seeded_batch(2)
    pin = T.Pinned(jax_side.decisions(carried.params, carried.batch_stats, batch))
    j2, j_loss, j_logits, j_grads = jax_side.step("fine_tune", j1, batch)
    b = carried.bank
    tr, metrics, state = T.port_step(
        "fine_tune", carried.params, carried.batch_stats, batch, optax_state=(trace, count),
        bank=T.bank_from_numpy(b.data, b.cursor, b.count), pin=pin)
    assert state.optimizer.count == 2
    T.check_step(tr, metrics, state, j2, j_loss, j_logits, j_grads, "fine_tune", pin)
    cfg = T.port_cfg().optim
    lr1 = float(jax_schedule(cfg.fine_tune_lr, cfg.fine_tune_epochs, 1)(1))
    assert lr1 < cfg.fine_tune_lr
    ref = T.state_dict_from_jax(T.to_np(j2.params), None)
    g_ref = T.state_dict_from_jax(j_grads, None)
    sd = tr.model.state_dict()
    for name, p in tr.model.named_parameters():
        swapped = ref[name] - lr1 * (p.grad - g_ref[name])
        assert T.max_abs(sd[name].numpy(), swapped.numpy()) <= 1e-6, name
    y_hat = metrics["logits"].numpy().argmax(-1)
    assert (y_hat == j_logits.argmax(-1)).all()
