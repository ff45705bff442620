"""A second fine-tune step of the port from a JAX training state carried
across (``utils/jax_bridge``: the momentum tree, the schedule's count and
the bank), against the JAX package's second step: loss, logits, layer 4's
and the head's gradients, the update, statistics and bank.  Setup and limits:
tests/test_torch_train_step.py and tests/_torch_train.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import _torch_train as T


@pytest.fixture(scope="module")
def jax_side():
    return T.make_jax_side()


def test_second_fine_tune_step_from_a_carried_jax_state(jax_side):
    """At these parameters one ulp of noise moves a layer-3 ReLU input of
    1.8e-6 across zero, and the port and JAX sit on its two sides: the
    gradients of layer 3 and the layers before it differ by up to 3.8 % of
    a tensor's scale (``layer3.1.conv2.weight``).  So the gradients of
    layer 4 and the head, which that ReLU does not reach, are held to the
    CPU limit (measured 8.0e-5 of scale); every new parameter equals the
    JAX one after swapping the JAX gradient for the port's, new = jax_new −
    lr₁·(g_port − g_jax), to 1e-6 (measured 1.2e-7; dropping the momentum
    or keeping epoch 0's lr moves it by about 1e-3).  The bank: count and
    cursor equal; the rows equal the JAX fill of this step's originals at
    the port's new parameters inserted into the carried bank, to the bank
    limit (measured 2.1e-6); and they are within 2e-3 of the JAX step's bank (measured
    8.6e-4: the rows this step adds are embedded by parameters that carry
    that gradient difference; a row in a wrong slot moves by ~1)."""
    from _torch_port import jax_variables

    from ssad_tpu.train.memory_bank import MemoryBank as JaxBank
    from ssad_tpu.train.memory_bank import insert as jax_insert
    from ssad_tpu.train.optim import cosine_warm_restarts as jax_schedule
    from ssad_tpu.train.trainer import bank_fill_embeddings as jax_fill

    j1, *_ = jax_side.step("fine_tune", jax_side.init_state("fine_tune"), T.seeded_batch(1))
    carried = T.to_np(j1)  # read before the next step donates j1
    trace, count = carried.opt_state[1].trace, int(carried.opt_state[2].count)
    assert count == 1  # the second step runs at epoch 1's lr
    batch = T.seeded_batch(2)
    j2, j_loss, j_logits, j_grads = jax_side.step("fine_tune", j1, batch)
    b = carried.bank
    tr, metrics, state = T.port_step(
        "fine_tune", carried.params, carried.batch_stats, batch, optax_state=(trace, count),
        bank=T.bank_from_numpy(b.data, b.cursor, b.count))
    assert state.optimizer.count == 2
    assert abs(float(metrics["loss"]) - j_loss) <= T.LOSS_TOL
    assert T.max_abs(metrics["logits"].numpy(), j_logits) <= T.LOGIT_TOL
    cfg = T.port_cfg().optim
    lr1 = float(jax_schedule(cfg.fine_tune_lr, cfg.fine_tune_epochs, 1)(1))
    assert lr1 < cfg.fine_tune_lr
    ref = T.state_dict_from_jax(T.to_np(j2.params), T.to_np(j2.batch_stats))
    g_ref = T.state_dict_from_jax(j_grads, None)
    sd = tr.model.state_dict()
    early = tuple(f"feature_extractor.{m}" for m in ("conv1", "bn1", "layer1", "layer2", "layer3"))
    for name, p in tr.model.named_parameters():
        if not name.startswith(early):
            g = g_ref[name].numpy()
            scale = max(float(np.max(np.abs(g))), T.GRAD_FLOOR)
            assert T.max_abs(p.grad.numpy(), g) <= T.GRAD_TOL * scale, name
        swapped = ref[name] - lr1 * (p.grad - g_ref[name])
        assert T.max_abs(sd[name].numpy(), swapped.numpy()) <= 1e-6, name
    for name, v in sd.items():
        if "running" in name:
            assert T.max_abs(v.numpy(), ref[name].numpy()) <= T.PARAM_TOL, name
    assert int(state.bank.count) == int(j2.bank.count)
    assert int(state.bank.cursor) == int(j2.bank.cursor)
    # the fill after a carried state, at the port's own new parameters
    y_hat = metrics["logits"].numpy().argmax(-1)
    assert (y_hat == j_logits.argmax(-1)).all()
    jmodel, params, stats = jax_variables(sd, "float32")
    orig = jnp.asarray(batch[2])
    emb = jax_fill(jmodel, params, stats, orig, jnp.asarray(True), jnp.zeros((T.BATCH, 512)))
    want = jax_insert(JaxBank(*(jnp.asarray(a) for a in (b.data, b.cursor, b.count))), emb,
                      jnp.asarray((batch[1] == 0) & (y_hat == 0)))
    assert int(want.count) == int(state.bank.count) and int(want.cursor) == int(state.bank.cursor)
    assert T.max_abs(state.bank.data.numpy(), np.asarray(want.data)) <= T.BANK_TOL
    assert T.max_abs(state.bank.data.numpy(), np.asarray(j2.bank.data)) <= 2e-3
