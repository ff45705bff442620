"""The batcher's staging buffer (serving/server.py ``BatchingScorer``), on
the CPU, where the buffer is plain numpy memory.

Held:
* the callable receives, byte for byte, what ``np.stack`` + ``np.pad``
  of the batch's rows gives: a full batch, then a short one after it (the
  pad rows zero, not the full batch's rows), then a full one again;
* the buffer is one array per runner, reused from batch to batch, and
  answers that share memory with it are copied before they are handed
  out, so batch 1's answers are unchanged once batch 2 has run;
* with two callables each runner has its own buffer and every answer
  reaches its request;
* a batch whose rows differ in shape fails with ``np.stack``'s error, as
  it did; rows of another shape than the buffer's get a new buffer and
  are served;
* a callable that names its input's size (``meta["imsize"]``) gets its
  buffer at warm-up, before any request;
* the buffer is page-locked only where the callable's device is a CUDA
  device, or, where it names none, where the process sees one: a CPU
  scorer on a host with a card gets plain memory.
"""

import threading
import time

import numpy as np
import pytest

from ssad_tpu_torch.serving import server
from ssad_tpu_torch.serving.server import BatchingScorer

BATCH = 4
ROW = (3, 5, 3)
#: long enough that rows submitted together always make one batch
DELAY_MS = 300.0


def _rows(seed: int, n: int, shape=ROW) -> list:
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n)]


def _padded(rows) -> np.ndarray:
    x = np.stack(rows)
    return np.pad(x, ((0, BATCH - len(rows)),) + ((0, 0),) * 3)


def _run_batch(sc: BatchingScorer, rows, timeout: float = 30.0) -> list:
    """Submit the rows together (one batch: the batcher waits up to its
    delay for them) and wait for every answer."""
    reqs = [sc.submit(r) for r in rows]
    assert all(r.event.wait(timeout) for r in reqs)
    return reqs


class _Recording:
    """Row sums; records a copy of every batch it receives and where the
    batch lay in memory."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.seen, self.addresses = [], []
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.seen.append(x.copy())
            self.addresses.append(x.__array_interface__["data"][0])
        time.sleep(self.delay_s)
        return (x.reshape(x.shape[0], -1).sum(axis=1),)


# -- what the callable receives ------------------------------------------------


@pytest.mark.parametrize("sizes", [(4, 2, 4), (4, 1, 3, 4), (2, 4, 1)],
                         ids=["full-short-full", "full-one-three-full", "short-full-one"])
def test_the_callable_sees_the_padded_stack_byte_for_byte(sizes):
    fn = _Recording()
    sc = BatchingScorer(fn, batch=BATCH, max_delay_ms=DELAY_MS)
    try:
        expected = []
        for i, n in enumerate(sizes):
            rows = _rows(i, n)
            reqs = _run_batch(sc, rows)
            assert all(r.error is None for r in reqs)
            expected.append(_padded(rows))
            for r, row in zip(reqs, rows):
                assert np.isclose(r.result[0][0], row.sum(dtype=np.float64), rtol=1e-5)
        st = sc.stats()
    finally:
        sc.close()
    assert len(fn.seen) == len(sizes)
    for got, want in zip(fn.seen, expected):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    # one buffer, reused by every batch
    assert len(set(fn.addresses)) == 1
    assert st["batches"] == len(sizes)


@pytest.mark.parametrize("answer", ["identity", "view", "copy"])
def test_answers_do_not_change_when_the_next_batch_runs(answer):
    make = {"identity": lambda x: (x,),
            "view": lambda x: (x[:, 0], x.reshape(x.shape[0], -1)[:, :2]),
            "copy": lambda x: (x + 0,)}[answer]
    sc = BatchingScorer(make, batch=BATCH, max_delay_ms=DELAY_MS)
    try:
        first_rows, second_rows = _rows(1, BATCH), _rows(2, BATCH)
        first = _run_batch(sc, first_rows)
        kept = [tuple(a.copy() for a in r.result) for r in first]
        second = _run_batch(sc, second_rows)
    finally:
        sc.close()
    assert all(r.error is None for r in first + second)
    for r, k, row in zip(first, kept, first_rows):
        for a, b in zip(r.result, k):
            assert np.array_equal(a, b)
        if answer == "identity":
            assert np.array_equal(r.result[0][0], row)
    for r, row in zip(second, second_rows):
        if answer == "identity":
            assert np.array_equal(r.result[0][0], row)


def test_two_runners_each_have_their_own_buffer():
    fns = [_Recording(delay_s=0.02), _Recording(delay_s=0.02)]
    sc = BatchingScorer(fns, batch=BATCH, max_delay_ms=2.0)
    try:
        rows = _rows(3, 48)
        reqs = [sc.submit(r) for r in rows]
        assert all(r.event.wait(30) for r in reqs)
        st = sc.stats()
    finally:
        sc.close()
    assert all(r.error is None for r in reqs)
    for r, row in zip(reqs, rows):
        assert np.isclose(r.result[0][0], row.sum(dtype=np.float64), rtol=1e-5)
    used = [fn for fn in fns if fn.seen]
    assert len(used) == 2, "both runners should have taken batches"
    addresses = [set(fn.addresses) for fn in used]
    assert all(len(a) == 1 for a in addresses)
    assert addresses[0] != addresses[1]
    assert st["batches"] == sum(st["replica_batches"])


# -- rows of another shape ------------------------------------------------------


def test_rows_of_differing_shapes_fall_back_and_fail_as_before():
    fn = _Recording()
    sc = BatchingScorer(fn, batch=BATCH, max_delay_ms=DELAY_MS)
    try:
        good = _run_batch(sc, _rows(4, BATCH))
        mixed = _run_batch(sc, _rows(5, 2) + _rows(6, 1, shape=(3, 4, 3)))
        st = sc.stats()
    finally:
        sc.close()
    assert all(r.error is None for r in good)
    with pytest.raises(ValueError) as stacked:
        np.stack(_rows(5, 2) + _rows(6, 1, shape=(3, 4, 3)))
    for r in mixed:
        assert isinstance(r.error, ValueError)
        assert str(r.error) == str(stacked.value)
    assert len(fn.seen) == 1
    assert st["batches"] == 1


def test_rows_of_another_shape_than_the_buffer_are_stacked_afresh():
    fn = _Recording()
    sc = BatchingScorer(fn, batch=BATCH, max_delay_ms=DELAY_MS)
    try:
        _run_batch(sc, _rows(7, BATCH))
        other = _rows(8, 2, shape=(2, 2, 3))
        reqs = _run_batch(sc, other)
        again = _rows(9, 3)
        back = _run_batch(sc, again)
        st = sc.stats()
    finally:
        sc.close()
    assert all(r.error is None for r in reqs + back)
    assert fn.seen[1].tobytes() == np.pad(np.stack(other), ((0, 2), (0, 0), (0, 0),
                                                             (0, 0))).tobytes()
    # the full first batch's rows do not survive the change of shape
    assert fn.seen[2].tobytes() == _padded(again).tobytes()
    assert sc._staging[0].buf.shape == (BATCH,) + ROW
    assert st["batches"] == 3


# -- the buffer itself ---------------------------------------------------------


@pytest.mark.parametrize("case", ["shape", "mixed-first-batch"])
def test_stage_refuses_rows_that_do_not_match(case):
    st = server._Staging(BATCH, pinned=False)
    rows = _rows(10, 2)
    bad = _rows(12, 1, shape=(5, 3, 3))[0]
    if case == "shape":
        first = st.stage(rows).copy()
        with pytest.raises(ValueError, match="same shape"):
            st.stage([rows[0], bad])
        # nothing of the refused batch was written
        assert st.buf.tobytes() == first.tobytes()
    else:
        with pytest.raises(ValueError, match="same shape"):
            st.stage(rows + [bad])
    assert st.stage(rows)[:2].tobytes() == np.stack(rows).tobytes()


def test_a_full_batch_zeroes_nothing_and_a_short_one_only_the_dirty_rows():
    st = server._Staging(BATCH, pinned=False)
    buf = st.stage(_rows(13, BATCH))
    assert st.dirty == BATCH
    buf[:] = 7.0  # as if the callable had written to it: the rows are copied over anyway
    short = st.stage(_rows(14, 1))
    assert short is buf and st.dirty == 1
    assert np.array_equal(short[0], _rows(14, 1)[0])
    assert not short[1:].any()
    # rows at or past the mark are taken to be zero and not written again
    # (9.0 marks them here): a batch at least as long as the mark zeroes nothing
    buf[1:] = 9.0
    st.stage(_rows(15, 2))
    assert st.dirty == 2
    assert (buf[2:] == 9.0).all()


def test_the_buffer_has_the_batch_rows_and_the_rows_dtype():
    buf = server._Staging(BATCH, pinned=False).stage(_rows(16, 1))
    assert isinstance(buf, np.ndarray) and buf.flags.c_contiguous
    assert buf.shape == (BATCH,) + ROW and buf.dtype == np.float32


class _Described(_Recording):
    """A recording callable that names its device and its input's size,
    as ``ServedScorer`` and ``DeviceReplica`` do."""

    def __init__(self, device, imsize=ROW[:2]):
        super().__init__()
        if device is not None:
            self.device = device
        self.meta = {"imsize": list(imsize)}


@pytest.mark.parametrize("replicas", [1, 2])
def test_a_callable_that_names_its_input_gets_its_buffer_at_warmup(replicas):
    fns = [_Described("cpu") for _ in range(replicas)]
    sc = BatchingScorer(fns if replicas > 1 else fns[0], batch=BATCH, max_delay_ms=DELAY_MS,
                        warmup=lambda fn: 0.0)
    try:
        bufs = [st.buf for st in sc._staging]
        assert all(b is not None and b.shape == (BATCH,) + ROW and not b.any() for b in bufs)
        rows = _rows(17, 3)
        reqs = _run_batch(sc, rows)
        assert all(r.error is None for r in reqs)
        assert [st.buf for st in sc._staging] == bufs
    finally:
        sc.close()
    used = next(fn for fn in fns if fn.seen)
    assert used.addresses[0] in {b.__array_interface__["data"][0] for b in bufs}
    assert used.seen[0].tobytes() == _padded(rows).tobytes()


@pytest.mark.parametrize("device, cuda_seen, pinned", [
    ("cpu", True, False),
    ("cpu", False, False),
    ("cuda", True, True),
    ("cuda:1", True, True),
    (None, True, True),
    (None, False, False),
], ids=["cpu-on-a-card-host", "cpu", "cuda", "cuda-1", "unnamed-on-a-card-host", "unnamed"])
def test_the_buffer_is_page_locked_only_for_a_card_callable(monkeypatch, device, cuda_seen,
                                                             pinned):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_seen)
    asked = []
    real = server._host_buffer

    def recording(shape, pin):
        asked.append(pin)
        # this host cannot page-lock memory: give plain memory for a pinned ask
        return real(shape, False) if pin else real(shape, pin)

    monkeypatch.setattr(server, "_host_buffer", recording)
    fn = _Described(device)
    sc = BatchingScorer(fn, batch=BATCH, max_delay_ms=DELAY_MS, warmup=lambda fn: 0.0)
    try:
        reqs = _run_batch(sc, _rows(18, 2))
    finally:
        sc.close()
    assert all(r.error is None for r in reqs)
    assert asked == [pinned]


def test_a_cpu_scorer_on_a_card_host_never_asks_cuda_for_memory(monkeypatch):
    """With CUDA reported present, a CPU-device callable's buffer comes
    from numpy: the page-locked path (which would need a CUDA context,
    and raises on this host) is never taken."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn = _Described(torch.device("cpu"))
    sc = BatchingScorer(fn, batch=BATCH, max_delay_ms=DELAY_MS, warmup=lambda fn: 0.0)
    try:
        rows = _rows(19, BATCH)
        reqs = _run_batch(sc, rows)
        buf = sc._staging[0].buf
    finally:
        sc.close()
    assert all(r.error is None for r in reqs)
    assert buf.base is None  # numpy's own memory, not a torch tensor's
    assert fn.seen[0].tobytes() == _padded(rows).tobytes()
