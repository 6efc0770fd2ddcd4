"""The port's KV slot pool and incremental decode attention.

1. :class:`KVSlotPool` transitions, as ``tests/test_kvstate.py`` holds the
   JAX pool to them: exhaustion, double free, use-after-free, partial
   append, overflow all raise :class:`SlotError`; slot ``-1`` is a uniform
   no-op; :class:`DecodeSession` returns its slot on every exit.  The
   port's arena is torch tensors on the pool's device (here the CPU).
2. ``attention_decode`` step by step against the JAX package's on the same
   numpy weights and inputs, and against the port's own full-prefix
   ``sw_attention`` rerun, both within ``2e-4 · max|ref|`` (f32).
3. The stateful registration, the refusal of an accelerated stateful row,
   and the trace putting the state onto a ``serial_only`` node.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ModuleDatabase as JModuleDatabase
from repro.models.zoo import register_decode_modules as j_register
from repro.runtime.kvstate import KVSlotPool as JKVSlotPool
from repro_torch.core import Frontend, Library, ModuleDatabase
from repro_torch.models.zoo import register_decode_modules, sw_attention
from repro_torch.runtime.kvstate import DecodeSession, KVSlotPool, SlotError

torch.set_num_threads(1)


def _pool(n_slots: int = 2, max_seq: int = 4) -> KVSlotPool:
    return KVSlotPool(n_slots, max_seq, {"k": (3,), "v": (3,)}, device="cpu")


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------- #
# 1. Pool transitions
# --------------------------------------------------------------------------- #
def test_alloc_unique_and_exhaustion():
    p = _pool(n_slots=3)
    slots = [p.alloc() for _ in range(3)]
    assert len(set(slots)) == 3 and p.live_count() == 3
    with pytest.raises(SlotError, match="exhausted"):
        p.alloc()
    p.free(slots[1])
    assert p.alloc() == slots[1]
    assert p.stats() == {"n_slots": 3, "live": 3, "allocs": 4, "frees": 1,
                         "high_water": 3}


def test_double_free_raises_and_dead_row_free_is_noop():
    p = _pool()
    s = p.alloc()
    p.free(s)
    with pytest.raises(SlotError, match="non-live"):
        p.free(s)
    p.free(-1)
    assert p.frees == 1


def test_append_read_length_roundtrip_returns_copies():
    p = _pool()
    s = p.alloc()
    rows = [torch.arange(3, dtype=torch.float32) + 10 * t for t in range(3)]
    for t, r in enumerate(rows):
        assert p.length(s) == t
        assert p.append(s, k=r, v=-r) == t
    got = p.read(s)
    assert torch.equal(got["k"], torch.stack(rows))
    assert torch.equal(got["v"], -torch.stack(rows))
    got["k"][:] = 99.0                  # a copy: the arena is untouched
    assert torch.equal(p.read(s)["k"], torch.stack(rows))
    # rows given as numpy or lists land the same
    p.append(s, k=np.ones(3, np.float32), v=[2.0, 2.0, 2.0])
    assert torch.equal(p.read(s)["v"][-1], torch.full((3,), 2.0))
    p.free(s)


def test_append_must_write_every_buffer():
    p = _pool()
    s = p.alloc()
    with pytest.raises(SlotError, match="every buffer"):
        p.append(s, k=torch.zeros(3))
    with pytest.raises(SlotError, match="every buffer"):
        p.append(s, k=torch.zeros(3), v=torch.zeros(3), extra=torch.zeros(3))
    assert p.length(s) == 0
    p.free(s)


def test_slot_full_raises():
    p = _pool(max_seq=2)
    s = p.alloc()
    row = torch.zeros(3)
    p.append(s, k=row, v=row)
    p.append(s, k=row, v=row)
    with pytest.raises(SlotError, match="full"):
        p.append(s, k=row, v=row)
    p.free(s)


def test_use_after_free_raises_everywhere():
    p = _pool()
    s = p.alloc()
    p.free(s)
    row = torch.zeros(3)
    with pytest.raises(SlotError):
        p.append(s, k=row, v=row)
    with pytest.raises(SlotError):
        p.read(s)
    with pytest.raises(SlotError):
        p.length(s)
    with pytest.raises(SlotError):
        p.read(7)                               # out of range


def test_dead_row_is_uniform_noop():
    p = _pool()
    row = torch.ones(3)
    assert p.append(-1, k=row, v=row) == -1
    assert p.length(-1) == 0
    empty = p.read(-1)
    assert empty["k"].shape == (0, 3) and empty["v"].shape == (0, 3)
    assert p.allocs == 0 and p.live_count() == 0


def test_realloc_resets_length_no_stale_rows():
    p = _pool(n_slots=1)
    s = p.alloc()
    p.append(s, k=torch.ones(3), v=torch.ones(3))
    p.free(s)
    s2 = p.alloc()
    assert s2 == s and p.length(s2) == 0
    assert p.read(s2)["k"].shape == (0, 3)
    p.free(s2)


def test_check_no_leaks_audit():
    p = _pool()
    s = p.alloc()
    with pytest.raises(SlotError, match="leak audit"):
        p.check_no_leaks()
    p.check_no_leaks(expected_live=[s])
    assert p.live_slots() == [s]
    p.free(s)
    p.check_no_leaks()


def test_pool_arguments_are_checked_and_the_arena_is_on_the_device():
    for bad in (dict(n_slots=0, max_seq=1, specs={"k": (1,)}),
                dict(n_slots=1, max_seq=0, specs={"k": (1,)}),
                dict(n_slots=1, max_seq=1, specs={})):
        with pytest.raises(ValueError):
            KVSlotPool(**bad, device="cpu")
    p = KVSlotPool(2, 3, {"k": (2, 4)}, dtype=torch.float64, device="cpu")
    assert p._buf["k"].shape == (2, 3, 2, 4)
    assert p._buf["k"].dtype == torch.float64 and p.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVSlotPool(1, 1, {"k": (1,)})


def test_decode_session_frees_on_normal_exit_and_on_exception():
    p = _pool()
    with DecodeSession(p) as ses:
        assert ses.slot is not None and p.live_count() == 1
        p.append(ses.slot, k=torch.zeros(3), v=torch.zeros(3))
    assert ses.slot is None
    p.check_no_leaks()
    with pytest.raises(RuntimeError, match="driver died"):
        with DecodeSession(p):
            raise RuntimeError("driver died mid-request")
    p.check_no_leaks()
    assert p.allocs == 2 and p.frees == 2


# --------------------------------------------------------------------------- #
# 2. Incremental decode attention
# --------------------------------------------------------------------------- #
D, HEADS, T = 16, 4, 6


def _decode_dbs():
    jpool = JKVSlotPool(2, T + 1, {"k": (HEADS, D // HEADS),
                                   "v": (HEADS, D // HEADS)})
    jdb = JModuleDatabase()
    j_register(jdb, jpool, n_heads=HEADS)
    tpool = KVSlotPool(2, T + 1, {"k": (HEADS, D // HEADS),
                                  "v": (HEADS, D // HEADS)}, device="cpu")
    tdb = ModuleDatabase()
    register_decode_modules(tdb, tpool, n_heads=HEADS)
    return (jdb, jpool), (tdb, tpool)


def _weights(seed: int = 0):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((D, D)) * 0.3).astype(np.float32)
          for _ in range(4)]
    x = rng.standard_normal((T, D)).astype(np.float32)
    return ws, x


def test_decode_attention_matches_jax_and_the_full_prefix_rerun():
    """Step by step against the JAX package's ``attention_decode`` on the
    same numpy inputs, and against the port's own ``sw_attention`` over
    the accumulated prefix.  The second comparison is not bitwise: the
    incremental step attends one query row over the cached keys, the
    rerun computes all rows with other reduction shapes, and the
    vectorised and scalar paths of cos/sin may round the rotation angles
    differently — the JAX package's own bitwise test of the same property
    misses by 2.4e-7.  So both hold to the f32 tolerance of the
    reference's tests, ``2e-4 · max|ref|``."""
    (jdb, jpool), (tdb, tpool) = _decode_dbs()
    jattn = jdb.lookup("attention_decode").software
    tattn = tdb.lookup("attention_decode").software
    ws, x = _weights()
    jw = [jnp.asarray(w) for w in ws]
    tw = [torch.from_numpy(w) for w in ws]
    tx = torch.from_numpy(x)
    js, ts = jpool.alloc(), tpool.alloc()
    for t in range(T):
        want = np.asarray(jattn(jnp.asarray(x[t:t + 1]), js, *jw))
        got = tattn(tx[t:t + 1], ts, *tw)
        assert got.shape == (1, D) and got.dtype == torch.float32
        assert _rel(got, want) <= 2e-4, t
        full = sw_attention(tx[:t + 1], *tw, n_heads=HEADS)
        assert _rel(got, full[-1:]) <= 2e-4, t
        assert tpool.length(ts) == jpool.length(js) == t + 1
    np.testing.assert_allclose(tpool.read(ts)["k"].numpy(),
                               jpool.read(js)["k"], rtol=1e-5, atol=1e-6)
    tpool.free(ts)
    tpool.check_no_leaks()


def test_decode_attention_takes_a_tensor_slot_id():
    (_, _), (tdb, tpool) = _decode_dbs()
    attn = tdb.lookup("attention_decode").software
    ws, x = _weights(5)
    tw = [torch.from_numpy(w) for w in ws]
    s = tpool.alloc()
    a = attn(torch.from_numpy(x[:1]), torch.tensor(s), *tw)
    assert tpool.length(s) == 1 and torch.isfinite(a).all()
    tpool.free(s)


def test_decode_attention_dead_row_touches_nothing():
    (jdb, _), (tdb, tpool) = _decode_dbs()
    ws, x = _weights(1)
    tw = [torch.from_numpy(w) for w in ws]
    y = tdb.lookup("attention_decode").software(
        torch.from_numpy(x[:1]), -1, *tw)
    # a dead row attends over only itself == single-token full attention
    ref = sw_attention(torch.from_numpy(x[:1]), *tw, n_heads=HEADS)
    assert _rel(y, ref) <= 2e-4
    jy = jdb.lookup("attention_decode").software(
        jnp.asarray(x[:1]), -1, *[jnp.asarray(w) for w in ws])
    assert _rel(y, np.asarray(jy)) <= 2e-4
    assert tpool.allocs == 0 and tpool.live_count() == 0


# --------------------------------------------------------------------------- #
# 3. Stateful registration and trace
# --------------------------------------------------------------------------- #
def test_stateful_registration_and_accelerated_rejection():
    (_, _), (tdb, _) = _decode_dbs()
    entry = tdb.lookup("attention_decode")
    assert entry.state == "kv" and entry.accelerated is None
    assert not entry.batch_dims            # a group runs it row by row
    with pytest.raises(ValueError, match="stateful"):
        tdb.register("bad_stateful", software=lambda x: x,
                     accelerated=lambda x: x, state="kv")


def test_trace_threads_state_onto_serial_only_node():
    (_, _), (tdb, tpool) = _decode_dbs()
    lib = Library(tdb)
    ws, x = _weights(3)
    tw = [torch.from_numpy(w) for w in ws]

    def app(x, slot):
        return lib.attention_decode(x, slot, *tw)

    # trace with the dead row so trace-time execution mutates no state
    ir, _ = Frontend(tdb).trace(app, torch.from_numpy(x[:1]),
                                torch.tensor(-1))
    nodes = [n for n in ir.nodes if n.fn_key == "attention_decode"]
    assert len(nodes) == 1
    assert nodes[0].state == "kv" and nodes[0].serial_only
    assert tpool.allocs == 0 and tpool.live_count() == 0
