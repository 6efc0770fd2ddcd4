"""Continuous batching on the port — the in-flight join seam.

Executor level, as ``tests/test_continuous.py:95-176`` holds the JAX
executor: ``try_join`` fills an unsealed group's padding seat (and only
that), ``try_evict`` turns a seat back into a dead row before the seal,
``seam_capacity`` reports exactly the free seats, and a closed seam joins
nothing.  The seam is pinned open deterministically by parking the single
stage-0 worker inside an older group's stage body on an event.

Serving level: ``Request.on_finish`` runs exactly once on shed and expired
requests, and a seeded continuous stress run over a stateful KV pipeline
(with and without injected transient faults) is held to a host ground
truth computed with the same float32 operations — slot aliasing, a double
append or an out-of-order retirement shows up as a mismatch.  Sessions
arrive by progress, not by the clock, and every wait has a deadline, so
the run neither flakes on a loaded host nor hangs.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import StageProfiler
from repro_torch.core.executor import PipelineExecutor
from repro_torch.launch.serve import (DeadlineExceeded, ExecutorClosed,
                                      RequestQueueServer)
from repro_torch.runtime import FaultPlan
from repro_torch.runtime.kvstate import KVSlotPool

torch.set_num_threads(1)

IO = 8
MB = 4
DEADLINE_S = 60.0


def _within(fn, *args, timeout: float = DEADLINE_S):
    """Run ``fn(*args)`` on a helper thread; fail (not hang) past the
    deadline."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:          # re-raised on the test thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _stage_fns(pool: KVSlotPool, *, gate: threading.Event | None = None,
               entered: threading.Event | None = None) -> list:
    """3-stage decode-shaped pipeline (pre / stateful kv / post) over
    ``[IO]`` and ``[B, IO]``.  When ``gate`` is given, the FIRST ``pre``
    call signals ``entered`` and waits on the gate — the stage-0 worker is
    then parked inside a sealed group, so every group submitted after it
    stays unsealed (a deterministic seam)."""
    first = [True]

    def pre(env):
        if gate is not None and first[0]:
            first[0] = False
            entered.set()
            assert gate.wait(timeout=DEADLINE_S)
        return {"x": env["x"] + 1.0, "slot": env["slot"]}

    def kv(env):
        x = env["x"]
        x2 = x if x.ndim == 2 else x[None]
        slots = torch.as_tensor(env["slot"]).reshape(-1).tolist()
        y = torch.empty_like(x2)
        for i, sid in enumerate(slots):
            hist = pool.read(int(sid))["k"]
            pool.append(int(sid), k=x2[i])
            y[i] = x2[i] + hist.sum(dim=0)
        return {"x": y if x.ndim == 2 else y[0]}

    def post(env):
        return {"y": env["x"] * 0.5}

    return [pre, kv, post]


def _executor(fns, *, open_groups: bool = True, replicas=(1, 1, 1),
              **kw) -> PipelineExecutor:
    return PipelineExecutor(
        fns, ["x", "slot"], ["y"], max_in_flight=64,
        replicas=list(replicas), microbatch=MB, pad_microbatches=True,
        buckets=(MB,), batched_fns=fns, open_groups=open_groups,
        pad_token=(torch.zeros(IO), -1), **kw)


def _expected_step(rows: list, x: torch.Tensor) -> torch.Tensor:
    """One decode step given the rows already in the slot — the kv
    stage's float32 operations in its order."""
    row = x + 1.0
    hist = torch.stack(rows) if rows else torch.zeros((0, IO))
    return (row + hist.sum(dim=0)) * 0.5


def _pool(n_slots: int) -> KVSlotPool:
    return KVSlotPool(n_slots, 4, {"k": (IO,)}, device="cpu")


# --------------------------------------------------------------------------- #
# Executor seam: join / evict / capacity
# --------------------------------------------------------------------------- #
def test_try_join_fills_open_seats_then_refuses():
    pool = _pool(8)
    gate, entered = threading.Event(), threading.Event()
    prof = StageProfiler(3, sample_every=1)
    ex = _executor(_stage_fns(pool, gate=gate, entered=entered),
                   profiler=prof)
    slots = [pool.alloc() for _ in range(4)]
    try:
        blocker = ex.submit(torch.zeros(IO), -1)
        assert entered.wait(DEADLINE_S)      # stage-0 worker parked
        xs = torch.arange(4 * IO, dtype=torch.float32).reshape(4, IO)
        hB = ex.submit(xs[0], slots[0])      # 1 real token, 3 seats
        assert ex.seam_capacity() == MB - 1
        # a signature mismatch never claims a seat
        assert ex.try_join((torch.zeros(IO + 1), slots[1])) is None
        joins = [ex.try_join((xs[i], slots[i])) for i in (1, 2, 3)]
        assert all(j is not None for j in joins)
        assert ex.seam_capacity() == 0       # group full: seam exhausted
        assert ex.try_join((xs[1], slots[1])) is None
        with pytest.raises(ValueError, match="inputs"):
            ex.try_join((xs[1],))
        gate.set()
        assert torch.equal(_within(blocker.result),
                           (torch.zeros(IO) + 1) * 0.5)
        for h, i in zip([hB] + joins, range(4)):
            assert torch.equal(_within(h.result), _expected_step([], xs[i]))
        st = ex.stats()
        assert st.seam_joins == 3 and st.as_dict()["seam_joins"] == 3
        assert st.tokens_admitted == st.tokens_retired == 5
        assert st.out_of_order_retired == 0
        # every live row appended exactly once; padding touched nothing
        assert [pool.length(s) for s in slots] == [1, 1, 1, 1]
        # two groups sealed: the blocker (1 of 4 seats) and the full one
        assert prof.snapshot()["seam"]["seals"] == 2
        assert prof.seam_fill() == pytest.approx(0.75 * 0.25 + 0.25 * 1.0)
    finally:
        gate.set()
        _within(ex.close)
    for s in slots:
        pool.free(s)
    pool.check_no_leaks()


def test_try_evict_unsealed_seat_is_dead_row():
    pool = _pool(4)
    gate, entered = threading.Event(), threading.Event()
    ex = _executor(_stage_fns(pool, gate=gate, entered=entered))
    s_live, s_gone = pool.alloc(), pool.alloc()
    try:
        blocker = ex.submit(torch.zeros(IO), -1)
        assert entered.wait(DEADLINE_S)
        x = torch.ones((2, IO))
        hB = ex.submit(x[0], s_live)
        hJ = ex.try_join((x[1], s_gone))
        assert hJ is not None
        boom = RuntimeError("client went away")
        assert ex.try_evict(hJ, boom) is True
        assert ex.try_evict(hJ, boom) is True       # idempotent
        gate.set()
        assert torch.equal(_within(hB.result), _expected_step([], x[0]))
        with pytest.raises(RuntimeError, match="client went away"):
            _within(hJ.result)
        _within(blocker.result)
        # the evicted seat ran as the dead row: its slot was never touched
        assert pool.length(s_gone) == 0 and pool.length(s_live) == 1
        assert ex.stats().seam_evictions == 1
        assert ex.try_evict(hB) is False            # sealed and retired
    finally:
        gate.set()
        _within(ex.close)
    pool.free(s_live)
    pool.free(s_gone)
    pool.check_no_leaks()


def test_seam_closed_without_open_groups():
    pool = _pool(2)
    ex = _executor(_stage_fns(pool), open_groups=False)
    try:
        assert ex.seam_capacity() == 0
        assert ex.try_join((torch.zeros(IO), -1)) is None
        h = ex.submit(torch.zeros(IO), -1)
        assert ex.try_evict(h) is False
        _within(h.result)
    finally:
        _within(ex.close)


def test_open_groups_needs_replicas_padding_and_a_full_pad_token():
    fns = _stage_fns(_pool(1))
    with pytest.raises(ValueError, match="replicated mode"):
        PipelineExecutor(fns, ["x", "slot"], ["y"], microbatch=MB,
                         pad_microbatches=True, open_groups=True)
    with pytest.raises(ValueError, match="pad_microbatches"):
        PipelineExecutor(fns, ["x", "slot"], ["y"], replicas=[1, 1, 1],
                         open_groups=True)
    with pytest.raises(ValueError, match="pad_token"):
        PipelineExecutor(fns, ["x", "slot"], ["y"], replicas=[1, 1, 1],
                         microbatch=MB, pad_microbatches=True,
                         pad_token=(torch.zeros(IO),))
    ex = PipelineExecutor(fns, ["x", "slot"], ["y"])
    with pytest.raises(ValueError, match="open_groups"):
        RequestQueueServer(ex, continuous=True)


def test_open_groups_pads_singletons_with_the_pad_token():
    """In open_groups mode a lone token still gets a stacked group, whose
    padding rows carry the dead-row pad token (never a repeat of the
    token, which would replay its slot append)."""
    pool = _pool(2)
    ex = _executor(_stage_fns(pool))
    s = pool.alloc()
    try:
        y = _within(ex.submit(torch.ones(IO), s).result)
        assert torch.equal(y, _expected_step([], torch.ones(IO)))
        assert pool.length(s) == 1 and ex._pad_for(1) == MB - 1
    finally:
        _within(ex.close)
    pool.free(s)
    pool.check_no_leaks()


# --------------------------------------------------------------------------- #
# on_finish: exactly once, on every terminal path
# --------------------------------------------------------------------------- #
def test_on_finish_exactly_once_on_shed_and_expired():
    pool = _pool(4)
    ex = _executor(_stage_fns(pool))
    calls: list = []
    srv = RequestQueueServer(ex, max_batch=MB, max_wait_ms=2.0,
                             queue_depth=64, continuous=True)
    srv.start()
    try:
        s1 = pool.alloc()
        r1 = srv.submit(torch.zeros(IO), s1, deadline_ms=0.001,
                        on_finish=lambda r: (calls.append(("r1", r)),
                                             pool.free(s1)))
        with pytest.raises(DeadlineExceeded):
            r1.wait(DEADLINE_S)
        s3 = pool.alloc()
        r3 = srv.submit(torch.zeros(IO), s3,
                        on_finish=lambda r: (calls.append(("r3", r)),
                                             pool.free(s3)))
        r3.wait(DEADLINE_S)
    finally:
        _within(srv.stop)
    # stopped server: the shed path still runs the release hook
    s2 = pool.alloc()
    r2 = srv.submit(torch.zeros(IO), s2,
                    on_finish=lambda r: (calls.append(("r2", r)),
                                         pool.free(s2)))
    with pytest.raises(ExecutorClosed):
        r2.wait(DEADLINE_S)
    _within(ex.close)
    assert sorted(c[0] for c in calls) == ["r1", "r2", "r3"]  # once each
    by = dict(calls)
    assert by["r1"].error is not None and by["r2"].error is not None
    assert by["r3"].error is None
    pool.check_no_leaks()                            # every slot returned
    st = srv.stats()
    assert (st["expired"], st["shed"], st["requests_served"]) == (1, 1, 1)
    assert st["release_errors"] == 0


def test_on_finish_errors_are_counted_not_raised():
    ex = _executor(_stage_fns(_pool(1)))
    srv = RequestQueueServer(ex, continuous=True)
    _within(srv.stop)
    r = srv.submit(torch.zeros(IO), -1,
                   on_finish=lambda r: 1 / 0)
    with pytest.raises(ExecutorClosed):
        r.wait(DEADLINE_S)
    assert srv.stats()["release_errors"] == 1
    _within(ex.close)


# --------------------------------------------------------------------------- #
# Serving stress: sessions that join and leave, host ground truth
# --------------------------------------------------------------------------- #
def _drive_sessions(srv, pool, xs, lengths, *, start: int = 3,
                    max_live: int = 8) -> list:
    """Each session decodes its steps in order (step t+1 goes in once step
    t resolved); new sessions arrive as earlier steps complete — ``start``
    at first, then one per completed step while fewer than ``max_live``
    are live.  The last step frees the slot through ``on_finish``."""
    n = len(lengths)
    outs: list = [[None] * int(lengths[i]) for i in range(n)]
    slots: list = [None] * n
    step = [0] * n
    active: dict = {}
    lock = threading.Lock()

    def release(sess):
        with lock:
            s, slots[sess] = slots[sess], None
        if s is not None:
            pool.free(s)

    def submit(sess):
        t = step[sess]
        last = t == lengths[sess] - 1
        active[sess] = srv.submit(
            xs[sess, t], slots[sess],
            priority="interactive" if t == 0 else "batch",
            on_finish=(lambda _r, s=sess: release(s)) if last else None)

    def admit(sess):
        slots[sess] = pool.alloc()
        submit(sess)

    nxt = 0
    for _ in range(min(start, n)):
        admit(nxt)
        nxt += 1
    t_end = time.monotonic() + DEADLINE_S
    while active:
        assert time.monotonic() < t_end, "stress run did not finish"
        done = [s for s, r in active.items() if r._event.is_set()]
        if not done:
            time.sleep(0.001)
            continue
        for sess in done:
            r = active.pop(sess)
            outs[sess][step[sess]] = r.wait(0)
            step[sess] += 1
            if step[sess] < lengths[sess]:
                submit(sess)
            if nxt < n and len(active) < max_live:
                admit(nxt)
                nxt += 1
    assert nxt == n
    return outs


def _stress(fault_injector=None, replicas=(1, 1, 1)):
    gen = torch.Generator().manual_seed(5)
    n = 20
    lengths = torch.randint(1, 5, (n,), generator=gen).tolist()
    xs = torch.randn((n, 4, IO), generator=gen)
    pool = _pool(12)
    kw = {} if fault_injector is None else {
        "fault_injector": fault_injector, "quarantine_after": 2}
    ex = _executor(_stage_fns(pool), replicas=replicas, **kw)
    srv = RequestQueueServer(ex, max_batch=MB, max_wait_ms=2.0,
                             queue_depth=256, continuous=True)
    srv.start()
    try:
        outs = _drive_sessions(srv, pool, xs, lengths)
    finally:
        _within(srv.stop)
    st, xst = srv.stats(), ex.stats()
    _within(ex.close)
    pool.check_no_leaks()                        # every leave freed its slot
    for sess in range(n):
        rows: list = []
        for t in range(lengths[sess]):
            y = outs[sess][t]
            assert y is not None, f"session {sess} step {t} never resolved"
            assert torch.equal(y, _expected_step(rows, xs[sess, t])), \
                (sess, t)
            rows.append(xs[sess, t] + 1.0)
    total = sum(lengths)
    assert st["submitted"] == total and st["requests_served"] == total
    assert st["shed"] + st["expired"] + st["failed"] == 0
    assert st["release_errors"] == 0
    assert xst.out_of_order_retired == 0
    assert st["seam_joins"] == xst.seam_joins
    ps = pool.stats()
    assert ps["allocs"] == n and ps["frees"] == n  # never aliased or leaked
    assert ps["high_water"] <= pool.n_slots
    return st, xst


def test_randomized_continuous_stress_host_ground_truth():
    _stress()


def test_continuous_stress_survives_transient_faults():
    # transients on the replicated pure front stage retry on the sibling
    # (one quarantine allowed); the serial stateful stage is never faulted,
    # so retries must not double-append and outputs stay exact
    inj = FaultPlan().transient(0, at_calls=[1, 4, 9]).build()
    st, xst = _stress(fault_injector=inj, replicas=(2, 1, 1))
    assert inj.injected >= 1 and xst.retries + xst.quarantined >= 1


# --------------------------------------------------------------------------- #
# The slice as a whole: traced zoo decode served continuously on KV slots
# --------------------------------------------------------------------------- #
N_LAYERS, D_MODEL, FF, HEADS, VOCAB = 2, 32, 48, 4, 40
N_SESSIONS, STEPS = 6, 4


def decode_app(lib, params):
    """One new token ``x: [1, d]`` and its slot id through the zoo
    transformer's rows with per-layer decode attention, then the lm head:
    rmsnorm, attention_decode_<i>, add, rmsnorm, swiglu, add per layer."""
    def app(x, slot):
        for i, ly in enumerate(params["layers"]):
            h = lib.rmsnorm(x, ly["ln1"])
            a = getattr(lib, f"attention_decode_{i}")(
                h, slot, ly["wq"], ly["wk"], ly["wv"], ly["wo"])
            x = lib.add(x, a)
            h = lib.rmsnorm(x, ly["ln2"])
            f = lib.swiglu(h, ly["wi"], ly["wo_ffn"])
            x = lib.add(x, f)
        h = lib.rmsnorm(x, params["ln_f"])
        return lib.matmul(h, params["w_out"])
    app.__name__ = "decode"
    return app


def _decode_db(zoo, kvstate, params, **pool_kw):
    db = zoo.make_zoo_db()
    hd = D_MODEL // HEADS
    pools = [kvstate.KVSlotPool(N_SESSIONS, STEPS + 1,
                                {"k": (HEADS, hd), "v": (HEADS, hd)},
                                **pool_kw)
             for _ in params["layers"]]
    for i, pool in enumerate(pools):
        zoo.register_decode_modules(db, pool, n_heads=HEADS,
                                    name=f"attention_decode_{i}")
    return db, pools


def _serve_decode(srv, pools, firsts, w_out) -> list:
    """Greedy sessions: step t+1's token is the tied embedding of step t's
    argmax; session k arrives once k earlier steps completed.  Returns per
    session the (x, logits) of every step."""
    n = len(firsts)
    runs: list = [[] for _ in range(n)]
    slots: list = [None] * n
    xs = list(firsts)
    active: dict = {}

    def release(sess):
        for p in pools:
            p.free(slots[sess])

    def submit(sess):
        last = len(runs[sess]) == STEPS - 1
        active[sess] = srv.submit(
            xs[sess], slots[sess],
            on_finish=(lambda _r, s=sess: release(s)) if last else None)

    def admit(sess):
        ids = {p.alloc() for p in pools}
        assert len(ids) == 1                 # the layers' pools move together
        slots[sess] = ids.pop()
        submit(sess)

    admit(0)
    nxt, t_end = 1, time.monotonic() + DEADLINE_S
    while active:
        assert time.monotonic() < t_end, "decode sessions did not finish"
        done = [s for s, r in active.items() if r._event.is_set()]
        if not done:
            time.sleep(0.001)
            continue
        for sess in done:
            logits = active.pop(sess).wait(0)
            runs[sess].append((xs[sess], logits))
            xs[sess] = w_out[:, int(logits.argmax())][None]
            if len(runs[sess]) < STEPS:
                submit(sess)
            if nxt < n:
                admit(nxt)
                nxt += 1
    return runs


@pytest.mark.parametrize("continuous", [True, False])
def test_decode_slice_serves_kv_sessions_like_the_full_prefix(continuous):
    """The zoo transformer traced with per-layer decode attention, planned,
    served over KV slots; every step's logits within ``2e-4 · max|ref|``
    of the untraced app rerun over the whole prefix, and of the JAX
    package's incremental decode fed the same tokens."""
    import jax
    import jax.numpy as jnp

    from repro.models import zoo as jzoo
    from repro.runtime import kvstate as jkv
    from repro_torch.core import Frontend, Library, PipelineGenerator
    from repro_torch.core.placement import is_hw
    from repro_torch.models import zoo
    from repro_torch.runtime import kvstate

    jparams = jzoo.init_transformer_params(
        jax.random.PRNGKey(0), n_layers=N_LAYERS, d=D_MODEL, ff=FF,
        n_heads=HEADS, vocab=VOCAB)
    params = zoo.params_from_numpy(jparams, device="cpu")
    db, pools = _decode_db(zoo, kvstate, params, device="cpu")
    app = decode_app(Library(db), params)
    x0 = torch.zeros((1, D_MODEL))
    ir, _ = Frontend(db).trace(app, x0, torch.tensor(-1))
    assert all(p.allocs == 0 for p in pools)       # the dead row traced
    pipe = PipelineGenerator(db).generate(ir, policy="optimal", fuse=True,
                                          max_stages=3)
    stateful = [n for n in pipe.ir.nodes if n.state]
    assert len(stateful) == N_LAYERS
    assert all(n.serial_only and not is_hw(n.placement) for n in stateful)
    assert any(n.fn_key == "rmsnorm" and is_hw(n.placement)
               for n in pipe.ir.nodes)
    ex = pipe.executor(microbatch=MB, pad_microbatches=True, buckets=(MB,),
                       replicas=[1] * pipe.plan.n_stages,
                       open_groups=continuous, pad_token=(x0, -1),
                       max_in_flight=4 * MB)
    ex.warmup(x0, -1)
    gen = torch.Generator().manual_seed(3)
    firsts = [torch.randn((1, D_MODEL), generator=gen)
              for _ in range(N_SESSIONS)]
    srv = RequestQueueServer(ex, max_batch=MB, max_wait_ms=1.0,
                             queue_depth=64, continuous=continuous)
    srv.start()
    try:
        runs = _serve_decode(srv, pools, firsts, params["w_out"])
    finally:
        _within(srv.stop)
    st, xst = srv.stats(), ex.stats()
    _within(ex.close)
    for p in pools:
        p.check_no_leaks()
    assert st["requests_served"] == N_SESSIONS * STEPS
    assert st["failed"] + st["shed"] + st["expired"] == 0
    assert xst.out_of_order_retired == 0 and st["release_errors"] == 0

    plain = zoo.transformer_demo(Library(zoo.make_zoo_db()), params)
    jdb = jzoo.make_zoo_db()
    jpools = []
    for i in range(N_LAYERS):
        jp = jkv.KVSlotPool(1, STEPS + 1, {"k": (HEADS, D_MODEL // HEADS),
                                           "v": (HEADS, D_MODEL // HEADS)})
        jzoo.register_decode_modules(jdb, jp, n_heads=HEADS,
                                     name=f"attention_decode_{i}")
        jpools.append(jp)
    from repro.core import Library as JLibrary
    japp = decode_app(JLibrary(jdb), jparams)
    for run in runs:
        assert len(run) == STEPS
        xs = torch.cat([x for x, _ in run])
        jslot = {jp.alloc() for jp in jpools}.pop()
        for t, (x, logits) in enumerate(run):
            assert logits.shape == (1, VOCAB)
            ref = plain(xs[:t + 1])[-1:]
            scale = float(ref.abs().max())
            assert float((logits - ref).abs().max()) <= 2e-4 * scale, t
            jref = np.asarray(japp(jnp.asarray(x.numpy()), jslot))
            assert float(np.abs(logits.numpy() - jref).max()) \
                <= 2e-4 * float(np.abs(jref).max()), t
        for jp in jpools:
            jp.free(jslot)
