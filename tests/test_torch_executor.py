"""The port's asynchronous executor held to the invariants of the JAX
package's ``tests/test_executor.py`` and ``tests/test_replicate.py``.

run / run_async / every executor mode equal ``BuiltPipeline.run`` (and the
JAX package's pipeline on the same numpy tokens, 1e-6); the token pool bound
holds; micro-batched and padded groups equal the per-token path; issued ==
retired; replicas retire in submission order even when they finish out of
order; an injected fault on a replicated stage is retried and quarantines
the replica.  Work is ordered by events and counts, never by sleeps.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
from repro_torch.core import (DeviceInventory, ExecutorClosed, Frontend,
                              Library, ModuleDatabase, PipelineExecutor,
                              PipelineGenerator, StageProfiler, SubmitError,
                              courier_offload, loop_batched)
from repro_torch.models import harris as mh
from repro_torch.runtime import FaultPlan, InjectedFault

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# graph fixtures (the reference's, in both packages)
# --------------------------------------------------------------------------- #
def _linear_db(pkg):
    db = pkg.ModuleDatabase("t")
    db.register("mul2", software=lambda x: x * 2.0)
    db.register("add1", software=lambda x: x + 1.0)
    db.register("sq", software=lambda x: x * x)
    db.register("tanh", software=torch.tanh if pkg is not jcore else jnp.tanh)
    return db


def _linear_app(lib):
    def app(x):
        return lib.tanh(lib.sq(lib.add1(lib.mul2(x))))
    return app


def _branch_db(pkg):
    db = pkg.ModuleDatabase("t")
    db.register("a", software=lambda x: x + 1.0)
    db.register("b", software=lambda x: x * 2.0)
    db.register("c", software=lambda x, y: x + y)    # consumes BOTH a and b
    db.register("d", software=lambda x: x - 0.5)
    return db


def _branch_app(lib):
    def app(x):
        u = lib.a(x)
        v = lib.b(u)
        return lib.d(lib.c(u, v))
    return app


GRAPHS = {"linear": (_linear_db, _linear_app),
          "branch": (_branch_db, _branch_app)}


def _pipe(kind="linear", n_threads=3, x=None, pkg=None):
    mkdb, mkapp = GRAPHS[kind]
    if pkg is jcore:
        db = mkdb(jcore)
        app = mkapp(jcore.Library(db))
        ir, _ = jcore.Frontend(db).trace(app, jnp.arange(4.0), profile=False)
        gen = jcore.PipelineGenerator(db)
    else:
        db = mkdb(__import__("repro_torch.core", fromlist=["core"]))
        app = mkapp(Library(db))
        x = torch.arange(4.0) if x is None else x
        ir, _ = Frontend(db).trace(app, x, profile=False)
        gen = PipelineGenerator(db)
    for n in ir.nodes:
        n.time_ms = 1.0
    return gen.generate(ir, n_threads=n_threads)


def _toks(n, width=4):
    return [np.full((width,), float(i + 1), np.float32) for i in range(n)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)


# --------------------------------------------------------------------------- #
# async run ≡ run ≡ the JAX package, in order
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("pool", [1, 2, 5])
def test_run_async_matches_run_and_jax(kind, pool):
    pipe = _pipe(kind)
    toks = _toks(7)
    want = pipe.run(_t(toks))
    _eq(pipe.run_async(_t(toks), max_in_flight=pool), want)
    jpipe = _pipe(kind, pkg=jcore)
    _eq(want, jpipe.run([jnp.asarray(a) for a in toks]))
    assert pipe.compile_count() == 0


@pytest.mark.parametrize("mode", [dict(stage_workers=True),
                                  dict(replicas="ones"),
                                  dict(replicas="twos", microbatch=2)])
def test_threaded_and_replicated_modes_match_run(mode):
    pipe = _pipe("branch")
    n = len(pipe.stage_fns)
    kw = dict(mode)
    if "replicas" in kw:
        kw["replicas"] = [1 if kw["replicas"] == "ones" else 2] * n
    toks = _t(_toks(9))
    ex = pipe.executor(**kw)
    try:
        _eq(ex.run(toks), pipe.run(toks))
        s = ex.stats()
        assert s.tokens_admitted == s.tokens_retired == 9
        assert s.out_of_order_retired == 0 and ex.in_flight == 0
    finally:
        ex.close()


# --------------------------------------------------------------------------- #
# bounded token pool
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pool", [1, 2, 3])
def test_bounded_pool_never_exceeded(pool):
    pipe = _pipe()
    ex = pipe.executor(max_in_flight=pool)
    ex.run(_t(_toks(9)))
    s = ex.stats()
    assert s.tokens_retired == 9
    assert 1 <= s.max_in_flight_seen <= pool
    assert ex.in_flight == 0


def test_max_in_flight_zero_rejected_everywhere():
    pipe = _pipe()
    pipe.max_in_flight = 0
    with pytest.raises(ValueError, match="max_in_flight"):
        pipe.run([torch.ones(4)])
    with pytest.raises(ValueError, match="max_in_flight"):
        pipe.executor()
    with pytest.raises(ValueError, match="max_in_flight"):
        PipelineExecutor(pipe.stage_fns, pipe.graph_inputs,
                         pipe.graph_outputs, max_in_flight=0)
    with pytest.raises(ValueError, match="max_in_flight"):
        pipe.run_async([torch.ones(4)], max_in_flight=-2)
    pipe.max_in_flight = None
    assert len(pipe.run([torch.ones(4)])) == 1


# --------------------------------------------------------------------------- #
# micro-batching
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_microbatch_path_equivalence(kind):
    pipe = _pipe(kind)
    toks = _t(_toks(10))
    ex = pipe.executor(max_in_flight=8, microbatch=4)
    _eq(ex.run(toks), pipe.run_sequential(toks))
    s = ex.stats()
    assert s.groups_admitted < s.tokens_admitted      # stacking happened
    assert s.max_in_flight_seen <= 8


def test_microbatch_splits_on_shape_mismatch():
    pipe = _pipe()
    toks = [torch.ones(4), torch.ones(4), torch.ones(3), torch.ones(3),
            torch.ones(4)]
    ex = pipe.executor(max_in_flight=8, microbatch=4)
    _eq(ex.run(toks), pipe.run_sequential(toks))
    assert ex.stats().groups_admitted == 3            # [4,4], [3,3], [4]


def test_padded_microbatch_equivalence_and_no_ragged_groups():
    pipe = _pipe("branch")
    toks = _t(_toks(7))                               # 7 % 3 != 0
    ex = pipe.executor(max_in_flight=6, microbatch=3, pad_microbatches=True)
    _eq(ex.run(toks), pipe.run_sequential(toks))
    s = ex.stats()
    assert s.tokens_admitted == s.tokens_retired == 7  # pads never count
    assert s.groups_admitted == 3                      # [3], [3], [1]


def test_buckets_pad_to_the_smallest_fit_and_warmup_counts_groups():
    calls = []
    db = ModuleDatabase("t")
    db.register("f", software=lambda x: calls.append(x.shape) or x + 1.0,
                batch_dims=True)
    lib = Library(db)
    ir, _ = Frontend(db).trace(lambda x: lib.f(x), torch.ones(4),
                               profile=False)
    ir.nodes[0].time_ms = 1.0
    pipe = PipelineGenerator(db).generate(ir, n_threads=1)
    assert pipe.stage_fns[0].batchable
    ex = pipe.executor(max_in_flight=8, microbatch=8, pad_microbatches=True,
                       buckets=(2, 4))
    assert ex.buckets == (2, 4, 8)
    assert ex.warmup(torch.ones(4)) == 4              # 1 single + 2, 4, 8
    calls.clear()
    _eq(ex.run(_t(_toks(3))), [t + 1.0 for t in _t(_toks(3))])
    assert calls == [(4, 4)]        # one call for the group, padded to 4


def test_batchable_stage_takes_the_group_in_one_call():
    seen = {"wide": [], "loop": []}
    db = ModuleDatabase("t")
    db.register("wide", software=lambda x: seen["wide"].append(x.shape)
                or x * 2.0, batch_dims=True)
    db.register("loop", software=lambda x: seen["loop"].append(x.shape)
                or x + 1.0)
    lib = Library(db)
    ir, _ = Frontend(db).trace(lambda x: lib.loop(lib.wide(x)), torch.ones(4),
                               profile=False)
    for n in ir.nodes:
        n.time_ms = 1.0
    pipe = PipelineGenerator(db).generate(ir, n_threads=1)
    seen["wide"].clear(), seen["loop"].clear()
    ex = pipe.executor(max_in_flight=4, microbatch=4)
    toks = _t(_toks(4))
    _eq(ex.run(toks), [t * 2.0 + 1.0 for t in toks])
    assert len(pipe.stage_fns) == 2   # wide and loop in their own stages
    assert seen["wide"] == [(4, 4)] and seen["loop"] == [(4,)] * 4
    b = loop_batched(lambda env: {"y": env["x"] + 1})
    assert torch.equal(b({"x": torch.zeros(3, 2)})["y"], torch.ones(3, 2))


# --------------------------------------------------------------------------- #
# admission errors
# --------------------------------------------------------------------------- #
def test_submit_many_rejects_bad_arity_before_admitting():
    pipe = _pipe()
    ex = pipe.executor(max_in_flight=4)
    with pytest.raises(ValueError, match="token 1"):
        ex.submit_many([(torch.ones(4),), (torch.ones(4), torch.ones(4))])
    assert ex.stats().tokens_admitted == 0 and ex.in_flight == 0


def test_submit_error_keeps_admitted_prefix():
    db = ModuleDatabase("t")
    db.register("dot4", software=lambda x: x @ torch.ones(4))
    db.register("add1", software=lambda x: x + 1.0)
    lib = Library(db)
    ir, _ = Frontend(db).trace(lambda x: lib.add1(lib.dot4(x)), torch.ones(4),
                               profile=False)
    for n in ir.nodes:
        n.time_ms = 1.0
    pipe = PipelineGenerator(db).generate(ir, n_threads=2)
    ex = pipe.executor(max_in_flight=4)
    with pytest.raises(SubmitError) as ei:
        ex.submit_many([torch.ones(4), torch.ones(3)])
    assert len(ei.value.handles) == 1
    _eq([ei.value.handles[0].result()], pipe.run_sequential([torch.ones(4)]))
    assert ex.in_flight == 0 and ex.stats().tokens_admitted == 1


def test_closed_executor_refuses_work():
    pipe = _pipe()
    ex = pipe.executor(replicas=[1] * len(pipe.stage_fns))
    ex.run(_t(_toks(2)))
    ex.close()
    with pytest.raises(ExecutorClosed):
        ex.submit(torch.ones(4))


# --------------------------------------------------------------------------- #
# replicas: in-order retirement, retry, quarantine
# --------------------------------------------------------------------------- #
def _gated_pipe(gate: threading.Event, done_second: threading.Event):
    """One stage whose call for token 1.0 waits until token 2.0's call ran:
    with two replicas, seq 1 finishes before seq 0."""
    def f(x):
        v = float(x.reshape(-1)[0])
        if v == 1.0:
            assert gate.wait(30.0), "the second replica never ran"
        if v == 2.0:
            gate.set()
            done_second.set()
        return x * 10.0
    db = ModuleDatabase("t")
    db.register("f", software=f)
    lib = Library(db)
    ir, _ = Frontend(db).trace(lambda x: lib.f(x), torch.zeros(4),
                               profile=False)
    ir.nodes[0].time_ms = 1.0
    return PipelineGenerator(db).generate(ir, n_threads=1)


def test_replicas_retire_in_order_when_they_finish_out_of_order():
    gate, second = threading.Event(), threading.Event()
    pipe = _gated_pipe(gate, second)
    ex = pipe.executor(replicas=[2])
    try:
        toks = _t(_toks(6))
        got = ex.run(toks)
        _eq(got, [t * 10.0 for t in toks])
        assert second.is_set()
        s = ex.stats()
        assert s.out_of_order_retired == 0
        assert s.tokens_admitted == s.tokens_retired == 6
        assert s.per_stage[0].issued == s.groups_admitted
    finally:
        ex.close()
    assert all(not t.is_alive() for t in ex._replica_threads)


def test_injected_fault_on_a_replicated_stage_retries_and_quarantines():
    pipe = _pipe("linear")
    n = len(pipe.stage_fns)
    inj = FaultPlan().transient(1, at_calls=[2]).build()
    prof = StageProfiler(n)
    ex = pipe.executor(replicas=[2] * n, fault_injector=inj, profiler=prof)
    try:
        toks = _t(_toks(8))
        _eq(ex.run(toks), pipe.run(toks))
        s = ex.stats()
        assert inj.injected == 1 and s.retries == 1 and s.quarantined == 1
        assert s.per_stage[1].errors == 1 and prof.error_count(1) == 1
        assert ex.healthy_replicas()[1] == 1
        assert s.tokens_failed == 0 and s.out_of_order_retired == 0
        assert s.tokens_admitted == s.tokens_retired == 8
    finally:
        ex.close()


def test_injected_fault_on_an_unreplicated_stage_errors_the_group():
    pipe = _pipe("linear")
    inj = FaultPlan().transient(0, at_calls=[1]).build()
    ex = pipe.executor(fault_injector=inj)
    h0 = ex.submit(torch.ones(4))
    with pytest.raises(SubmitError) as ei:
        ex.submit(torch.ones(4))
    assert isinstance(ei.value.__cause__, InjectedFault)
    _eq([h0.result()], pipe.run([torch.ones(4)]))
    assert ex.stats().tokens_admitted == ex.stats().tokens_retired == 1
    assert ex.in_flight == 0


def test_single_device_pinning_degrades_to_unpinned():
    pipe = _pipe("linear")
    n = len(pipe.stage_fns)
    inv = DeviceInventory.host(1, platform="cpu")
    assert inv.torch_device(0) == torch.device("cpu")
    ex = pipe.executor(replicas=[1] * n, devices=[[0]] * n, inventory=inv)
    try:
        assert ex._replica_devs is None
        toks = _t(_toks(3))
        _eq(ex.run(toks), pipe.run(toks))
    finally:
        ex.close()


def test_profiler_samples_every_group_on_the_cpu():
    pipe = _pipe("linear")
    n = len(pipe.stage_fns)
    prof = StageProfiler(n, sample_every=1, min_samples=1)
    ex = pipe.executor(profiler=prof)
    ex.warmup(torch.ones(4))
    assert all(prof.samples(k) == 0 for k in range(n))   # warmup not profiled
    ex.run(_t(_toks(3)))
    assert all(prof.samples(k) == 3 for k in range(n))
    assert prof.effective_period_ms() is not None


def test_map_async_equals_map_on_the_harris_offload():
    frames = mh.make_frames(3, 16, 24, seed=3, device="cpu")
    db = mh.make_harris_db(with_hw=True)
    off = courier_offload(mh.corner_harris_demo(Library(db)), frames[0], db=db)
    want = off.map(frames)
    _eq(off.map_async(frames, max_in_flight=2, microbatch=2), want)
    off.switch("original")
    _eq(off.map_async(frames), want)
    with pytest.raises(ValueError, match="microbatch"):
        off.map_async(frames, microbatch=0)
