"""The port's replan loop held to the JAX package's.

The same sleep-backed chains and the same traced pipeline as
``tests/test_replan.py`` and ``tests/test_replicate.py`` are built in both
packages; both packages' ``StageProfiler``s get the same injected stage times
(seeded), and ``ElasticPlanner.replan_from_profile`` must decide the same:
the verdict, the reason, the replicas, the defused nodes, the boundaries,
the gain and the bottlenecks (1e-9), and the IR it leaves behind
(``to_json``).  The invariants of the reference's tests hold on the port:
no flapping under noise, hysteresis, StageFn reuse, no defuse committed on
the keep path, and the hot swap with zero drops and identical results,
serial → replicated included.  Blocking calls run under a deadline, so a
hang fails instead of stalling the suite.
"""
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
import repro_torch.runtime as trt
from repro_torch.analysis.diagnostics import PlanVerificationError
from repro_torch.launch.serve import RequestQueueServer

torch.set_num_threads(1)

PKGS = {"jax": (jcore, jrt), "torch": (tcore, trt)}
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


# --------------------------------------------------------------------------- #
# fixtures: sleep-backed chains (tests/test_replan.py:18-53) in both packages
# --------------------------------------------------------------------------- #
DELAYS_MS: dict[str, float] = {}


def _impl(side, key):
    def sw(x):
        time.sleep(DELAYS_MS[key] / 1e3)
        return x + 1.0 if side == "torch" else np.asarray(x) + 1.0
    sw.__name__ = key
    return sw


def _planner(side, times, *, hw=(), fused_ms=None, **kw):
    """An ElasticPlanner over a linear chain f0..fn with the given model
    times; ``hw`` keys get an accelerated row, and ``fused_ms`` fuses the hw
    run at that modeled time (``fuse_adjacent_hw``)."""
    core, rt = PKGS[side]
    keys = [f"f{i}" for i in range(len(times))]
    DELAYS_MS.update({k: 0.0 for k in keys})
    db = core.ModuleDatabase("sim")
    for k in keys:
        impl = _impl(side, k)
        db.register(k, software=impl,
                    **({"accelerated": impl} if k in hw else {}))
    ir = core.linear_ir("sim", keys, list(times), io_shape=(4,))
    if fused_ms is not None:
        ir = core.fuse_adjacent_hw(ir, db, fused_cost_ms=lambda run: fused_ms)
    extra = {"device": "cpu"} if side == "torch" else {}
    return rt.ElasticPlanner(ir, db=db, **kw, **extra)


def _feed(prof, stage_times, n=8, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for k, t in enumerate(stage_times):
            prof.record(k, t * (1.0 + noise * rng.uniform(-1.0, 1.0)))


def _fused_name(planner):
    return next(n.name for n in planner.layer_ir.nodes if n.fused_from)


def _fused_stage_times(ms):
    def times(planner):
        name = _fused_name(planner)
        return [ms if name in s.node_names else 4.0
                for s in planner.current_plan.stages]
    return times


def _node_times(per_node):
    """Stage times of the planner's current plan from per-node times."""
    def times(planner):
        return [sum(per_node[planner.layer_ir.node(nn).fn_key]
                    for nn in s.node_names)
                for s in planner.current_plan.stages]
    return times


def _plan_times(planner):
    return [s.est_time_ms for s in planner.current_plan.stages]


# scenario: planner args, executor_for args, then a list of checks, each
# (stage times or a function of the planner, feed kwargs, profiler
# min_samples, replan kwargs); ``expect`` is the reference's verdicts
SCENARIOS = {
    "contradiction_rebalances": dict(
        times=[2.0] * 6, n_stages=3,
        checks=[([4.0, 12.0, 4.0], {}, 4, {"max_stages": 6})],
        expect=[True]),
    "then_no_flapping_under_noise": dict(
        times=[2.0] * 6, n_stages=3,
        checks=[([4.0, 12.0, 4.0], {}, 4, {"max_stages": 6})]
        + [(_plan_times, {"noise": 0.2, "seed": t}, 4, {"max_stages": 6})
           for t in range(5)],
        expect=[True] + [False] * 5),
    "hysteresis_blocks_marginal_gain": dict(
        times=[2.0] * 6, n_stages=3, planner_kw={"min_gain": 2.5},
        checks=[([6.0, 4.0, 4.0], {}, 4, {"max_stages": 6})],
        expect=[False]),
    "slo_pressure_waives_hysteresis": dict(
        times=[2.0] * 6, n_stages=3, planner_kw={"min_gain": 2.5},
        checks=[([6.0, 4.0, 4.0], {}, 4,
                 {"max_stages": 6, "slo_violation_rate": 0.2})],
        expect=[True]),
    "plan_unchanged": dict(
        times=[2.0] * 6, n_stages=3,
        checks=[([4.0, 4.0, 4.0], {}, 4, {})],
        expect=[False]),
    "insufficient_profile": dict(
        times=[2.0] * 6, n_stages=3,
        checks=[([4.0, 12.0, 4.0], {"n": 3}, 4, {"max_stages": 6})],
        expect=[False]),
    "min_samples_override_lowers_the_floor": dict(
        times=[2.0] * 6, n_stages=3,
        checks=[([4.0, 12.0, 4.0], {"n": 3}, 8,
                 {"max_stages": 6, "min_samples": 3})],
        expect=[True]),
    "widen_beats_rebalance_then_stable": dict(
        times=[0.5, 6.0, 0.5, 0.5], n_stages=4,
        checks=[(_node_times({"f0": 0.6, "f1": 6.5, "f2": 0.6, "f3": 0.6}),
                 {}, 4, {"worker_budget": 8})]
        + [(_plan_times, {"noise": 0.1, "seed": t}, 4, {"worker_budget": 8})
           for t in range(3)],
        expect=[True, False, False, False]),
    "defuses_contradicted_fused_node": dict(
        times=[2.0, 2.0, 4.0], hw=("f0", "f1"), fused_ms=1.0, n_stages=2,
        checks=[(_fused_stage_times(12.0), {}, 4, {"max_stages": 3})],
        expect=[True]),
    "keep_path_never_commits_a_defuse": dict(
        times=[2.0, 2.0], hw=("f0", "f1"), fused_ms=1.0, n_stages=1,
        planner_kw={"min_gain": 1e9},
        checks=[([12.0], {}, 4, {"max_stages": 2})] * 2,
        expect=[False, False]),
    "gradual_drift_against_the_model": dict(
        times=[2.0, 2.0, 4.0], hw=("f0", "f1"), fused_ms=1.0, n_stages=2,
        checks=[(_fused_stage_times(1.4), {}, 4, {"max_stages": 3}),
                (_fused_stage_times(1.9), {}, 4, {"max_stages": 3})],
        expect=[False, False]),
}


def _summary(d, planner) -> dict:
    return {"replanned": d.replanned, "reason": d.reason,
            "widened": d.widened, "replicas": d.replicas,
            "defused": list(d.defused),
            "old_bottleneck_ms": d.old_bottleneck_ms,
            "new_bottleneck_ms": d.new_bottleneck_ms, "gain": d.gain,
            "boundaries": [list(s.node_names)
                           for s in planner.current_plan.stages],
            "plan_replicas": planner.current_plan.replicas,
            "replans": planner.replans, "rebuilds": planner.rebuilds,
            "ir": json.loads(planner.layer_ir.to_json())}


def _run_scenario(side, name) -> list[dict]:
    sc = SCENARIOS[name]
    core, _ = PKGS[side]
    planner = _planner(side, sc["times"], hw=sc.get("hw", ()),
                       fused_ms=sc.get("fused_ms"),
                       **sc.get("planner_kw", {}))
    executors = [planner.executor_for(sc["n_stages"], jit=False)[0]]
    out = []
    try:
        for times, feed_kw, floor, kw in sc["checks"]:
            stage_times = times(planner) if callable(times) else times
            prof = core.StageProfiler(planner.current_plan.n_stages,
                                      min_samples=floor)
            _feed(prof, stage_times, **feed_kw)
            d = planner.replan_from_profile(prof, jit=False, **kw)
            if d.executor is not None:
                executors.append(d.executor)
            out.append(_summary(d, planner))
    finally:
        for ex in executors:
            ex.close()
    return out


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-9 * max(1.0, abs(a), abs(b))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replan_decides_as_jax(name):
    want = _run_scenario("jax", name)
    got = _run_scenario("torch", name)
    assert [d["replanned"] for d in got] == SCENARIOS[name]["expect"]
    for g, w in zip(got, want):
        for k in ("replanned", "reason", "widened", "replicas", "defused",
                  "boundaries", "plan_replicas", "replans", "rebuilds",
                  "ir"):
            assert g[k] == w[k], (k, g[k], w[k])
        for k in ("old_bottleneck_ms", "new_bottleneck_ms", "gain"):
            assert _close(g[k], w[k]), (k, g[k], w[k])


def test_scenario_invariants():
    """What each decision means, beyond agreeing with the reference."""
    d = _run_scenario("torch", "contradiction_rebalances")[0]
    assert d["gain"] >= 1.5 and d["new_bottleneck_ms"] < d["old_bottleneck_ms"]
    assert all(n["time_source"] == "profile" for n in d["ir"]["nodes"])
    h = _run_scenario("torch", "hysteresis_blocks_marginal_gain")[0]
    assert "below hysteresis threshold" in h["reason"]
    s = _run_scenario("torch", "slo_pressure_waives_hysteresis")[0]
    assert "SLO pressure" in s["reason"]
    w = _run_scenario("torch", "widen_beats_rebalance_then_stable")
    assert w[0]["widened"] and max(w[0]["replicas"]) > 1
    assert w[0]["new_bottleneck_ms"] < w[0]["old_bottleneck_ms"] / 1.5
    assert all(x["boundaries"] == w[0]["boundaries"] for x in w)
    assert w[-1]["replans"] == 1
    f = _run_scenario("torch", "defuses_contradicted_fused_node")[0]
    assert f["defused"] and not any(n["fused_from"] for n in f["ir"]["nodes"])
    k = _run_scenario("torch", "keep_path_never_commits_a_defuse")
    assert all(any(n["fused_from"] for n in s["ir"]["nodes"]) for s in k)
    # drift: 1.4x the model stays under the 1.5x margin; 1.9 ms is only
    # 1.36x the previous measurement but 1.9x the model, so it defuses
    g = _run_scenario("torch", "gradual_drift_against_the_model")
    assert not g[0]["defused"] and g[1]["defused"]


def test_replan_requires_db_and_a_current_plan():
    planner = _planner("torch", [2.0] * 6)
    prof = tcore.StageProfiler(3, min_samples=4)
    with pytest.raises(ValueError, match="executor_for"):
        planner.replan_from_profile(prof)
    ex, _ = planner.executor_for(3, jit=False)
    d = planner.replan_from_profile(prof)
    assert not d.replanned and "insufficient" in d.reason
    assert planner.replans == 0 and planner.replan_checks == 1
    ex.close()
    bare = trt.ElasticPlanner(planner.layer_ir, device="cpu")
    with pytest.raises(ValueError, match="ModuleDatabase"):
        bare.executor_for(2)


def test_planner_runs_on_the_card_unless_asked_for_the_cpu():
    ir = tcore.linear_ir("x", ["a"], [1.0])
    if torch.cuda.is_available():
        assert trt.ElasticPlanner(ir).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trt.ElasticPlanner(ir)
    assert trt.ElasticPlanner(ir, device="cpu").device.type == "cpu"


def test_planner_refuses_an_ir_traced_on_another_device():
    """The executors run where the traced weights are, so a planner on one
    device over weights captured on another raises instead of running
    there silently."""
    db = tcore.ModuleDatabase("dev")
    db.register("scale", software=lambda x, w: x * w)
    lib = tcore.Library(db)
    w = torch.full((4,), 2.0)
    ir, _ = tcore.Frontend(db).trace(lambda x: lib.scale(x, w),
                                     torch.ones(4))
    assert len(ir.captured) == 1
    assert trt.ElasticPlanner(ir, db=db, device="cpu").device.type == "cpu"
    ir.captured = {k: v.to("meta") for k, v in ir.captured.items()}
    with pytest.raises(ValueError, match="traced with .* on meta"):
        trt.ElasticPlanner(ir, db=db, device="cpu")


# --------------------------------------------------------------------------- #
# the profile and the cost model (write-back, contradiction, EMA)
# --------------------------------------------------------------------------- #
def test_apply_to_ir_writes_the_same_ir_as_jax():
    irs = {}
    for side, (core, _) in PKGS.items():
        ir = core.linear_ir("x", ["a", "b", "c", "d"], [1.0, 3.0, 1.0, 1.0])
        plan = core.partition_optimal(ir, max_stages=2)
        prof = core.StageProfiler(plan.n_stages, min_samples=1)
        _feed(prof, [8.0, 5.0][:plan.n_stages], n=4, noise=0.3, seed=3)
        replaced = prof.apply_to_ir(ir, plan)
        irs[side] = (json.loads(ir.to_json()), replaced)
        for s in plan.stages:
            nodes = [ir.node(nn) for nn in s.node_names]
            assert all(n.time_source == "profile" for n in nodes)
    assert irs["torch"] == irs["jax"]


def test_apply_to_ir_uniform_without_priors_and_clone_for_keeps_knobs():
    for side, (core, _) in PKGS.items():
        ir = core.linear_ir("x", ["a", "b"], [1.0, 1.0])
        plan = core.partition_optimal(ir, max_stages=1)
        for n in ir.nodes:
            n.time_ms = None
        prof = core.StageProfiler(1, alpha=0.5, window=7, sample_every=3,
                                  min_samples=2)
        prof.record(0, 6.0)
        assert prof.apply_to_ir(ir, plan) == {}          # below the floor
        prof.record(0, 6.0)
        assert prof.apply_to_ir(ir, plan) == {"a_0": 0.0, "b_1": 0.0}
        assert [n.time_ms for n in ir.nodes] == [3.0, 3.0]
        c = prof.clone_for(4)
        assert (c.n_stages, c.alpha, c.window, c.sample_every,
                c.min_samples) == (4, 0.5, 7, 3, 2) and c.samples(0) == 0


@pytest.mark.parametrize("margin", [1.0, 1.5, 2.0])
def test_measured_contradicts_agrees_over_a_grid(margin):
    vals = [None, 0.0, 0.3, 0.5, 0.67, 1.0, 1.49, 1.5, 2.0, 3.0, 15.0]
    for model in vals:
        for measured in vals:
            assert tcore.measured_contradicts(model, measured, margin) == \
                jcore.measured_contradicts(model, measured, margin), \
                (model, measured, margin)
    assert tcore.PROFILE_MARGIN == jcore.PROFILE_MARGIN
    for core in (tcore, jcore):
        with pytest.raises(ValueError):
            core.measured_contradicts(1.0, 2.0, margin=0.5)


@pytest.mark.parametrize("alpha", [0.25, 0.5])
def test_costmodel_observe_ema_agrees_and_supersedes_annotation(alpha):
    out = {}
    for side, (core, _) in PKGS.items():
        cm = core.CostModel(measure_alpha=alpha)
        cm.register("a", lambda shapes, dtypes, params: core.NodeCost(
            flops=1.0, bytes_rw=1.0))
        ema = [cm.observe("a", ms) for ms in (10.0, 20.0, 5.0, 7.5)]
        ir = core.linear_ir("x", ["a", "b"], [1.0, 2.0], io_shape=(4,))
        ir.nodes[0].time_ms = None
        cm.annotate(ir)
        out[side] = (ema, dict(cm.measured), ir.nodes[0].time_ms,
                     ir.nodes[0].time_source, ir.nodes[1].time_source)
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == "profile" and out["torch"][4] == "estimate"


def test_seam_fill_ema_agrees():
    out = {}
    for side, (core, _) in PKGS.items():
        p = core.StageProfiler(1, alpha=0.5)
        assert p.seam_fill() is None and "seam" not in p.snapshot()
        for filled, cap in ((1, 4), (4, 4), (2, 4), (3, 0)):
            p.record_seam(filled, cap)
        out[side] = (p.seam_fill(), p.snapshot()["seam"])
        p.reset()
        assert p.seam_fill() is None
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------------------- #
# the cost model's small gaps, against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("args", [
    dict(batch=2, q_len=128, kv_len=128, heads=8, head_dim=64),
    dict(batch=1, q_len=1, kv_len=4096, heads=16, head_dim=256, kv_heads=8,
         window=1024),
    dict(batch=4, q_len=64, kv_len=64, heads=10, head_dim=64,
         bytes_per_el=4)])
def test_attention_cost_and_arithmetic_intensity_match_jax(args):
    t, j = tcore.attention_cost(**args), jcore.attention_cost(**args)
    assert (t.flops, t.bytes_rw) == (j.flops, j.bytes_rw)
    assert t.arithmetic_intensity == j.arithmetic_intensity
    # f32 operands are timed at the f32 peak in the port
    assert t.f32_flops == (t.flops if args.get("bytes_per_el") == 4 else 0.0)


@pytest.mark.parametrize("cost", [
    dict(flops=1e12), dict(bytes_rw=1e9), dict(coll_bytes=1e9),
    dict(flops=1.0, bytes_rw=1e9, coll_bytes=1.0)])
def test_dominant_term_matches_jax_where_one_term_rules(cost):
    # the two packages time against different priors (H100 here, TPU v5e
    # there), so a cost whose terms are close may tip differently; where
    # one term dominates by orders of magnitude they must agree
    assert tcore.NodeCost(**cost).dominant() == \
        jcore.NodeCost(**cost).dominant()


@pytest.mark.parametrize("unfused_ms,fits", [(2.0, True), (2.0, False),
                                             (1e-9, True)])
def test_fusion_estimate_wins_matches_jax(unfused_ms, fits):
    wins = []
    for core, kw in ((tcore, "smem"), (jcore, "vmem")):
        parts = [core.NodeCost(flops=1e3, bytes_rw=1e6,
                               measured_ms=unfused_ms / 2)] * 2
        fe = core.fused_cost(parts, 1e5, **{f"{kw}_required": 10,
                                            f"{kw}_bytes": 100 if fits
                                            else 5})
        wins.append(fe.wins)
    assert wins[0] == wins[1] == (fits and unfused_ms > 1.0)


def test_total_workers_matches_jax():
    out = []
    for core in (tcore, jcore):
        ir = core.linear_ir("w", ["a", "b", "c", "d"], [0.5, 6.0, 0.5, 0.5])
        plan = core.partition_optimal(ir, max_stages=4)
        core.assign_replicas(plan, ir, worker_budget=8)
        out.append((plan.replicas, plan.total_workers))
    assert out[0] == out[1] and out[0][1] == sum(out[0][0]) <= 8


# --------------------------------------------------------------------------- #
# autoscale_from_ladder: widen instead of shed under sustained overload
# --------------------------------------------------------------------------- #
class _Ladder:
    def __init__(self, streak):
        self.level2_streak = streak
        self.resets = 0

    def reset_streak(self):
        self.level2_streak = 0
        self.resets += 1


def test_autoscale_from_ladder_decides_as_jax():
    out = {}
    for side, (core, _) in PKGS.items():
        planner = _planner(side, [0.5, 6.0, 0.5, 0.5])
        ex, _ = planner.executor_for(4, jit=False)
        prof = core.StageProfiler(4, min_samples=4)
        _feed(prof, [0.6, 6.5, 0.6, 0.6])
        low = _Ladder(2)
        assert planner.autoscale_from_ladder(
            low, prof, worker_budget=8, streak=3) is None
        assert low.resets == 0 and planner.replan_checks == 0
        high = _Ladder(3)
        d = planner.autoscale_from_ladder(high, prof, worker_budget=8,
                                          streak=3, jit=False)
        assert high.resets == 1 and high.level2_streak == 0
        with pytest.raises(ValueError, match="streak"):
            planner.autoscale_from_ladder(high, prof, worker_budget=8,
                                          streak=0)
        out[side] = _summary(d, planner)
        for e in (ex, d.executor):
            if e is not None:
                e.close()
    g, w = out["torch"], out["jax"]
    assert g["replanned"] and g["widened"]
    for k in ("replanned", "reason", "widened", "replicas", "boundaries"):
        assert g[k] == w[k], k
    assert _close(g["gain"], w["gain"])


# --------------------------------------------------------------------------- #
# executors the planner builds
# --------------------------------------------------------------------------- #
def _torch_chain_planner():
    db = tcore.ModuleDatabase("t")
    for k, f in (("a", lambda x: x + 1.0), ("b", lambda x: x * 2.0),
                 ("c", lambda x: x - 3.0), ("d", torch.tanh)):
        db.register(k, software=f)
    ir = tcore.linear_ir("x", ["a", "b", "c", "d"], [1.0, 1.0, 1.0, 5.0],
                         io_shape=(4,))
    return trt.ElasticPlanner(ir, db=db, device="cpu")


def test_replan_reuses_stagefns_for_unchanged_boundaries():
    planner = _torch_chain_planner()
    ex1, _ = planner.executor_for(2)
    assert [s.node_names for s in planner.current_plan.stages] == \
        [["a_0", "b_1", "c_2"], ["d_3"]]
    before = {tuple(s.node_names): f for s, f in
              zip(planner.current_plan.stages, ex1.stage_fns)}
    x = torch.arange(4.0)
    _within(ex1.run, [x])
    prof = tcore.StageProfiler(2, min_samples=4)
    _feed(prof, [9.0, 5.0])                        # stage 0 is 3x its plan
    d = planner.replan_from_profile(prof, max_stages=3)
    assert d.replanned
    stages = [tuple(s.node_names) for s in d.plan.stages]
    reused = d.executor.stage_fns[stages.index(("d_3",))]
    assert reused is before[("d_3",)] and reused.compiles == 0
    assert planner.stagefns_cached() >= len(stages)
    got = _within(d.executor.run, [x])[0]
    torch.testing.assert_close(got, torch.tanh((x + 1.0) * 2.0 - 3.0))
    ex1.close()
    d.executor.close()


def test_executor_for_caches_and_never_serves_a_closed_executor():
    planner = _planner("torch", [1.0] * 4)
    ex, rebuilt = planner.executor_for(2, jit=False, stage_workers=True)
    again, rebuilt2 = planner.executor_for(2, jit=False, stage_workers=True)
    assert rebuilt and again is ex and not rebuilt2
    # jit= changes nothing on the port's eager stages: no rebuild for it
    same, rebuilt3 = planner.executor_for(2, jit=True, stage_workers=True)
    assert same is ex and not rebuilt3 and planner.rebuilds == 1
    assert planner.boundaries(2) == [0, 2]
    _within(ex.run, [torch.zeros(4)])
    ex.close()
    ex2, rebuilt = planner.executor_for(2, jit=False, stage_workers=True)
    assert rebuilt and ex2 is not ex
    torch.testing.assert_close(_within(ex2.run, [torch.zeros(4)])[0],
                               torch.full((4,), 4.0))
    ex2.close()


def test_executor_for_worker_budget_builds_a_replicated_executor():
    planner = _planner("torch", [0.5, 6.0, 0.5, 0.5])
    ex, rebuilt = planner.executor_for(4, jit=False, worker_budget=8,
                                       max_in_flight=10)
    assert rebuilt and ex.replicas == planner.current_plan.replicas
    assert max(ex.replicas) > 1
    assert planner.current_plan.total_workers <= 8
    toks = [torch.full((4,), float(i)) for i in range(12)]
    got = _within(ex.run, toks)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, torch.full((4,), i + 4.0))
    assert ex.stats().out_of_order_retired == 0
    ex2, rebuilt2 = planner.executor_for(4, jit=False, worker_budget=8,
                                         max_in_flight=10)
    assert ex2 is ex and not rebuilt2
    ex.close()


def test_profiler_fed_by_stage_workers_reaches_the_replan():
    """Every stage call lands in the profile (counts), and the measured
    stage time is at least its injected sleep (a lower bound only)."""
    planner = _planner("torch", [2.0] * 6)
    DELAYS_MS.update({f"f{i}": 2.0 for i in range(6)})
    prof = tcore.StageProfiler(3, min_samples=4)
    ex, _ = planner.executor_for(3, max_in_flight=8, jit=False,
                                 profiler=prof, stage_workers=True)
    _within(ex.run, [torch.full((4,), float(i)) for i in range(12)])
    ex.close()
    assert [prof.samples(k) for k in range(3)] == [12, 12, 12]
    assert all(prof.measured_ms(k) >= 4.0 for k in range(3))
    d = planner.replan_from_profile(prof, jit=False)
    assert d.reason != "insufficient profile"
    if d.executor is not None:
        d.executor.close()


# --------------------------------------------------------------------------- #
# hot swap: zero drops, identical results (tests/test_replan.py:392-476)
# --------------------------------------------------------------------------- #
def _traced_pipe(side):
    core, _ = PKGS[side]
    db = core.ModuleDatabase("t")
    db.register("mul2", software=lambda x: x * 2.0)
    db.register("add1", software=lambda x: x + 1.0)
    db.register("sq", software=lambda x: x * x)
    db.register("tanh", software=torch.tanh if side == "torch" else jnp.tanh)
    lib = core.Library(db)

    def app(x):
        return lib.tanh(lib.sq(lib.add1(lib.mul2(x))))
    x0 = (torch.arange(4.0) if side == "torch" else jnp.arange(4.0))
    ir, _ = core.Frontend(db).trace(app, x0, profile=False)
    for n in ir.nodes:
        n.time_ms = 1.0
    return core.PipelineGenerator(db).generate(ir, n_threads=3)


def _tokens():
    return [np.full((4,), (i + 1) / 8.0, dtype=np.float32) for i in range(24)]


def _jax_want():
    pipe = _traced_pipe("jax")
    return [np.asarray(y) for y in
            pipe.run_sequential([jnp.asarray(t) for t in _tokens()])]


@pytest.mark.parametrize("replicated", [False, True])
def test_hot_swap_mid_stream_zero_drops_identical_results(replicated):
    pipe = _traced_pipe("torch")
    toks = [torch.from_numpy(t) for t in _tokens()]
    ex_a = pipe.executor(max_in_flight=6, microbatch=2, pad_microbatches=True)
    ex_a.warmup(toks[0])
    srv = RequestQueueServer(ex_a, max_batch=2, max_wait_ms=2.0).start()
    try:
        reqs = [srv.submit(t) for t in toks[:12]]      # in flight at the swap
        if replicated:
            ex_b = pipe.executor(microbatch=2, pad_microbatches=True,
                                 replicas=[1, 3, 1, 1][:len(pipe.stage_fns)])
        else:
            ex_b = pipe.executor(max_in_flight=4, microbatch=2,
                                 pad_microbatches=True)
        old = srv.swap_executor(ex_b, warm_args=(toks[0],), timeout=30.0)
        assert old is ex_a and srv.executor is ex_b and srv.swaps == 1
        reqs += [srv.submit(t) for t in toks[12:]]
        got = [r.wait(timeout=DEADLINE_S) for r in reqs]
    finally:
        _within(srv.stop)
    want = _jax_want()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    st = srv.stats()
    assert st["requests_served"] == 24 and st["swaps"] == 1
    assert st["failed"] == st["shed"] == st["expired"] == 0
    a, b = ex_a.stats(), ex_b.stats()
    assert a.tokens_retired + b.tokens_retired == 24
    assert a.tokens_admitted == a.tokens_retired
    assert b.tokens_admitted == b.tokens_retired
    assert b.out_of_order_retired == 0 and pipe.compile_count() == 0
    ex_a.close()
    ex_b.close()


def test_hot_swap_outside_serving_loop_is_immediate():
    pipe = _traced_pipe("torch")
    ex_a, ex_b = pipe.executor(), pipe.executor()
    srv = RequestQueueServer(ex_a)        # never started
    assert srv.swap_executor(ex_b) is ex_a
    assert srv.executor is ex_b and srv.swaps == 1


def test_hot_swap_verify_gate_keeps_the_old_executor():
    """A candidate whose plan fails verification never goes live."""
    ir = tcore.linear_ir("v", ["a", "b"], [1.0, 1.0], io_shape=(4,))
    ir.nodes[1].serial_only = True
    plan = tcore.partition_optimal(ir, max_stages=2)
    plan.stages[-1].replicas = 2                    # widened serial_only
    pipe = _traced_pipe("torch")
    ex_a, ex_b = pipe.executor(), pipe.executor()
    srv = RequestQueueServer(ex_a)
    with pytest.raises(PlanVerificationError) as e:
        srv.swap_executor(ex_b, plan=plan, ir=ir)
    assert "serial-only-widened" in e.value.rules
    assert srv.executor is ex_a and srv.swaps == 0
