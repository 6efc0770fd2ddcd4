"""The port's inventory changes and fault scripts held to the JAX package's.

``Placement.unassigned``/``on``, ``InventoryDiff`` (through ``refresh``),
``drop``, ``reweighted``, ``homogeneous`` and ``describe`` render the same
text in both packages; ``slowdown``, ``random_transients`` (the same seeded
schedule), ``remap_devices`` and ``surviving`` behave alike; and
``ElasticPlanner.replan_on_inventory_change`` decides the same on
``DeviceInventory.host(4)``.  The lost-device scenario is held to its
invariants: every replica on the lost device is quarantined, the outputs
are right, nothing retires out of order, and the survivors' executor runs
clean.  Blocking calls run under a deadline.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro.runtime.faults as jfaults
import repro_torch.core as tcore
import repro_torch.runtime as trt
import repro_torch.runtime.faults as tfaults

torch.set_num_threads(1)

PKGS = {"jax": (jcore, jrt, jfaults), "torch": (tcore, trt, tfaults)}


def _within(fn, *args, timeout: float = 60.0):
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
# Placement and DeviceInventory, rendered alike
# --------------------------------------------------------------------------- #
def test_placement_unassigned_on_and_str_match_jax():
    for core in (tcore, jcore):
        p = core.Placement.unassigned()
        assert not p.is_assigned and str(p) == "unassigned"
    t = tcore.Placement.hw().on(2, replica=1, mesh_coord=(0, 1))
    j = jcore.Placement.hw().on(2, replica=1, mesh_coord=(0, 1))
    assert (str(t), t.key, t.mesh_coord) == (str(j), j.key, j.mesh_coord)
    assert str(t) == "hw@2.1"


def _inventories(core):
    inv = core.DeviceInventory.host(4)
    return {
        "drop": inv.drop({1}),
        "drop_two": inv.drop([0, 3]),
        "reweighted": inv.reweighted({1: 0.25, 3: 0.0}),
        "gpu": core.DeviceInventory.host(2, platform="gpu"),
    }


def test_inventory_derivations_describe_as_jax():
    t, j = _inventories(tcore), _inventories(jcore)
    for k in t:
        assert t[k].describe() == j[k].describe(), k
        assert t[k].homogeneous == j[k].homogeneous, k
    assert [s.ordinal for s in t["drop"].specs] == [0, 1, 2]
    assert t["reweighted"].spec(3).speed == pytest.approx(1e-6)
    assert not t["reweighted"].homogeneous and t["drop"].homogeneous
    for core in (tcore, jcore):
        inv = core.DeviceInventory.host(3)
        with pytest.raises(ValueError, match="every device"):
            inv.drop({0, 1, 2})
        with pytest.raises(IndexError):
            inv.drop({3})


@pytest.mark.parametrize("probe", ["same", "lose_0", "lose_1_3", "gain",
                                   "swap_platform"])
def test_refresh_diffs_by_identity_as_jax(probe):
    out = []
    for core in (tcore, jcore):
        inv = core.DeviceInventory.host(4)
        new = {"same": lambda: inv,
               "lose_0": lambda: inv.drop([0]),
               "lose_1_3": lambda: inv.drop([1, 3]),
               "gain": lambda: core.DeviceInventory.host(6),
               "swap_platform": lambda: core.DeviceInventory.host(
                   4, platform="gpu")}[probe]
        d = inv.refresh(probe=new)
        out.append((d.describe(), d.changed, d.lost, d.gained,
                    dict(d.survivors), len(d.old), len(d.new)))
    assert out[0] == out[1]
    if probe == "lose_0":
        assert out[0][4] == {1: 0, 2: 1, 3: 2}      # identity survives


def test_refresh_probes_the_card_without_a_probe():
    inv = tcore.DeviceInventory.host(1, platform="gpu")
    if torch.cuda.is_available():
        assert inv.refresh().new.spec(0).platform == "gpu"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            inv.refresh()


# --------------------------------------------------------------------------- #
# fault scripts
# --------------------------------------------------------------------------- #
def test_random_transients_schedule_matches_jax():
    def schedule(faults, **kw):
        inj = faults.FaultPlan().random_transients(**kw).build()
        fired = []
        for stage in (0, 3):
            for call in range(200):
                try:
                    inj.on_stage_call(stage)
                except faults.InjectedFault:
                    fired.append((stage, call))
        return fired, inj.injected

    for kw in (dict(rate=0.1, seed=42),
               dict(rate=0.5, seed=1, stages=[3]),
               dict(rate=0.3, seed=7, from_call=50)):
        t, j = schedule(tfaults, **kw), schedule(jfaults, **kw)
        assert t == j and t[1] > 0, kw
    for seed, stage, call in ((7, 0, 0), (42, 3, 199), (1, 12, 5)):
        assert tfaults._hash_draw(seed, stage, call) == \
            jfaults._hash_draw(seed, stage, call)
    for faults in (tfaults, jfaults):
        with pytest.raises(ValueError, match="rate"):
            faults.FaultPlan().random_transients(1.5, seed=1)
        with pytest.raises(ValueError, match="from_call"):
            faults.FaultPlan().random_transients(0.1, seed=1, from_call=-1)


def test_slowdown_window_counts_like_jax():
    slowed = []
    for faults in (tfaults, jfaults):
        inj = faults.FaultPlan().slowdown(0, 1.0, from_call=1,
                                          to_call=3).build()
        t0 = time.perf_counter()
        for _ in range(4):
            inj.on_stage_call(0)
        inj.on_stage_call(1)                    # other stages: no sleep
        assert (time.perf_counter() - t0) * 1e3 >= 2.0   # two 1 ms sleeps
        slowed.append((inj.slowed, inj.stats()["slowed"]))
        with pytest.raises(ValueError, match="extra_ms"):
            faults.FaultPlan().slowdown(0, -1.0)
    assert slowed[0] == slowed[1] == (2, 2)


def test_remap_and_surviving_match_jax():
    out = []
    for core, _, faults in (PKGS["torch"], PKGS["jax"]):
        inj = faults.FaultPlan().lose_device(1).lose_device(3).build()
        with pytest.raises(faults.DeviceLostError):
            inj.on_stage_call(0, device=1)
        inv = core.DeviceInventory.host(4)
        surv = inj.surviving(inv)
        inj.remap_devices({0: 0, 2: 1, 3: 2})
        with pytest.raises(faults.DeviceLostError) as e:
            inj.on_stage_call(0, device=2)
        out.append((surv.describe(), sorted(inj.lost_ordinals()),
                    dict(inj.plan.device_losses), e.value.ordinal,
                    inj.stats()))
        quiet = faults.FaultPlan().lose_device(1).build()
        assert quiet.surviving(inv) is inv      # scripted but never hit
    assert out[0] == out[1]


# --------------------------------------------------------------------------- #
# elastic recovery: loss -> quarantine -> refresh -> survivors re-plan
# --------------------------------------------------------------------------- #
def _chain(side, times=(1.0, 4.0), **kw):
    core, rt, _ = PKGS[side]
    keys = [f"f{i}" for i in range(len(times))]
    db = core.ModuleDatabase("faults-chain")
    for k in keys:
        db.register(k, software=(lambda x: x + 1.0) if side == "torch"
                    else (lambda x: np.asarray(x) + 1.0))
    ir = core.linear_ir("faults-chain", keys, list(times), io_shape=(4,))
    extra = {"device": "cpu"} if side == "torch" else {}
    return rt.ElasticPlanner(ir, db=db, **kw, **extra)


class _Stats:
    device_errors = {0: 2, 3: 1}


@pytest.mark.parametrize("budgets", [(7, 5), (None, None)])
def test_replan_on_inventory_change_decides_as_jax(budgets):
    """Same inventory, same profile (one straggling survivor, device
    errors): the same survivors plan, devices, speeds and verdict."""
    first, after = budgets
    out = []
    for side in ("torch", "jax"):
        core, _, _ = PKGS[side]
        inv = core.DeviceInventory.host(4)
        planner = _chain(side, inventory=inv)
        ex, _ = planner.executor_for(2, jit=False, worker_budget=first)
        prof = core.StageProfiler(2, min_samples=2)
        for _ in range(4):
            prof.record(0, 1.2)
            for d, ms in ((0, 4.0), (1, 4.0), (2, 9.0), (3, 4.0)):
                prof.record(1, ms, device=d)
        diff = inv.refresh(probe=lambda: inv.drop([0]))
        d = planner.replan_on_inventory_change(
            diff, profiler=prof, stats=_Stats(), jit=False,
            worker_budget=after)
        plan = planner.current_plan
        out.append((d.replanned, d.reason, d.widened, d.replicas,
                    round(d.old_bottleneck_ms, 12),
                    round(d.new_bottleneck_ms, 12), plan.stage_devices,
                    [list(s.device_speeds) for s in plan.stages],
                    planner.inventory.describe(), ex.replicas))
        ex.close()
        d.executor.close()
        same = planner.replan_on_inventory_change(
            planner.inventory.refresh(probe=lambda: planner.inventory))
        assert not same.replanned and same.reason == "inventory unchanged"
    assert out[0] == out[1]
    assert out[0][0] and out[0][2] and "lost [0]" in out[0][1]
    assert all(o < 3 for row in out[0][6] or [] for o in row)


def test_lost_device_scenario_holds_its_invariants():
    """The JAX test's scenario: the widened stage has two replicas pinned
    to the lost device (``host(4)`` and 5 replicas).  Its
    ``quarantined == 1`` is not copied: both replicas on the lost device
    fail and both are quarantined, which is the invariant held here —
    every replica on the lost device is quarantined, no other is."""
    inj = trt.FaultInjector()
    inv = tcore.DeviceInventory.host(4)
    planner = _chain("torch", inventory=inv, fault_injector=inj,
                     quarantine_after=1)
    prof = tcore.StageProfiler(2, min_samples=2)
    ex, _ = planner.executor_for(2, jit=False, profiler=prof, worker_budget=7)
    wide = max(range(2), key=lambda s: ex.replicas[s])
    target = ex.devices[wide][0]
    on_target = {(s, w) for s, row in enumerate(ex.devices)
                 for w, o in enumerate(row) if o == target}
    assert len(on_target) == 2 and all(s == wide for s, _ in on_target)
    toks = [torch.full((4,), float(i)) for i in range(10)]
    _within(ex.run, toks)

    inj.lose_device(target)
    got = _within(ex.run, toks)                   # quarantine absorbs it
    for i, g in enumerate(got):
        torch.testing.assert_close(g, torch.full((4,), i + 2.0))
    st = ex.stats()
    assert set(st.quarantined_replicas) == on_target
    assert st.quarantined == len(on_target)
    assert st.out_of_order_retired == 0 and st.tokens_failed == 0
    assert st.device_errors.get(target, 0) >= len(on_target)

    diff = inv.refresh(probe=lambda: inj.surviving(inv))
    assert diff.lost == (target,)
    d = planner.replan_on_inventory_change(diff, profiler=prof, stats=st,
                                           jit=False, worker_budget=5)
    assert d.replanned and d.widened and "lost" in d.reason
    assert d.executor.devices is not None
    assert all(o < 3 for row in d.executor.devices for o in row)
    got2 = _within(d.executor.run, toks)
    for i, g in enumerate(got2):
        torch.testing.assert_close(g, torch.full((4,), i + 2.0))
    st2 = d.executor.stats()
    assert st2.retries == st2.quarantined == st2.out_of_order_retired == 0
    d.executor.close()
    ex.close()
