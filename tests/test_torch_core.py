"""The port's planning core held against the JAX package.

The traced IR and the generated plan of the Harris demo are compared
through ``to_json`` (timings excluded: the port's roofline uses H100 priors,
the reference TPU v5e constants); JSON written by the JAX package loads
through the port's ``from_json``; verifier corruptions give the same rule
ids; and planning at the paper's full 1080x1920 frame fuses
cvtColor+cornerHarris in both packages.  The small functions of the IR,
the database, the tracer and the cost model (``Value.bit_depth``,
``is_linear_chain``, ``consumers_of``, ``ModuleDatabase.library`` and
``in``, ``current_mode``, ``NodeCost`` sums, ``CostModel.cost``,
``FusionEstimate.describe``) answer as their JAX counterparts do.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.core.partition as jpart
import repro.models.harris as jmh
import repro_torch.core as tcore
from repro.analysis import verify_plan as jax_verify_plan
from repro_torch.analysis import PlanVerificationError, check_plan, verify_plan
from repro_torch.core import (H100, SMEM_BYTES, CourierIR, DeviceInventory,
                              Frontend, Library, ModuleDatabase, NodeCost,
                              PipelineGenerator, PipelinePlan,
                              assign_replicas, device_class, fused_cost,
                              fused_working_set_bytes, linear_ir, measure_ms,
                              partition_optimal, partition_paper,
                              resolve_device, split_fused_node)
from repro_torch.core.ir import Node, dtype_name
from repro_torch.core.tracer import TraceBindingError
from repro_torch.models import harris as mh

torch.set_num_threads(1)

TIMING_KEYS = {"time_ms", "t_start", "t_end"}


def _frame(h, w, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)
            * 255).astype(np.float32)


def _ir_json(ir) -> dict:
    d = json.loads(ir.to_json())
    for n in d["nodes"]:
        for k in TIMING_KEYS:
            n.pop(k)
    return d


def _plan_json(plan) -> dict:
    d = json.loads(plan.to_json())
    for s in d["stages"]:
        s.pop("est_time_ms")
        s.pop("xfer_in_ms")
    return d


def _generate(core, models, frame, *, fuse, policy):
    """Trace the Harris demo without a profile and generate its pipeline,
    the one sw row (normalize) costed by a CostModel."""
    db = models.make_harris_db(with_hw=True)
    app = models.corner_harris_demo(core.Library(db))
    ir, _ = core.Frontend(db).trace(app, frame, profile=False)
    cm = core.CostModel()
    cm.register("normalize", models._c_norm)
    pipe = core.PipelineGenerator(db, cost_model=cm).generate(
        ir, n_threads=2, policy=policy, fuse=fuse)
    return pipe.ir, pipe.plan


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("policy", ["paper", "optimal"])
def test_ir_and_plan_equal_to_jax(fuse, policy):
    frame = _frame(32, 64)
    jir, jplan = _generate(jcore, jmh, jnp.asarray(frame), fuse=fuse,
                           policy=policy)
    tir, tplan = _generate(tcore, mh, torch.from_numpy(frame), fuse=fuse,
                           policy=policy)
    assert _ir_json(tir) == _ir_json(jir)
    assert _plan_json(tplan) == _plan_json(jplan)
    fused = [n.fn_key for n in tir.nodes if n.fused_from]
    assert fused == (["cvtColor+cornerHarris"] if fuse else [])


def test_jax_written_ir_and_plan_load_in_port():
    jir, jplan = _generate(jcore, jmh, jnp.asarray(_frame(16, 24)),
                           fuse=True, policy="optimal")
    tir = CourierIR.from_json(jir.to_json())
    tplan = PipelinePlan.from_json(jplan.to_json())
    assert json.loads(tir.to_json()) == json.loads(jir.to_json())
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json())
    assert verify_plan(tir, tplan, db=mh.make_harris_db()) == []


def test_full_width_planning_fuses_in_both_packages():
    """At the paper's 1080x1920 frame the pair fuses in both packages.

    The TPU gate reckons a full-width row slab (460,800 B here), which
    would spill one H100 block's 232,448 B of shared memory; the port's
    gate reckons its own kernel's 2-D tile, which fits at any width.
    """
    frame = _frame(1080, 1920)
    keys = {}
    for name, core, models, x in (
            ("jax", jcore, jmh, jnp.asarray(frame)),
            ("torch", tcore, mh, torch.from_numpy(frame))):
        db = models.make_harris_db(with_hw=True)
        ir, _ = core.Frontend(db).trace(
            models.corner_harris_demo(core.Library(db)), x, profile=False)
        core.assign_placements(ir, db)
        run = ir.nodes[:2]
        if name == "jax":
            assert jpart.fused_working_set_bytes(ir, run) == 460_800 > SMEM_BYTES
        else:
            assert fused_working_set_bytes(ir, run) <= SMEM_BYTES
        fused = core.fuse_adjacent_hw(ir, db, fused_cost_ms="model")
        keys[name] = [n.fn_key for n in fused.nodes if n.fused_from]
    assert keys == {"jax": ["cvtColor+cornerHarris"],
                    "torch": ["cvtColor+cornerHarris"]}


# --------------------------------------------------------------------------- #
# verifier: the same corruptions give the same rule ids
# --------------------------------------------------------------------------- #
def _linear(core):
    ir = core.linear_ir("t", ["a", "b", "c", "d"], [1.0, 4.0, 2.0, 1.0],
                        io_shape=(64, 96))
    return ir, core.partition_optimal(ir, max_stages=3)


def _mut_drop_producer(ir, plan):
    ir.nodes = [n for n in ir.nodes if n.name != "b_1"]
    for s in plan.stages:
        s.node_names = [nn for nn in s.node_names if nn != "b_1"]


CORRUPTIONS = {
    "drop-producer": _mut_drop_producer,
    "reverse-stages": lambda ir, plan: setattr(
        plan, "stages", list(reversed(plan.stages))),
    "duplicate-node": lambda ir, plan: plan.stages[-1].node_names.append("a_0"),
    "phantom-node": lambda ir, plan: plan.stages[0].node_names.append("ghost_9"),
    "missing-output": lambda ir, plan: setattr(ir, "graph_outputs",
                                               ["never_made"]),
    "phantom-xfer": lambda ir, plan: setattr(plan.stages[0], "xfer_in_ms", 1.5),
    "zero-replicas": lambda ir, plan: setattr(plan.stages[1], "replicas", 0),
    "nan-stage-time": lambda ir, plan: setattr(plan.stages[0], "est_time_ms",
                                               float("nan")),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_gives_jax_rule_ids(name):
    rules = {}
    for pkg, core, verify in (("jax", jcore, jax_verify_plan),
                              ("torch", tcore, verify_plan)):
        ir, plan = _linear(core)
        assert verify(ir, plan) == []
        CORRUPTIONS[name](ir, plan)
        rules[pkg] = sorted({(d.rule, d.severity) for d in verify(ir, plan)})
    assert rules["torch"] == rules["jax"] and rules["torch"]


def _fused_ir(rows, cols, *extra):
    ir = CourierIR("fz")
    for v in ("d0", "d1", "d2"):
        ir.add_value(v, (rows, cols, *extra), "float32")
    ir.add_node(Node(
        name="a_0+b_1", fn_key="a+b", inputs=["d0"], outputs=["d2"],
        time_ms=1.0, placement="hw", fused_from=["a_0", "b_1"],
        fused_input_shapes=[[(rows, cols, *extra)]] * 2,
        fused_params=[{}, {}], fused_part_inputs=[["d0"], ["d1"]],
        fused_part_outputs=[["d1"], ["d2"]]))
    ir.graph_inputs, ir.graph_outputs = ["d0"], ["d2"]
    return ir, partition_optimal(ir, max_stages=1)


def test_smem_spill_rule_reckons_the_tile_not_the_width():
    ir, plan = _fused_ir(4096, 4_000_000)       # the JAX test's VMEM spill
    assert verify_plan(ir, plan) == []          # a 2-D tile fits at any width
    ir, plan = _fused_ir(64, 96, 4096)          # deep pixels do not
    diags = verify_plan(ir, plan)
    assert [d.rule for d in diags] == ["smem-spill"]
    with pytest.raises(PlanVerificationError) as e:
        check_plan(ir, plan)
    assert e.value.rules == ["smem-spill"]


# --------------------------------------------------------------------------- #
# partitioners and replication on the paper's own profile
# --------------------------------------------------------------------------- #
PAPER_KEYS = ["cvtColor", "cornerHarris", "normalize", "convertScaleAbs"]
PAPER_MS = [39.8, 13.6, 80.2, 13.2]             # Table I, off-loaded


@pytest.mark.parametrize("n_threads", [1, 2, 3])
def test_partitioners_cut_like_jax(n_threads):
    jir = jcore.linear_ir("p", PAPER_KEYS, PAPER_MS)
    tir = linear_ir("p", PAPER_KEYS, PAPER_MS)
    for jp, tp in ((jcore.partition_paper(jir, n_threads),
                    partition_paper(tir, n_threads)),
                   (jcore.partition_optimal(jir, max_stages=n_threads + 1),
                    partition_optimal(tir, max_stages=n_threads + 1))):
        assert json.loads(tp.to_json()) == json.loads(jp.to_json())
        assert tp.bottleneck_ms == jp.bottleneck_ms


def test_assign_replicas_like_jax():
    jir = jcore.linear_ir("p", PAPER_KEYS, PAPER_MS)
    tir = linear_ir("p", PAPER_KEYS, PAPER_MS)
    jp = jcore.assign_replicas(jcore.partition_optimal(jir, max_stages=3), jir,
                               worker_budget=6,
                               inventory=jcore.DeviceInventory.host(4))
    tp = assign_replicas(partition_optimal(tir, max_stages=3), tir,
                         worker_budget=6, inventory=DeviceInventory.host(4))
    assert _plan_json(tp) == _plan_json(jp)
    assert tp.replicas == jp.replicas and max(tp.replicas) > 1


def test_split_fused_node_round_trips():
    tir, _ = _generate(tcore, mh,
                       torch.from_numpy(_frame(16, 24)), fuse=True,
                       policy="paper")
    fused = next(n for n in tir.nodes if n.fused_from)
    back = split_fused_node(tir, fused.name)
    assert [n.fn_key for n in back.nodes] == PAPER_KEYS
    assert back.nodes[0].inputs == fused.inputs


# --------------------------------------------------------------------------- #
# cost model, dtypes, devices
# --------------------------------------------------------------------------- #
def test_cost_model_defaults_to_h100_priors():
    assert device_class("gpu") is H100 and device_class("unknown") is H100
    assert NodeCost(bytes_rw=3.35e12).time_ms() == pytest.approx(1000.0)
    assert NodeCost(flops=989e12).time_ms() == pytest.approx(1000.0)
    fe = fused_cost([NodeCost(bytes_rw=8.0)], 1.0, smem_required=SMEM_BYTES + 1)
    assert not fe.fits_smem and fe.fused_ms == float("inf")
    assert measure_ms(lambda x: {"out": (x * 2,)}, torch.ones(4), iters=2) > 0


def test_f32_work_is_timed_at_the_f32_peak():
    """The serving group's fused rmsnorm + lm head (K6), [2048, 8192] @
    [8192, 102400] in f32, is timed at the f32 peak (67 TFLOP/s), not the
    bf16 tensor cores' 989: at least the 51.28 ms of its f32 products."""
    from repro_torch.core import matmul_cost
    from repro_torch.kernels.ops import _c_fused

    k6 = _c_fused([(2048, 8192), (8192,), (8192, 102400)], None, None)
    assert k6.f32_flops == k6.flops
    assert k6.time_ms() >= 2.0 * 2048 * 8192 * 102400 / 67e12 * 1e3 >= 51.28
    bf16 = matmul_cost(2048, 102400, 8192, bytes_per_el=2)
    assert bf16.f32_flops == 0.0
    assert bf16.time_ms() == pytest.approx(2.0 * 2048 * 8192 * 102400
                                           / 989e12 * 1e3)
    mixed = NodeCost(flops=989e12 + 67e12, f32_flops=67e12)
    assert mixed.time_ms() == pytest.approx(2000.0)


def _lm_head_ir(core, rows):
    """The traced transformer's lm head at DeepSeek-67B widths, f32: the
    final rmsnorm of [rows, 8192] and its product with [8192, 102400]."""
    ir = core.CourierIR("lm_head")
    for name, shape in (("x", (rows, 8192)), ("g", (8192,)),
                        ("h", (rows, 8192)), ("w", (8192, 102400)),
                        ("y", (rows, 102400))):
        ir.add_value(name, shape, "float32")
    ir.graph_inputs, ir.graph_outputs = ["x", "g", "w"], ["y"]
    ir.add_node(core.Node(name="rmsnorm_4", fn_key="rmsnorm",
                          inputs=["x", "g"], outputs=["h"]))
    ir.add_node(core.Node(name="matmul_0", fn_key="matmul",
                          inputs=["h", "w"], outputs=["y"]))
    return ir


@pytest.mark.parametrize("rows,fused_ms,part_ms,gate,fuses", [
    # a served request (the plan's traced shape): the gate ties on the HBM
    # term, as the JAX package's (4.373548 against 4.373548 ms) does
    (512, 12.821048, 12.820798, (1.0692345, 1.0692345), True),
    # the serving group's rows: the compute term decides, in both packages
    # (JAX: 17.441832 against 17.441492 ms)
    (2048, 51.284193, 51.283192, (3.4742578, 3.4741899), False)])
def test_fusion_gate_prices_f32_at_the_f32_peak_and_decides_as_jax(
        rows, fused_ms, part_ms, gate, fuses):
    """The fused rmsnorm + lm head (K6) is priced with its f32 share (from
    its values' dtypes) at the f32 peak, as its parts are; the gate decides
    on both sides at one peak, as the JAX package's gate does, and takes
    its decision."""
    from repro.models import zoo as jzoo
    from repro_torch.models import zoo as tzoo

    ir = _lm_head_ir(tcore, rows)
    db = tzoo.make_zoo_db()
    tcore.assign_placements(ir, db)
    assert tcore.partition.f32_flops(ir, ir.nodes[1]) == ir.nodes[1].flops
    fe = tcore.make_model_fused_cost(ir, db)(ir.nodes)
    assert fe.cost.f32_flops == fe.cost.flops
    assert fe.fused_ms == pytest.approx(fused_ms, rel=1e-7)
    assert max(n.time_ms for n in ir.nodes) == pytest.approx(part_ms,
                                                             rel=1e-7)
    assert tcore.partition.one_peak_gate_ms(fe, ir.nodes) == pytest.approx(
        gate, rel=1e-7)
    out = tcore.fuse_adjacent_hw(ir, db, fused_cost_ms="model")
    jir = _lm_head_ir(jcore, rows)
    jcore.assign_placements(jir, jzoo.make_zoo_db())
    jout = jcore.fuse_adjacent_hw(jir, jzoo.make_zoo_db(),
                                  fused_cost_ms="model")
    names = [n.name for n in out.nodes]
    assert names == [n.name for n in jout.nodes]
    assert names == (["rmsnorm_4+matmul_0"] if fuses
                     else ["rmsnorm_4", "matmul_0"])
    if fuses:                     # the fused node carries its f32 price
        assert out.nodes[0].time_ms == pytest.approx(fused_ms, rel=1e-7)


@pytest.mark.parametrize("provider,shapes", [
    ("_c_attn", [(4096, 8192)]),
    ("_c_swiglu", [(4096, 8192), (8192, 2 * 22016)]),
    ("_c_moe", [(4096, 8192), (8192, 8), (8, 8192, 2048)])])
def test_summed_f32_products_keep_the_f32_peak(provider, shapes):
    """The zoo's providers that add f32 products together are timed at the
    f32 peak as a whole."""
    from repro_torch.models import zoo

    c = getattr(zoo, provider)(shapes, None, None)
    assert c.f32_flops == c.flops > 0
    assert c.time_ms() == pytest.approx(max(c.flops / 67e12,
                                            c.bytes_rw / 3.35e12) * 1e3)


def test_dtype_names_are_numpy_names():
    assert dtype_name(torch.float32) == "float32"
    assert dtype_name(torch.bfloat16) == "bfloat16"
    assert dtype_name(np.dtype("uint8")) == "uint8"
    ir = CourierIR()
    assert ir.add_value("b", (2, 3), torch.bfloat16).nbytes == 12
    with pytest.raises(ValueError):
        dtype_name("torch.quint8")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert DeviceInventory.detect().specs[0].platform == "gpu"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            DeviceInventory.detect()
    assert resolve_device("cpu").type == "cpu"
    assert [s.platform for s in DeviceInventory.detect(device="cpu")] == ["cpu"]


# --------------------------------------------------------------------------- #
# tracer: the JAX package's bug classes, and torch's in-place aliasing
# --------------------------------------------------------------------------- #
def _tdb() -> ModuleDatabase:
    db = ModuleDatabase("t")
    db.register("mul2", software=lambda x: x * 2.0)
    db.register("add", software=lambda x, y: x + y)
    db.register("scale_", software=lambda x: x.mul_(3.0))   # in place

    def scale(x, *, w):
        return x * w
    db.register("scale", software=scale)

    def shift(x, k, y):
        return x * k + y
    db.register("shift", software=shift)

    def cat(*xs):
        return torch.cat([x.reshape(-1) for x in xs])
    db.register("cat", software=cat)
    return db


def _pipe(fn, *args, max_stages=2):
    db = _tdb()
    lib = Library(db)

    def app(*a):
        return fn(lib, *a)
    ir, out = Frontend(db).trace(app, *args)
    pipe = PipelineGenerator(db).generate(ir, policy="optimal",
                                          max_stages=max_stages)
    return ir, out, pipe


X = torch.arange(6.0).reshape(2, 3)
Y = torch.full((2, 3), 0.5)


def test_constant_and_passthrough_outputs_are_registered():
    const = torch.full((2, 3), 7.0)
    ir, _, pipe = _pipe(lambda lib, x: (lib.mul2(x), const, x), X)
    assert len(ir.graph_outputs) == 3
    assert ir.graph_outputs[1] in ir.captured
    assert ir.graph_outputs[2] in ir.graph_inputs
    y, c, x2 = pipe(X)
    assert torch.equal(y, X * 2) and torch.equal(c, const)
    assert torch.equal(x2, X)


def test_keyword_and_shifted_arrays_replay_by_name():
    ir, _, pipe = _pipe(lambda lib, x, w: lib.scale(x, w=w), X, Y)
    assert ir.nodes[0].input_kw == [None, "w"]
    assert torch.equal(pipe(X, Y), X * Y)
    ir, _, pipe = _pipe(lambda lib, x, y: lib.shift(x, 3.0, y), X, Y)
    assert ir.nodes[0].params == {"k": 3.0}
    assert ir.nodes[0].input_kw == [None, "y"]
    assert torch.equal(pipe(X, Y), X * 3.0 + Y)
    with pytest.raises(TraceBindingError):
        _pipe(lambda lib, x, y: lib.cat(x, 2.0, y), X, Y)


def test_closure_captured_weight_becomes_a_captured_input():
    w = torch.full((2, 3), 4.0)
    ir, _, pipe = _pipe(lambda lib, x: lib.add(lib.mul2(x), w), X)
    (cap,) = ir.captured
    assert cap in ir.graph_inputs and pipe.graph_inputs == ["d0"]
    assert torch.equal(pipe(X), X * 2 + w)


def test_in_place_op_takes_the_alias_path():
    """``x.mul_`` returns its operand itself: the tracer mints a fresh value
    and an identity edge rather than one value read and written by a node."""
    ir, out, pipe = _pipe(lambda lib, x: lib.add(lib.scale_(lib.mul2(x)), x),
                          X.clone())
    scale_node = ir.node("scale__0")
    assert scale_node.inputs != scale_node.outputs
    assert ir.values[scale_node.outputs[0]].producer == "scale__0"
    assert ir.node("add_0").inputs[0] == scale_node.outputs[0]
    ir.validate()
    assert torch.equal(pipe(X.clone()), X * 6 + X)


# --------------------------------------------------------------------------- #
# the small core functions the port took last (ir, database, tracer,
# costmodel), each against its JAX counterpart
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
def test_value_bit_depth_matches_jax(dtype):
    got = CourierIR().add_value("v", (2, 3), dtype).bit_depth
    assert got == jcore.CourierIR().add_value("v", (2, 3), dtype).bit_depth
    assert CourierIR().add_value("b", (1,), torch.bfloat16).bit_depth == 16


def _branchy(core, branch: bool):
    """a -> f -> b -> g -> c, and (``branch``) h reading b as well."""
    ir = core.CourierIR("branchy")
    for v in "abcd":
        ir.add_value(v, (4,), "float32")
    ir.graph_inputs.append("a")
    ir.add_node(core.Node("f", "f", inputs=["a"], outputs=["b"]))
    ir.add_node(core.Node("g", "g", inputs=["b"], outputs=["c"]))
    ir.add_node(core.Node("h", "h", inputs=["b" if branch else "c"],
                          outputs=["d"]))
    return ir


@pytest.mark.parametrize("branch", [False, True])
def test_linear_chain_and_consumers_of_match_jax(branch):
    j, t = _branchy(jcore, branch), _branchy(tcore, branch)
    assert t.is_linear_chain() == j.is_linear_chain() == (not branch)
    for jn, tn in zip(j.nodes, t.nodes):
        assert [n.name for n in t.consumers_of(tn)] == \
            [n.name for n in j.consumers_of(jn)]
    jir, _ = _generate(jcore, jmh, jnp.asarray(_frame(8, 8)), fuse=False,
                       policy="paper")
    tir, _ = _generate(tcore, mh, torch.from_numpy(_frame(8, 8)),
                       fuse=False, policy="paper")
    assert tir.is_linear_chain() == jir.is_linear_chain() is True


def test_module_database_library_and_contains_match_jax():
    for core in (jcore, tcore):
        db = core.ModuleDatabase("t")

        @db.library("double", tags=("sw",))
        def double(x):
            return x * 2

        assert double(3) == 6                        # the function returned
        assert "double" in db and "halve" not in db
        assert db.lookup("double").software is double
        assert db.lookup("double").tags == ("sw",)


def test_current_mode_matches_jax():
    from types import SimpleNamespace

    seen = {}
    for name, core, arr in (("jax", jcore, jnp.ones(3)),
                            ("port", tcore, torch.ones(3))):
        db = core.ModuleDatabase("modes")
        modes = []

        @db.library("probe")
        def probe(x):
            modes.append(core.current_mode()
                         if name == "port" else _jax_mode())
            return x + 1

        lib = core.Library(db)
        lib.probe(arr)
        core.Frontend(db).trace(lambda x: lib.probe(x), arr, profile=False)
        with core.deploy(SimpleNamespace(resolve=lambda e: e.software)):
            lib.probe(arr)
        seen[name] = modes
    assert seen["port"] == seen["jax"] == ["direct", "trace", "deploy"]
    assert tcore.current_mode() == "direct"


def _jax_mode():
    from repro.core.tracer import current_mode

    return current_mode()


@pytest.mark.parametrize("measured", [(None, None), (1.5, None),
                                      (None, 2.5), (1.5, 2.5)])
def test_node_cost_sum_charges_the_estimate_as_jax(measured):
    """A sum with one measured part is measured; the part without a
    profile adds its roofline time (each package's own device), not 0."""
    ma, mb = measured
    terms = [dict(flops=2e12, bytes_rw=3e9, coll_bytes=1e6),
             dict(flops=5e11, bytes_rw=8e9, coll_bytes=0.0)]
    js = jcore.NodeCost(**terms[0], measured_ms=ma) + \
        jcore.NodeCost(**terms[1], measured_ms=mb)
    a = NodeCost(**terms[0], measured_ms=ma, f32_flops=1e12)
    b = NodeCost(**terms[1], measured_ms=mb)
    ts = a + b
    assert (ts.flops, ts.bytes_rw, ts.coll_bytes) == \
        (js.flops, js.bytes_rw, js.coll_bytes)
    assert ts.f32_flops == 1e12
    assert (ts.measured_ms is None) == (js.measured_ms is None) == \
        (ma is None and mb is None)
    if ts.measured_ms is not None:
        assert ts.measured_ms == pytest.approx(a.time_ms() + b.time_ms())
    if (ma is None) != (mb is None):                    # the estimate counts
        assert ts.measured_ms > (ma or 0.0) + (mb or 0.0)
    if ma is not None and mb is not None:
        assert ts.measured_ms == js.measured_ms == ma + mb


def test_cost_model_cost_matches_jax():
    for core in (jcore, tcore):
        cm = core.CostModel()
        cm.register("mm", lambda m, n, k: core.matmul_cost(m, n, k))
        got = cm.cost("mm", 64, 32, 16)
        want = core.matmul_cost(64, 32, 16)
        assert (got.flops, got.bytes_rw) == (want.flops, want.bytes_rw)
        with pytest.raises(KeyError, match="no cost provider for 'nope'"):
            cm.cost("nope")


@pytest.mark.parametrize("spills", [False, True])
def test_fusion_estimate_describe_matches_jax(spills):
    """The same line as the JAX record's, shared memory (KB) in place of
    VMEM (MB), and the spill check the port's ``fits_smem``."""
    parts = [dict(flops=1e9, bytes_rw=4e8, measured_ms=0.5),
             dict(flops=3e9, bytes_rw=2e8, measured_ms=0.25)]
    need = 2 * SMEM_BYTES if spills else SMEM_BYTES // 2
    fe = fused_cost([NodeCost(**p) for p in parts], 1e8, smem_required=need)
    je = jcore.fused_cost([jcore.NodeCost(**p) for p in parts], 1e8,
                          vmem_required=need, vmem_bytes=SMEM_BYTES)
    got, want = fe.describe(), je.describe()
    head = want.split(", vmem=")[0]
    if spills:                  # inf on both sides
        assert got.startswith(head)
    else:                       # the fused roofline is each device's own
        assert got.split(", hbm_saved=")[1].split(", smem=")[0] == \
            want.split(", hbm_saved=")[1].split(", vmem=")[0]
        assert f"unfused={fe.unfused_ms:.4f} ms" in want
    assert fe.fits_smem == je.fits_vmem == (not spills)
    assert got.endswith("SPILLS)" if spills else "fits)")
    assert f"smem={need / 1e3:.2f}/{SMEM_BYTES / 1e3:.0f} KB" in got
