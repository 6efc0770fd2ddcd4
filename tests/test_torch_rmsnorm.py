"""K5 ``rmsnorm`` and K6 ``rmsnorm_matmul``: the port's plain versions held
against the JAX package's Pallas kernels (interpret mode, as the reference's
own tests run them here) and its jnp oracles (``kernels/ref.py``), over the
reference's shapes.  Also: the wrappers' CPU path launches nothing and takes
leading batch dims, the database rows, and the fusion gate at DeepSeek-67B
widths in both packages (a hand-built IR: no 10 GB of weights on the CPU).

Tolerances: K5 1e-5 and K6 1e-4 (``tests/test_kernels.py`` and
``tests/test_fusion.py`` of the reference), abs and rel.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.core.partition as jpart
from repro.kernels import ref as jref
from repro.kernels.ops import register_rmsnorm_matmul_modules as jregister
from repro_torch import core as tcore
from repro_torch.core import SMEM_BYTES, CourierIR, ModuleDatabase, Node
from repro_torch.core.partition import fused_working_set_bytes, stencil_tile_bytes
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rk

torch.set_num_threads(1)

# the module, not the function ``repro.kernels`` re-exports under its name
jk = importlib.import_module("repro.kernels.rmsnorm")

RMS_SHAPES = [(8, 32), (7, 16), (5, 130), (256, 64), (300, 64)]
MM_SHAPES = [(64, 128, 96), (100, 64, 64), (8, 32, 16), (5, 130, 77),
             (256, 64, 32), (300, 64, 48)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.2).astype(np.float32)
    return x, s


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_plain_matches_pallas_and_ref(shape):
    x, s = _inputs(shape, sum(shape))
    got = rk.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    rb = 256 if shape[0] % 256 == 0 else shape[0]
    pallas = np.asarray(jk.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                   row_block=rb, interpret=True))
    oracle = np.asarray(jref.reference_rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N,d,dout", MM_SHAPES)
def test_rmsnorm_matmul_plain_matches_pallas_and_ref(N, d, dout):
    x, s = _inputs((N, d), N + d + dout)
    w = np.random.default_rng(dout).standard_normal((d, dout)).astype(
        np.float32)
    got = rk.rmsnorm_matmul_ref(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(w)).numpy()
    pallas = np.asarray(jk.rmsnorm_matmul(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w), row_block=32,
        interpret=True))
    oracle = np.asarray(jref.reference_rmsnorm_matmul(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-4)


def test_cpu_wrappers_take_leading_dims_and_launch_nothing():
    before = dict(rk.LAUNCHES)
    x, s = _inputs((3, 5, 24), 1)
    w = np.random.default_rng(2).standard_normal((24, 10)).astype(np.float32)
    xt, st, wt = map(torch.from_numpy, (x, s, w))
    y = rk.rmsnorm(xt, st)
    assert y.shape == (3, 5, 24)
    torch.testing.assert_close(y.reshape(15, 24),
                               rk.rmsnorm_ref(xt.reshape(15, 24), st))
    o = rk.rmsnorm_matmul(xt, st, wt)
    assert o.shape == (3, 5, 10)
    torch.testing.assert_close(o.reshape(15, 10), rk.rmsnorm_matmul_ref(
        xt.reshape(15, 24), st, wt), rtol=1e-6, atol=1e-6)
    assert ops.rmsnorm is rk.rmsnorm and ops.rmsnorm_matmul is rk.rmsnorm_matmul
    assert rk.LAUNCHES == before


def test_gemm_tile_is_the_kernels_shared_memory():
    bm, bn, bk = rk.GEMM_TILE
    b_stages, raw_stages = rk.GEMM_B_STAGES, rk.GEMM_RAW_STAGES
    # the ring of w's hi and lo TF32 terms, the raw ring of x, w and the
    # scale, two barriers a stage and 1 KB to align the swizzled tiles
    assert rk.gemm_smem_bytes() == (
        4 * (b_stages * 2 * bn * bk + raw_stages * (bm * bk + bk * bn + bk))
        + 8 * 2 * (b_stages + raw_stages) + 1024) == 198112
    assert rk.gemm_smem_bytes() <= SMEM_BYTES


# --------------------------------------------------------------------------- #
# K6's arithmetic on the tensor cores (3xTF32), emulated on the CPU
# --------------------------------------------------------------------------- #
def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), rounded to nearest, ties away from
    zero: cvt.rna.tf32.f32, by integer operations on the bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _emulate_k6(x, s, w, terms: int, eps: float = rk.EPS) -> torch.Tensor:
    """K6's arithmetic in plain torch: (1 + s) folded into w before the
    split, each operand as hi = tf32(a) and lo = tf32(a - hi), each k step
    of ``GEMM_TILE[2]`` taken as lo*hi + hi*lo + hi*hi (``terms`` 3) or
    hi*hi alone (``terms`` 1) from exact TF32 products summed in f32, and
    added into an f32 sum; the row's rsqrt(mean x^2 + eps) applied last.
    (The tensor core truncates its own sums, which no CPU product does.)"""
    wg = w * (1.0 + s)[:, None]
    xh, wh = _tf32(x), _tf32(wg)
    xl, wl = _tf32(x - xh), _tf32(wg - wh)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    bk = rk.GEMM_TILE[2]
    for k0 in range(0, x.shape[1], bk):
        k = slice(k0, k0 + bk)
        hh = xh[:, k] @ wh[k]
        acc += (xl[:, k] @ wh[k] + xh[:, k] @ wl[k]) + hh if terms == 3 else hh
    r = torch.rsqrt((x * x).sum(-1, keepdim=True) / x.shape[1] + eps)
    return acc * r


def _chip_inputs(n, d, dout, seed):
    """x, s and w drawn as chip_smoke.py draws K6's (randn, 0.2 randn,
    randn / sqrt(d)), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = (rng.standard_normal(d) * 0.2).astype(np.float32)
    w = (rng.standard_normal((d, dout)) * d ** -0.5).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, s, w)))


def _share_of_limit(got, want, tol=1e-4) -> float:
    """The worst element's |got - want| over chip_smoke's limit for K6,
    tol + tol |want|."""
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


@pytest.mark.parametrize("N,d,dout", [(64, 8192, 256), (7, 130, 77),
                                      (513, 130, 77)])
def test_tf32x3_emulation_holds_k6_limit(N, d, dout):
    x, s, w = _chip_inputs(N, d, dout, N + d)
    want = rk.rmsnorm_matmul_ref(x, s, w)
    got = _emulate_k6(x, s, w, terms=3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _share_of_limit(got, want) < 0.1


def test_one_tf32_term_misses_k6_limit():
    """hi*hi alone (TF32 GEMM) misses K6's limit at the served width d =
    8192: why the kernel takes three products."""
    x, s, w = _chip_inputs(64, 8192, 256, 64 + 8192)
    want = rk.rmsnorm_matmul_ref(x, s, w)
    ratio = _share_of_limit(_emulate_k6(x, s, w, terms=1), want)
    print(f"one TF32 term: {ratio:.2f}x K6's element-wise limit")
    assert ratio > 5.0


def test_database_rows_match_the_reference():
    tdb, jdb = ModuleDatabase("t"), jcore.ModuleDatabase("j")
    ops.register_rmsnorm_matmul_modules(tdb)
    jregister(jdb)
    assert tdb.names() == jdb.names() == ["matmul", "rmsnorm",
                                          "rmsnorm+matmul"]
    for k in tdb.names():
        assert tdb.entries[k].has_hw((4, 8), (8,)) == \
            jdb.entries[k].has_hw((4, 8), (8,))
        assert not tdb.entries[k].has_hw((2, 4, 8), (8,)) \
            or k == "matmul"                  # shape gate: traced rank 2
        assert tdb.entries[k].batch_dims
    fused = tdb.lookup("rmsnorm+matmul")
    assert fused.accelerated is rk.rmsnorm_matmul
    assert fused.smem_tile is rk.gemm_tile_bytes
    assert tdb.lookup("rmsnorm").accelerated is rk.rmsnorm


# --------------------------------------------------------------------------- #
# the fusion gate at DeepSeek-67B widths, in both packages
# --------------------------------------------------------------------------- #
T, D, VOCAB = 512, 8192, 102400


def _lm_head_ir(core):
    """rmsnorm -> matmul over full-width value shapes (no tensors made)."""
    ir = core.CourierIR("lm_head")
    for name, shape in (("x", (T, D)), ("ln_f", (D,)), ("h", (T, D)),
                        ("w_out", (D, VOCAB)), ("logits", (T, VOCAB))):
        ir.add_value(name, shape, "float32")
    ir.add_node(core.Node(name="rmsnorm_4", fn_key="rmsnorm",
                          inputs=["x", "ln_f"], outputs=["h"], time_ms=1.0))
    ir.add_node(core.Node(name="matmul_0", fn_key="matmul",
                          inputs=["h", "w_out"], outputs=["logits"],
                          time_ms=1.0))
    ir.graph_inputs = ["x", "ln_f", "w_out"]
    ir.graph_outputs = ["logits"]
    return ir


def test_full_width_lm_head_fuses_in_both_packages():
    keys = {}
    for name, core, register in (("jax", jcore, jregister),
                                 ("torch", tcore, ops.register_rmsnorm_matmul_modules)):
        db = core.ModuleDatabase(name)
        register(db)
        ir = _lm_head_ir(core)
        core.assign_placements(ir, db)
        if name == "jax":
            ws = jpart.fused_working_set_bytes(ir, ir.nodes)
            assert 10e6 < ws < 11e6 and ws < 128 * 1024**2   # 12-row slabs
        else:
            ws = fused_working_set_bytes(ir, ir.nodes,
                                         db.lookup("rmsnorm+matmul").smem_tile)
            assert ws == rk.gemm_smem_bytes() <= SMEM_BYTES
            # the stencil reckoning would fit too, but only by accident
            assert stencil_tile_bytes(ir, ["x", "ln_f", "h", "w_out",
                                           "logits"]) != ws
        fused = core.fuse_adjacent_hw(ir, db, fused_cost_ms="model")
        keys[name] = [(n.name, n.fn_key) for n in fused.nodes if n.fused_from]
    assert keys["torch"] == keys["jax"] == [("rmsnorm_4+matmul_0",
                                            "rmsnorm+matmul")]


def test_smem_spill_rule_reads_the_declared_tile():
    """The verifier reckons the tile the fused module declares: a GEMM run
    fits whatever its widths; the same run with a tile that overflows is
    flagged, and with no database the stencil tile is reckoned."""
    from repro_torch.analysis import verify_plan
    db = ModuleDatabase("t")
    ops.register_rmsnorm_matmul_modules(db)
    ir = _lm_head_ir(tcore)
    tcore.assign_placements(ir, db)
    ir = tcore.fuse_adjacent_hw(ir, db, fused_cost_ms="model")
    plan = tcore.partition_optimal(ir, max_stages=1)
    assert verify_plan(ir, plan, db=db) == []
    db.lookup("rmsnorm+matmul").smem_tile = lambda ir, names: SMEM_BYTES + 1
    assert [d.rule for d in verify_plan(ir, plan, db=db)] == ["smem-spill"]
    assert verify_plan(ir, plan) == []


def test_stencil_tile_unchanged_for_undeclared_runs():
    ir = CourierIR("s")
    for v in ("a", "b"):
        ir.add_value(v, (1080, 1920, 3), "float32")
    ir.add_node(Node(name="f_0", fn_key="f", inputs=["a"], outputs=["b"]))
    # FUSED_TILE (16, 64) and FUSED_HALO 4: (16 + 4) x (64 + 4) pixels a value
    assert fused_working_set_bytes(ir, ir.nodes) == 2 * 20 * 68 * 3 * 4
