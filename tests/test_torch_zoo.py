"""The port's model zoo held against the JAX package's.

Every software row takes the same numpy inputs in both packages (weights
through ``params_from_numpy``) and agrees to 2e-4 (the reference's f32
tolerance, ``tests/test_database_diff.py``), and takes leading batch dims,
which is how the executor micro-batches.  The traced transformer (2 layers,
d 64, ff 128, 4 heads, vocab 128, T 32) has the same node names, fn keys and
placements in both packages, the fused ``rmsnorm_4+matmul_0`` included, and
the port's pipeline output equals ``jax.jit`` of the JAX demo to 2e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jcore
import repro.models.zoo as jzoo
from repro_torch.core import Frontend, Library, PipelineGenerator
from repro_torch.models import zoo

torch.set_num_threads(1)

TOL = 2e-4
SMALL = dict(n_layers=2, d=64, ff=128, n_heads=4, vocab=128)


def _rng(seed):
    return np.random.default_rng(seed)


def _both(fn_j, fn_t, *arrays, **kw):
    """Run the JAX row and the port's row on the same numpy inputs."""
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _row_inputs(name, T=16, d=32, seed=0):
    r = _rng(seed)
    f32 = np.float32
    x = r.standard_normal((T, d)).astype(f32)
    if name == "attention":
        ws = [(r.standard_normal((d, d)) * d ** -0.5).astype(f32)
              for _ in range(4)]
        return (x, *ws), {"n_heads": 4, "theta": 10000.0}
    if name == "add":
        return (x, r.standard_normal((T, d)).astype(f32)), {}
    if name == "swiglu":
        return (x, (r.standard_normal((d, 48)) * d ** -0.5).astype(f32),
                (r.standard_normal((24, d)) * 24 ** -0.5).astype(f32)), {}
    if name == "moe":
        E, ff = 4, 24
        return (x, r.standard_normal((d, E)).astype(f32),
                (r.standard_normal((E, d, ff)) * d ** -0.5).astype(f32),
                (r.standard_normal((E, ff, d)) * ff ** -0.5).astype(f32)), {}
    if name == "rwkv_shift":
        return (x, r.uniform(0.1, 0.9, d).astype(f32)), {}
    if name == "ssm_scan":
        return (x, r.uniform(0.5, 0.95, d).astype(f32),
                r.standard_normal(d).astype(f32),
                r.standard_normal(d).astype(f32)), {}
    raise KeyError(name)


ROWS = ["attention", "add", "swiglu", "moe", "rwkv_shift", "ssm_scan"]


@pytest.mark.parametrize("name", ROWS)
def test_sw_row_matches_jax(name):
    args, kw = _row_inputs(name)
    got, want = _both(getattr(jzoo, f"sw_{name}"), getattr(zoo, f"sw_{name}"),
                      *args, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("name", ROWS)
def test_sw_row_takes_leading_batch_dims(name):
    rows = [_row_inputs(name, seed=s) for s in range(3)]
    kw = rows[0][1]
    fn = getattr(zoo, f"sw_{name}")
    xs = torch.stack([torch.from_numpy(a[0]) for a, _ in rows])
    side = [torch.from_numpy(v) for v in rows[0][0][1:]]
    if name == "add":                       # both operands are per-token
        side = [torch.stack([torch.from_numpy(a[1]) for a, _ in rows])]
    batched = fn(xs, *side, **kw)
    for i in range(3):
        one = fn(xs[i], *[s[i] if name == "add" else s for s in side], **kw)
        torch.testing.assert_close(batched[i], one, rtol=1e-5, atol=1e-5)


def test_rope_matches_jax():
    x = _rng(3).standard_normal((16, 4, 8)).astype(np.float32)
    got, want = _both(jzoo._rope, zoo._rope, x, theta=10000.0)
    _close(got, want, 1e-5)


def test_zoo_db_has_the_reference_rows():
    jdb, tdb = jzoo.make_zoo_db(), zoo.make_zoo_db()
    assert tdb.names() == sorted(k for k in jdb.names())
    for k in tdb.names():
        assert (tdb.entries[k].accelerated is None) == \
            (jdb.entries[k].accelerated is None)
        assert tdb.entries[k].batch_dims


def test_init_transformer_params_on_the_cpu_from_a_generator():
    a = zoo.init_transformer_params(torch.Generator().manual_seed(0),
                                    device="cpu", **SMALL)
    b = zoo.init_transformer_params(torch.Generator().manual_seed(0),
                                    device="cpu", **SMALL)
    j = jzoo.init_transformer_params(jax.random.PRNGKey(0), **SMALL)
    assert len(a["layers"]) == 2 and a["n_heads"] == 4
    for la, lb, lj in zip(a["layers"], b["layers"], j["layers"]):
        assert set(la) == set(lj)
        for k in la:
            assert la[k].shape == lj[k].shape and la[k].device.type == "cpu"
            assert torch.equal(la[k], lb[k])
    assert a["w_out"].shape == j["w_out"].shape == (64, 128)


def _jax_demo(params_seed=0):
    jparams = jzoo.init_transformer_params(jax.random.PRNGKey(params_seed),
                                           **SMALL)
    jdb = jzoo.make_zoo_db()
    return jparams, jdb, jzoo.transformer_demo(jcore.Library(jdb), jparams)


def _port_demo(jparams):
    params = zoo.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    db = zoo.make_zoo_db()
    return params, db, zoo.transformer_demo(Library(db), params)


def test_traced_transformer_matches_the_jax_package():
    jparams, jdb, japp = _jax_demo()
    _, tdb, tapp = _port_demo(jparams)
    x = _rng(7).standard_normal((32, 64)).astype(np.float32)
    xs = [_rng(8 + i).standard_normal((32, 64)).astype(np.float32)
          for i in range(3)]

    jir, _ = jcore.Frontend(jdb).trace(japp, jnp.asarray(x))
    jpipe = jcore.PipelineGenerator(jdb).generate(jir, policy="optimal",
                                                  fuse=True, max_stages=4)
    tir, _ = Frontend(tdb).trace(tapp, torch.from_numpy(x))
    tpipe = PipelineGenerator(tdb).generate(tir, policy="optimal", fuse=True,
                                            max_stages=4)

    def nodes(ir):
        return [(n.name, n.fn_key, getattr(n.placement, "kind", n.placement))
                for n in ir.nodes]
    assert nodes(tpipe.ir) == nodes(jpipe.ir)
    assert [n.name for n in tpipe.ir.nodes if n.fused_from] == \
        ["rmsnorm_4+matmul_0"]
    assert len(tpipe.captured) == len(jpipe.captured)

    ref = jax.jit(japp)
    got = tpipe.run([torch.from_numpy(a) for a in xs])
    for g, a in zip(got, xs):
        _close(g.numpy(), np.asarray(ref(jnp.asarray(a))))
    # the untraced port app too: every lib call takes its software row
    _close(tapp(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))))


def test_recurrent_demo_matches_the_jax_package():
    jp = jzoo.init_recurrent_params(jax.random.PRNGKey(1), d=32)
    tp = zoo.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    japp = jzoo.recurrent_demo(jcore.Library(jzoo.make_zoo_db()), jp)
    db = zoo.make_zoo_db()
    tapp = zoo.recurrent_demo(Library(db), tp)
    x = _rng(2).standard_normal((12, 32)).astype(np.float32)
    ir, _ = Frontend(db).trace(tapp, torch.from_numpy(x))
    pipe = PipelineGenerator(db).generate(ir, policy="optimal", max_stages=2)
    want = np.asarray(jax.jit(japp)(jnp.asarray(x)))
    _close(pipe(torch.from_numpy(x)).numpy(), want)
    p = zoo.init_recurrent_params(torch.Generator().manual_seed(0), d=32,
                                  device="cpu")
    assert set(p) == set(jp) and p["a"].min() >= 0.5 and p["a"].max() <= 0.95
