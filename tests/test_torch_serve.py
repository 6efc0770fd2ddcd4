"""The port's serving layer on the CPU: both demos at small sizes, the
request-queue server's accounting (served / shed / expired / failed, each
request resolved exactly once), admission control, and the rule that the
port imports nothing of JAX or the JAX package.

Work is ordered by events and counts, never by sleeps or wall-clock
thresholds: a stage that must hold a request in flight waits on an event
the test sets.
"""
import os
import re
import threading

import pytest
import torch

import repro.launch.serve as jserve
from repro_torch.core import Frontend, Library, ModuleDatabase, PipelineGenerator
from repro_torch.core.executor import ExecutorClosed
from repro_torch.launch import serve
from repro_torch.launch.serve import (AdmissionController, DeadlineExceeded,
                                      Overloaded, RequestQueueServer,
                                      WaitTimeout, priority_of,
                                      replication_aware_batching)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_traced_transformer_demo_on_the_cpu():
    stats = serve.serve_traced_transformer_demo(
        n_requests=6, max_batch=3, seq_len=16, d=32, n_layers=2, ff=64,
        n_heads=4, vocab=64, device="cpu")
    assert stats["requests_served"] == 6 and stats["failed"] == 0
    assert stats["results_match"] and stats["max_rel_err"] <= 2e-4
    assert stats["fused_nodes"] == ["rmsnorm_4+matmul_0"]
    assert stats["hw_nodes"] == {
        **{f"rmsnorm_{i}": "rmsnorm" for i in range(4)},
        "rmsnorm_4+matmul_0": "rmsnorm+matmul"}
    assert stats["captured_inputs"] == 18 and stats["token_inputs"] == 1
    assert stats["warmup_groups"] == 2                 # one single + one of 3
    assert stats["executor"]["tokens_retired"] == 6
    assert stats["executor"]["out_of_order_retired"] == 0
    assert stats["device_ms_per_group"] > 0.0
    assert sum(len(s) for s in stats["stages"]) == stats["n_nodes"]


def test_pipeline_demo_on_the_cpu():
    stats = serve.serve_pipeline_demo(n_requests=5, max_batch=2,
                                      size=(16, 24), device="cpu")
    assert stats["requests_served"] == 5 and stats["results_match"]
    assert stats["max_abs_err"] <= 1e-3
    assert stats["executor"]["tokens_retired"] == 5


def test_pipeline_demo_widened_retires_in_order():
    stats = serve.serve_pipeline_demo(n_requests=6, max_batch=2,
                                      size=(16, 24), worker_budget=6,
                                      device="cpu")
    assert stats["requests_served"] == 6 and stats["results_match"]
    assert stats["replicas"] is None or sum(stats["replicas"]) <= 6
    assert stats["executor"]["out_of_order_retired"] == 0


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_pipeline_demo(n_requests=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_traced_transformer_demo(n_requests=1)


def test_cli_lm_mode_on_the_cpu(capsys):
    serve.main(["--mode", "lm", "--device", "cpu", "--prompt-len", "12",
                "--tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=gemma3-12b layers=4 dtype=float32 batch=4 prompt=12" in out
    assert "decode:" in out and "generated (4, 4)" in out


def test_lm_mode_is_the_default_and_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_lm(serve.lm_config())


def test_cli_serves_the_vlm_and_checks_its_depth(capsys):
    serve.main(["--mode", "lm", "--arch", "llama-3.2-vision-11b", "--device",
                "cpu", "--prompt-len", "12", "--tokens", "3"])
    out = capsys.readouterr().out
    assert ("arch=llama-3.2-vision-11b layers=4 dtype=float32 batch=4 "
            "prompt=12") in out and "generated (4, 3)" in out
    with pytest.raises(ValueError, match="cross_attn_every 2"):
        serve.main(["--mode", "lm", "--arch", "llama-3.2-vision-11b",
                    "--device", "cpu", "--layers", "3", "--tokens", "1"])
    full = serve.lm_config("llama-3.2-vision-11b", reduced=False)
    assert (full.n_layers, full.cross_attn_every, full.n_img_tokens,
            full.d_model, full.n_heads, full.n_kv_heads, full.hd,
            full.dtype) == (40, 5, 1601, 4096, 32, 8, 128, "bfloat16")
    import jax
    import numpy as np

    from repro.configs import get_config as jget_config
    from repro.models import LM as JLM

    tree = jax.eval_shape(JLM(jget_config("llama-3.2-vision-11b")).init,
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert round(n / 1e9, 2) == 9.25                 # 18.5 GB in bf16


def test_lm_config_runs_full_widths_when_asked():
    full = serve.lm_config("gemma3-12b", reduced=False, layers=6)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab, full.window, full.dtype) == (
        3840, 16, 8, 256, 15360, 262144, 1024, "bfloat16")
    assert list(full.layer_windows) == [1024] * 5 + [0]
    assert round(full.n_params * 2 / 1e9, 2) == 4.70         # GB of bf16
    assert serve.lm_config().d_model == 64                  # reduced default
    assert serve.lm_config(layers=6) == serve.lm_config().__class__(
        **{**serve.lm_config().__dict__, "n_layers": 6})


@pytest.mark.parametrize("arch,layers", [("gemma3-12b", 6),
                                         ("hymba-1.5b", None),
                                         ("rwkv6-1.6b", None),
                                         ("llama-3.2-vision-11b", None)])
def test_serve_lm_greedy_ids_match_a_jax_loop(arch, layers):
    """The port's prefill + greedy decode picks the JAX package's tokens
    for the same prompt and weights (f32, reduced: gemma3-12b at 6 layers
    with one global layer, hymba-1.5b's attention + SSM blocks, rwkv6-1.6b's
    RWKV blocks, llama-3.2-vision-11b's groups of self and cross layers
    over the same image embeddings)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as jget_config
    from repro.models import LM as JLM
    from repro_torch.models.transformer import params_from_numpy

    cfg = jget_config(arch).reduced(**({"n_layers": layers} if layers
                                       else {}))
    m = JLM(cfg)
    params = m.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10))
    img = (np.random.default_rng(6).standard_normal(
        (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        if cfg.cross_attn_every else None)
    n_tok = 6
    cache = m.init_cache(2, 10 + n_tok)
    hp, cache = m.prefill(params, jnp.asarray(prompt), cache,
                          **({"img_embeds": jnp.asarray(img)}
                             if img is not None else {}))
    tok = jnp.argmax(m.logits(params, hp)[:, -1], axis=-1)[:, None]
    step = jax.jit(lambda p, c, ids, pos: m.decode_step(p, ids, c, pos))
    want = []
    for t in range(n_tok):
        want.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, 10 + t)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]

    tcfg = serve.lm_config(arch, layers=layers)
    st = serve.serve_lm(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg.dtype, device="cpu"),
        prompt, tokens=n_tok, device="cpu", keep_logits=True,
        img_embeds=img)
    np.testing.assert_array_equal(st["ids"], np.concatenate(want, axis=1))
    assert st["finite"] and st["logits"].shape == (2, n_tok + 1, cfg.vocab)
    assert st["k7_launches_prefill"] == st["k7_launches_decode"] == 0
    assert st["prefill_device_ms"] is None and st["prefill_ms"] > 0


def test_cli_trace_mode_on_the_cpu(capsys):
    serve.main(["--mode", "trace", "--device", "cpu", "--requests", "4",
                "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "rmsnorm_4+matmul_0" in out
    assert "match the untraced app: True" in out


# --------------------------------------------------------------------------- #
# the server's accounting, against a gated one-stage pipeline
# --------------------------------------------------------------------------- #
def _gated_pipeline(entered: threading.Event, gate: threading.Event):
    def f(x):
        if float(x.reshape(-1)[0]) < 0:      # the "hold" token
            entered.set()
            assert gate.wait(30.0), "test never released the gate"
        return x + 1.0
    db = ModuleDatabase("t")
    db.register("f", software=f)
    lib = Library(db)
    ir, _ = Frontend(db).trace(lambda x: lib.f(x), torch.zeros(4),
                               profile=False)
    ir.nodes[0].time_ms = 1.0
    return PipelineGenerator(db).generate(ir, n_threads=1)


def test_server_smoke_latency_timeline_and_errors():
    pipe = _gated_pipeline(threading.Event(), threading.Event())
    ex = pipe.executor(max_in_flight=6, microbatch=3)
    toks = [torch.full((4,), float(i + 1)) for i in range(7)]
    with RequestQueueServer(ex, max_batch=3, max_wait_ms=2.0) as srv:
        reqs = [srv.submit(t) for t in toks]
        bad = srv.submit(torch.ones(4), torch.ones(4))     # wrong arity
        got = [r.wait(timeout=60.0) for r in reqs]
        with pytest.raises((ValueError, TypeError)):
            bad.wait(timeout=60.0)
    for g, t in zip(got, toks):
        torch.testing.assert_close(g, t + 1.0)
    stats = srv.stats()
    assert stats["requests_served"] == 7 and stats["failed"] == 1
    assert stats["submitted"] == 8
    assert stats["latency_ms"]["p95"] >= stats["latency_ms"]["p50"] > 0.0
    for r in reqs:
        assert r.latency_ms >= r.queue_ms >= 0.0


def test_admission_sheds_best_effort_and_infeasible_deadlines():
    entered, gate = threading.Event(), threading.Event()
    pipe = _gated_pipeline(entered, gate)
    adm = AdmissionController(100.0, slo_ref_ms=10.0)
    srv = RequestQueueServer(pipe.executor(max_in_flight=4), max_batch=1,
                             max_wait_ms=0.0, admission=adm)
    with srv:
        hold = srv.submit(torch.full((4,), -1.0))
        assert entered.wait(30.0)                 # one request in flight
        shed = srv.submit(torch.ones(4), priority="best-effort")
        late = srv.submit(torch.ones(4), deadline_ms=1.0)
        for r in (shed, late):
            with pytest.raises(Overloaded):
                r.wait(timeout=1.0)
        gate.set()
        torch.testing.assert_close(hold.wait(timeout=60.0), torch.zeros(4))
    counts = srv.stats()["classes"]
    assert counts["best_effort"]["shed"] == 1
    assert counts["interactive"]["served"] == 1
    assert counts["interactive"]["shed"] == 1
    assert adm.snapshot()["shed_reasons"] == {"deadline": 1, "ladder": 1,
                                              "queue_full": 0}


def test_deadline_expires_a_request_still_queued():
    entered, gate = threading.Event(), threading.Event()
    pipe = _gated_pipeline(entered, gate)
    srv = RequestQueueServer(pipe.executor(), max_batch=1, max_wait_ms=0.0)
    with srv:
        hold = srv.submit(torch.full((4,), -1.0))
        assert entered.wait(30.0)        # the batcher is inside the stage
        late = srv.submit(torch.ones(4), deadline_ms=1e-3)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            late.wait(timeout=60.0)
        hold.wait(timeout=60.0)
    stats = srv.stats()
    assert stats["expired"] == 1 and stats["requests_served"] == 1
    assert stats["slo_violation_rate"] == 0.5


def test_stopped_server_refuses_and_wait_times_out():
    entered, gate = threading.Event(), threading.Event()
    pipe = _gated_pipeline(entered, gate)
    srv = RequestQueueServer(pipe.executor(), max_batch=1, max_wait_ms=0.0)
    srv.start()
    hold = srv.submit(torch.full((4,), -1.0))
    assert entered.wait(30.0)
    with pytest.raises(WaitTimeout):
        hold.wait(timeout=0.0)
    gate.set()
    srv.stop()
    assert float(hold.wait(timeout=60.0)[0]) == 0.0
    after = srv.submit(torch.ones(4))
    with pytest.raises(ExecutorClosed):
        after.wait(timeout=1.0)
    assert srv.stats()["shed"] == 1


def test_helpers_match_the_jax_package():
    assert [priority_of(p) for p in ("interactive", "batch", "best-effort", 2)] \
        == [jserve.priority_of(p) for p in ("interactive", "batch",
                                            "best-effort", 2)]
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for q in (0, 50, 95, 99, 99.9, 100):
        assert serve._percentile(xs, q) == jserve._percentile(xs, q)

    class Plan:
        bottleneck_ms, effective_bottleneck_ms = 8.0, 2.0
    assert replication_aware_batching(Plan, max_batch=4, max_wait_ms=4.0) \
        == jserve.replication_aware_batching(Plan, max_batch=4,
                                             max_wait_ms=4.0) == (16, 1.0)


# --------------------------------------------------------------------------- #
# the port imports nothing of JAX or the JAX package
# --------------------------------------------------------------------------- #
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_import_no_jax_and_no_reference_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f for f in files if _IMPORT.search(open(f).read())]
    assert bad == []
