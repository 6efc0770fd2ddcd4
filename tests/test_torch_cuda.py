"""The port's CUDA kernels on the card, held to their plain versions.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import Library, courier_offload
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import harris as hk
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rk
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models import harris as mh
from repro_torch.models import moe
from repro_torch.models import rwkv as mrwkv
from repro_torch.models import ssm as mssm

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _frame(h, w, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255
                            ).to(device)


def _close_scaled(got, want, atol=1e-5):
    """Harris responses: compare after dividing both by max |reference|."""
    scale = want.abs().max().item() + 1e-9
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("H,W", [(17, 23), (33, 130), (1081, 1919)])
def test_kernels_match_plain_versions_on_card(cuda_device, H, W):
    img = _frame(H, W, H, cuda_device)
    gray = hk.cvt_color_ref(img)
    torch.testing.assert_close(hk.cvt_color(img), gray, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(hk.convert_scale_abs(gray, -2.0, 100.0),
                               hk.convert_scale_abs_ref(gray, -2.0, 100.0),
                               rtol=1e-5, atol=1e-3)
    for bs in (2, 3):
        want = hk.corner_harris_ref(gray, bs)
        _close_scaled(hk.corner_harris(gray, bs), want)
        _close_scaled(hk.harris_fused(img, bs, with_csa=False), want)
        torch.testing.assert_close(
            hk.harris_fused(img, bs, alpha=1e-6, beta=3.0),
            hk.harris_fused_ref(img, bs, alpha=1e-6, beta=3.0),
            rtol=1e-5, atol=1e-3)


def test_kernels_reject_what_they_do_not_take(cuda_device):
    with pytest.raises(TypeError, match="float32"):
        hk.cvt_color(torch.zeros((4, 4, 3), dtype=torch.float64,
                                 device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        hk.corner_harris(torch.zeros((8, 8), device=cuda_device).t())
    with pytest.raises(ValueError, match="block_size"):
        hk.corner_harris(torch.zeros((8, 8), device=cuda_device), 4)


# one tile or less, one row or column, and every W % 4 (W % 4 == 0 takes
# the 16-byte copies and stores)
EDGE_SHAPES = [(1, 1), (1, 37), (29, 1), (3, 5), (7, 13), (20, 65), (20, 66),
               (20, 67), (24, 68)]
FEASIBLE_TILES = [t for t in hk.TILE_CANDIDATES
                  if hk.tile_score(t, 1080, 1920, 2) < math.inf]


def _harris_bit_exact(img, bs, tile=None):
    gray = hk.cvt_color_ref(img)
    want = hk.corner_harris_ref(gray, bs)
    assert torch.equal(hk.corner_harris(gray, bs, tile=tile), want)
    assert torch.equal(hk.harris_fused(img, bs, with_csa=False, tile=tile),
                       want)
    assert torch.equal(hk.harris_fused(img, bs, alpha=1e-6, beta=3.0,
                                       tile=tile),
                       hk.harris_fused_ref(img, bs, alpha=1e-6, beta=3.0))


@pytest.mark.parametrize("H,W", EDGE_SHAPES)
@pytest.mark.parametrize("bs", [2, 3])
def test_harris_stencils_bit_exact_at_edge_shapes_on_card(cuda_device, H, W,
                                                          bs):
    _harris_bit_exact(_frame(H, W, 100 * H + W, cuda_device), bs)


@pytest.mark.parametrize("tile", FEASIBLE_TILES)
@pytest.mark.parametrize("H,W", [(1080, 1920), (1081, 1919)])
def test_harris_stencils_bit_exact_at_every_tile_on_card(cuda_device, tile,
                                                         H, W):
    # a grid sized to the SMs: blocks walk several tiles at these frames
    for bs in (2, 3):
        _harris_bit_exact(_frame(H, W, 5, cuda_device), bs, tile)


@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099, 9_000_001])
def test_convert_scale_abs_bit_exact_on_card(cuda_device, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 300)
    x[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
    x = x.to(cuda_device)
    # x itself (16-byte aligned), and a view 4 bytes past it
    for v in (x, x.view(-1)[1:]):
        for a, b in ((1.0, 0.0), (-2.0, 100.0), (0.0, -1.0)):
            torch.testing.assert_close(hk.convert_scale_abs(v, a, b),
                                       hk.convert_scale_abs_ref(v, a, b),
                                       rtol=0, atol=0, equal_nan=True)


def test_harris_kernels_reject_a_tile_they_do_not_take(cuda_device):
    gray = torch.zeros((40, 40), device=cuda_device)
    for tile in ((9, 32), (16, 30), (16, 24)):
        with pytest.raises(ValueError, match="micro-tiles"):
            hk.corner_harris(gray, tile=tile)
        with pytest.raises(ValueError, match="micro-tiles"):
            hk.harris_fused(torch.zeros((40, 40, 3), device=cuda_device),
                            tile=tile)


@pytest.mark.parametrize("fuse", [False, True])
def test_offload_on_card_goes_through_the_kernels(cuda_device, fuse):
    frames = mh.make_frames(2, 68, 130, seed=1, device=cuda_device)
    db = mh.make_harris_db(with_hw=True)
    app = mh.corner_harris_demo(Library(db))
    off = courier_offload(app, frames[0], db=db, fuse=fuse)
    plain = mh.corner_harris_demo(Library(mh.make_harris_db(with_hw=False)))
    hk.reset_launches()
    outs = off.map(frames)
    torch.cuda.synchronize()
    launched = {k for k, v in hk.LAUNCHES.items() if v}
    assert launched == ({"harris_fused", "convert_scale_abs"} if fuse else
                        {"cvt_color", "corner_harris", "convert_scale_abs"})
    for got, f in zip(outs, frames):
        torch.testing.assert_close(got, plain(f), rtol=1e-3, atol=1e-3)
    assert off.fallbacks == [] and off.plan.fallback_log == []


@pytest.mark.parametrize("N,d,dout", [(7, 130, 77), (513, 130, 77),
                                      (513, 64, 96), (129, 8192, 260)])
def test_rmsnorm_kernels_match_plain_versions_on_card(cuda_device, N, d, dout):
    g = torch.Generator(cuda_device).manual_seed(N + d)
    x = torch.randn((N, d), generator=g, device=cuda_device)
    s = torch.randn((d,), generator=g, device=cuda_device) * 0.2
    w = torch.randn((d, dout), generator=g, device=cuda_device) * d ** -0.5
    torch.testing.assert_close(rk.rmsnorm(x, s), rk.rmsnorm_ref(x, s),
                               rtol=1e-5, atol=1e-5)
    want = rk.rmsnorm_matmul_ref(x, s, w)
    got = rk.rmsnorm_matmul(x, s, w)
    torch.cuda.synchronize()
    assert got.shape == (N, dout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # leading dims flatten to rows: one launch for a stacked group
    before = rk.LAUNCHES["rmsnorm_matmul"]
    torch.testing.assert_close(rk.rmsnorm_matmul(x[None], s, w)[0], got)
    assert rk.LAUNCHES["rmsnorm_matmul"] == before + 1


@pytest.mark.parametrize("N,d,dout,offset", [
    (192, 8192, 102400, 0),   # the served width: a slab of rows, the lm head
    (64, 8224, 260, 0),       # K % 32 != 0 (16-byte copies still)
    (33, 8200, 1001, 0),      # K % 32 != 0 and N % 4 != 0
    (7, 130, 77, 0),          # M < 64, K % 4 != 0, N % 4 != 0
    (100, 256, 384, 1)])      # x and w 4 bytes off 16-byte alignment
def test_k6_tensor_core_route_matches_plain_version(cuda_device, N, d, dout,
                                                   offset):
    """K6's one route, 3xTF32 on wgmma, at the served width and at every
    kind of edge, element by element to 1e-4 against the plain version in
    full f32 (TF32 off); leading dims still make one launch."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator(cuda_device).manual_seed(N + d + dout)

    def randn(*shape):
        buf = torch.randn(math.prod(shape) + offset, generator=g,
                          device=cuda_device)
        return buf[offset:].view(shape)

    x, s, w = randn(N, d), randn(d) * 0.2, randn(d, dout) * d ** -0.5
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    want = rk.rmsnorm_matmul_ref(x, s, w)
    before = rk.LAUNCHES["rmsnorm_matmul"]
    got = rk.rmsnorm_matmul(x, s, w)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rmsnorm_matmul"] == before + 1
    assert got.shape == (N, dout) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if N % 3 == 0:                      # [3, N / 3, d]: one launch
        stacked = rk.rmsnorm_matmul(x.reshape(3, N // 3, d), s, w)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["rmsnorm_matmul"] == before + 2
        torch.testing.assert_close(stacked.reshape(N, dout), got)


def test_rmsnorm_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    s = torch.zeros((8,), device=cuda_device)
    w = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rk.rmsnorm(x.double(), s)
    with pytest.raises(ValueError, match="scale"):
        rk.rmsnorm(x, torch.zeros((7,), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        rk.rmsnorm(torch.zeros((8, 4), device=cuda_device).t(), s)
    with pytest.raises(ValueError, match="scale"):
        rk.rmsnorm(x, s.cpu())
    with pytest.raises(ValueError, match="w"):
        rk.rmsnorm_matmul(x, s, torch.zeros((7, 3), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        rk.rmsnorm_matmul(x, s, torch.zeros((3, 8), device=cuda_device).t())
    with pytest.raises(TypeError, match="float32"):
        rk.rmsnorm_matmul(x, s, w.half())


def test_served_traced_transformer_goes_through_both_kernels(cuda_device):
    rk.reset_launches()
    stats = serve.serve_traced_transformer_demo(
        n_requests=6, max_batch=3, seq_len=32, d=256, n_layers=2, ff=512,
        n_heads=4, vocab=384, device=cuda_device)
    torch.cuda.synchronize()
    groups = stats["warmup_groups"] + stats["executor"]["groups_admitted"]
    assert stats["requests_served"] == 6 and stats["results_match"]
    assert stats["fused_nodes"] == ["rmsnorm_4+matmul_0"]
    assert rk.LAUNCHES == {"rmsnorm": 4 * groups, "rmsnorm_matmul": groups}


@pytest.mark.parametrize("B,T,H,hd,M", [(1, 128, 1, 64, 128),
                                        (2, 77, 3, 16, 131),
                                        (2, 128, 4, 32, 384),
                                        (1, 300, 2, 256, 200),
                                        (2, 33, 2, 128, 97)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0),
                                           (False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version_on_card(cuda_device, B, T, H,
                                                       hd, M, causal, window,
                                                       dtype):
    g = torch.Generator(cuda_device).manual_seed(T + M + hd)
    q, k, v = (torch.randn((B, L, H, hd), generator=g, device=cuda_device
                           ).to(dtype) for L in (T, M, M))
    before = fa.LAUNCHES["flash_attention"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    want_o, want_lse = fa.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert o.dtype == dtype and lse.shape == (B * H, T)
    tol = 2.5e-2 if dtype == torch.bfloat16 else 2e-5
    want = want_o.float()
    diff = (o.float() - want).abs()
    assert diff.max() <= tol * want.abs().max()
    # element by element too: max |o| comes from rows that see few keys, and
    # would hide a fault in the small averages of rows that see many
    rms = want.square().mean().sqrt()
    limit = (2.0**-7 * want.abs() + 2.0**-8 * rms if dtype == torch.bfloat16
             else 2e-5 * (want.abs() + rms))
    assert (diff <= limit).all()
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp(min=1.0)
            ).all()
    torch.testing.assert_close(ops.attention(q, k, v, causal, window), o,
                               rtol=0, atol=0)


def _k7_within_element_wise_limit(q, k, v, causal, window):
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    want_o, want_lse = fa.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    want = want_o.float()
    rms = want.square().mean().sqrt()
    limit = 2.0**-7 * want.abs() + 2.0**-8 * rms
    assert ((o.float() - want).abs() <= limit).all()
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp(min=1.0)
            ).all()


@pytest.mark.parametrize("T", [4096, 4128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1024)])
def test_flash_attention_tensor_core_kernel_at_long_lengths_on_card(
        cuda_device, T, causal, window):
    """bf16 K7 on the tensor cores at the LM's lengths (T = 4128: the
    prompt plus the generated tokens, off any tile), element by element."""
    g = torch.Generator(cuda_device).manual_seed(T + window)
    q, k, v = (torch.randn((1, T, 2, 256), generator=g, device=cuda_device
                           ).bfloat16() for _ in range(3))
    fa.reset_launches()
    _k7_within_element_wise_limit(q, k, v, causal, window)
    assert fa.ROUTE_LAUNCHES["flash_attention"] == {"wgmma_bf16": 1,
                                                    "simt_f32": 0}


def test_flash_attention_routes_by_type_on_card(cuda_device):
    """bf16 takes the tensor-core kernel, f32 the SIMT kernel; one launch
    each, counted once in LAUNCHES and once on its route."""
    g = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn((2, 77, 3, 64), generator=g, device=cuda_device)
    fa.reset_launches()
    fa.flash_attention_fwd(x, x, x, True, 0)
    assert fa.ROUTE_LAUNCHES["flash_attention"] == {"wgmma_bf16": 0,
                                                    "simt_f32": 1}
    fa.flash_attention_fwd(x.bfloat16(), x.bfloat16(), x.bfloat16(), True, 0)
    assert fa.ROUTE_LAUNCHES["flash_attention"] == {"wgmma_bf16": 1,
                                                    "simt_f32": 1}
    assert fa.LAUNCHES["flash_attention"] == 2


def test_flash_attention_raises_on_a_bf16_case_it_cannot_take(cuda_device):
    """A bf16 case the tensor-core kernel cannot take raises: nothing is
    launched, and neither the f32 kernel nor the plain version runs."""
    n = 1 * 64 * 2 * 64
    x = torch.zeros(n + 1, dtype=torch.bfloat16, device=cuda_device
                    )[1:].view(1, 64, 2, 64)       # contiguous, 2 B aligned
    assert x.is_contiguous() and x.data_ptr() % 16
    y = torch.zeros((1, 64, 2, 48), dtype=torch.bfloat16, device=cuda_device)
    fa.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_fwd(x, x, x, True, 0)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention_fwd(y, y, y, True, 0)
    assert fa.LAUNCHES["flash_attention"] == 0
    assert fa.ROUTE_LAUNCHES["flash_attention"] == {"wgmma_bf16": 0,
                                                    "simt_f32": 0}


def test_flash_attention_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head_dim 48"):
        x = torch.zeros((1, 8, 2, 48), device=cuda_device)
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                           q)
    with pytest.raises(ValueError, match="pre-expanded"):
        fa.flash_attention(q, q[:, :, :1].contiguous(), q)
    with pytest.raises(ValueError, match="must be a tensor on"):
        fa.flash_attention(q, q.cpu(), q)


def test_lm_on_card_runs_every_prefill_attention_through_the_kernel(
        cuda_device):
    cfg = serve.lm_config("gemma3-12b", layers=6)
    st = serve.serve_lm(cfg, batch=2, prompt_len=37, tokens=5,
                        device=cuda_device, keep_logits=True)
    assert st["k7_launches_prefill"] == 6 and st["k7_launches_decode"] == 0
    assert st["finite"] and st["ids"].shape == (2, 5)
    assert st["prefill_device_ms"] > 0


@pytest.mark.parametrize("capacity_factor", [1.0, 32.0],
                         ids=["drops", "no_drops"])
@pytest.mark.parametrize("dtype,limit", [(torch.bfloat16, 2e-2),
                                         (torch.float32, 2e-4)])
@pytest.mark.parametrize("mode,T", [("einsum", 512), ("sort", 512),
                                    ("sort", 1)])
def test_moe_dispatch_matches_moe_ref_under_its_own_routing_on_card(
        cuda_device, mode, T, dtype, limit, capacity_factor):
    """Both dispatches on the card against the plain f32 MoE under the
    routing the card chose (no comparison of discrete choices across
    devices): y within 2e-2 (bf16) or 2e-4 (f32) of max|ref|."""
    g = torch.Generator(cuda_device).manual_seed(T)
    E, k, d = 16, 4, 256
    p = moe.moe_init(g, d, 128, E, dtype)
    x = torch.randn((4, T, d), generator=g, device=cuda_device).to(dtype)
    routing = {}
    y, aux = moe.moe_apply(p, x, k, capacity_factor, 4 if T > 1 else 1,
                           mode, routing=routing)
    ref = moe.moe_ref(p, x.reshape(-1, d), *(
        routing[n].reshape(-1, k) for n in ("idx", "gate", "keep")))
    assert y.dtype == dtype and routing["logits"].dtype == torch.float32
    err = ((y.reshape(-1, d).float() - ref).abs().max() / ref.abs().max())
    assert float(err) <= limit, float(err)
    assert (float(aux["dropped_frac"]) == 0.0) == (capacity_factor > 16)


def test_moe_lm_serves_twice_bit_for_bit_on_card(cuda_device):
    """Reduced moonshot-v1-16b-a3b in bf16: the 4 x 2048 prefill takes the
    einsum dispatch (16 groups), decode the sort one; K7 runs every prefill
    self-attention, and a second serve gives the same logits bit for bit."""
    cfg = dataclasses.replace(serve.lm_config("moonshot-v1-16b-a3b"),
                              dtype="bfloat16")
    params = LM(cfg).init(torch.Generator(cuda_device).manual_seed(0))
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (4, 2048))
    runs = [serve.serve_lm(cfg, params, prompt, tokens=6, device=cuda_device,
                           keep_logits=True) for _ in range(2)]
    for st in runs:
        assert st["k7_launches_prefill"] == cfg.n_layers
        assert st["k7_launches_decode"] == 0 and st["finite"]
    assert torch.equal(runs[0]["logits"], runs[1]["logits"])
    np.testing.assert_array_equal(runs[0]["ids"], runs[1]["ids"])


# the leaves ssm_init and rwkv_init set to zeros or ones, drawn instead:
# name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}


def _draw_state_leaves(block: dict, g: torch.Generator) -> dict:
    out = dict(block)
    for k, (lo, hi) in STATE_LEAF_DRAWS.items():
        if k in out:
            v = out[k]
            out[k] = (torch.rand(v.shape, generator=g, device=v.device)
                      * (hi - lo) + lo).to(v.dtype)
    return out


def test_ssm_and_time_mix_carry_their_state_on_card(cuda_device):
    """f32 on the card: ssm_apply over [2, 32, 64] in one call equals 32
    single-token calls carrying {h, conv}, and time_mix over [2, 32, 128]
    equals 32 calls carrying S and the shift (2e-4), every zero- or
    one-initialised leaf drawn first."""
    g = torch.Generator(cuda_device).manual_seed(1)
    d, N, K, T = 64, 16, 4, 32
    p = _draw_state_leaves(mssm.ssm_init(g, d, N, K, torch.float32), g)
    x = torch.randn((2, T, d), generator=g, device=cuda_device)
    y_full, st_full = mssm.ssm_apply(p, x)
    st = mssm.ssm_init_state(2, d, N, K, torch.float32, cuda_device)
    ys = []
    for t in range(T):
        y_t, st = mssm.ssm_apply(p, x[:, t:t + 1], state=st)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(st["h"], st_full["h"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st["conv"], st_full["conv"], rtol=2e-4,
                               atol=2e-4)

    d = 128
    p = _draw_state_leaves(mrwkv.rwkv_init(g, d, 256, torch.float32), g)
    x = torch.randn((2, T, d), generator=g, device=cuda_device) * 0.5
    S0 = torch.zeros((2, d // 64, 64, 64), device=cuda_device)
    y_full, S_full = mrwkv.time_mix(p, x, S0, None)
    S, last, ys = S0, torch.zeros((2, d), device=cuda_device), []
    for t in range(T):
        y_t, S = mrwkv.time_mix(p, x[:, t:t + 1], S, last)
        last = x[:, t]
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(S, S_full, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_scan_checkpoints_nest_in_the_layer_remat_on_card(cuda_device,
                                                          arch):
    """A reduced f32 model's loss and gradients at S 512 (two 256-step
    chunks a recurrence, each checkpointed inside the per-layer
    checkpoint) equal the step without the per-layer remat, and time_mix's
    equal those with the scan's remat off (1e-5 relative), on the card's
    torch."""
    from repro_torch.launch.steps import loss_and_grads

    cfg = serve.lm_config(arch)
    g = torch.Generator(cuda_device).manual_seed(2)
    params = LM(cfg).init(g)
    blk = "rwkv" if cfg.rwkv else "ssm"
    params["layers"][blk] = _draw_state_leaves(params["layers"][blk], g)
    rng = np.random.default_rng(4)
    batch = {"ids": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 512))
                                     ).to(cuda_device),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 512))
                                        ).to(cuda_device),
             "mask": torch.ones((2, 512), device=cuda_device)}
    fa.reset_launches()
    ce, grads, _ = loss_and_grads(LM(cfg), params, batch)
    ce2, grads2, _ = loss_and_grads(LM(cfg), params, batch, remat=False)
    assert fa.LAUNCHES["flash_attention"] == (0 if cfg.rwkv else
                                              3 * cfg.n_layers)
    assert abs(float(ce) - float(ce2)) <= 1e-5 * abs(float(ce2))
    for a, b in zip(grads, grads2):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0
        assert float((a - b).norm() / b.norm()) <= 1e-5

    p = _draw_state_leaves(mrwkv.rwkv_init(g, 128, 256, torch.float32), g)
    x = torch.randn((1, 512, 128), generator=g, device=cuda_device)
    S0 = torch.zeros((1, 2, 64, 64), device=cuda_device)
    names = sorted(set(p) - {"ck", "cv", "cr", "mu_c"})
    out = []
    for remat in (True, False):
        leaves = [x.clone().requires_grad_()] + [
            p[k].clone().requires_grad_() for k in names]
        with torch.enable_grad():
            y, S = mrwkv.time_mix(dict(zip(names, leaves[1:])), leaves[0],
                                  S0, None, remat=remat)
            out.append((y.detach(), S.detach(), torch.autograd.grad(
                (y ** 2).sum() + S.sum(), leaves)))
    (y1, S1, g1), (y2, S2, g2) = out
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=0)
    torch.testing.assert_close(S1, S2, rtol=1e-5, atol=0)
    for a, b in zip(g1, g2):
        assert float((a - b).norm() / b.norm()) <= 1e-5


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_recurrent_lm_serves_twice_bit_for_bit_on_card(cuda_device, arch):
    """Reduced hymba-1.5b (K7 on every prefill self-attention, none in the
    decode loop) and rwkv6-1.6b (no K7) in bf16, a 2 x 512 prompt (two
    256-step chunks) and 6 tokens: finite logits, and a second serve gives
    the same logits bit for bit."""
    cfg = dataclasses.replace(serve.lm_config(arch), dtype="bfloat16")
    g = torch.Generator(cuda_device).manual_seed(0)
    params = LM(cfg).init(g)
    blk = "rwkv" if cfg.rwkv else "ssm"
    params["layers"][blk] = _draw_state_leaves(params["layers"][blk], g)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 512))
    runs = [serve.serve_lm(cfg, params, prompt, tokens=6, device=cuda_device,
                           keep_logits=True) for _ in range(2)]
    for st in runs:
        assert st["k7_launches_prefill"] == (0 if cfg.rwkv else
                                             cfg.n_layers)
        assert st["k7_launches_decode"] == 0 and st["finite"]
    assert torch.equal(runs[0]["logits"], runs[1]["logits"])
    np.testing.assert_array_equal(runs[0]["ids"], runs[1]["ids"])


def _vlm(cuda_device, dtype: str = "bfloat16"):
    """Reduced llama-3.2-vision-11b (2 groups of 1 self + 1 cross layer, 16
    image tokens) on the card: (cfg, params, image embeddings)."""
    cfg = dataclasses.replace(serve.lm_config("llama-3.2-vision-11b"),
                              dtype=dtype)
    g = torch.Generator(cuda_device).manual_seed(0)
    params = LM(cfg).init(g)
    img = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=g,
                      device=cuda_device).to(getattr(torch, dtype))
    return cfg, params, img


@pytest.mark.parametrize("M", [1601, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_kernels_against_image_rows_on_card(cuda_device, M,
                                                            dtype):
    """K7, K8 and K9 with causal=False at [1, 256, 4, 128] against M image
    rows (1601 = 25 * 64 + 1: a last key tile of one row), element by
    element against the plain version and autograd through it."""
    g = torch.Generator(cuda_device).manual_seed(M)
    q, k, v, do = (torch.randn((1, L, 4, 128), generator=g,
                               device=cuda_device).to(dtype)
                   for L in (256, M, M, 256))
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, False, 0)
    want_o, want_lse = fa.flash_attention_ref(q, k, v, False, 0)
    torch.cuda.synchronize()
    want = want_o.float()
    rms = want.square().mean().sqrt()
    limit = (2.0**-7 * want.abs() + 2.0**-8 * rms if dtype == torch.bfloat16
             else 2e-5 * (want.abs() + rms))
    assert ((o.float() - want).abs() <= limit).all()
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp(min=1.0)
            ).all()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, False, 0), leaves,
                              do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*ref, False, 0)[0],
                               ref, do)
    for a, b in zip(got, want):
        _grads_close(a, b, dtype == torch.bfloat16)
    assert dict(fa.LAUNCHES) == {"flash_attention": 2,
                                 "flash_attention_bwd_dq": 1,
                                 "flash_attention_bwd_dkv": 1}


def test_tensor_core_kernels_launch_from_a_fresh_thread_on_card(cuda_device):
    """bf16 K7, K8 and K9 launched from a thread that has made no CUDA call
    yet, as PyTorch's autograd worker thread can be when it reaches K8
    first: the wrappers bind the tensors' context before encoding their
    TMA maps (without it the encode fails with an invalid context), and the
    results equal the main thread's bit for bit."""
    g = torch.Generator(cuda_device).manual_seed(11)
    q, k, v, do = (torch.randn((1, L, 4, 128), generator=g,
                               device=cuda_device).bfloat16()
                   for L in (256, 65, 65, 256))

    def run():
        o, lse = fa.flash_attention_fwd(q, k, v, False, 0)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, False, 0)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False,
                                            0)
        torch.cuda.synchronize()
        return o, dq, dk, dv

    out = {}

    def fresh():
        try:
            out["got"] = run()
        except Exception as e:        # reported by the assert below
            out["error"] = e

    t = threading.Thread(target=fresh)
    t.start()
    t.join(120)
    assert not t.is_alive() and "error" not in out, out.get("error")
    for a, b in zip(out["got"], run()):
        assert torch.equal(a, b)


def test_vlm_lm_serves_twice_bit_for_bit_on_card(cuda_device):
    """Reduced llama-3.2-vision-11b in bf16, a 2 x 512 prompt and 6 tokens:
    K7 on each of the 4 layers' prefill attentions (2 self, 2 cross), none
    in the decode loop; finite logits, the same bit for bit twice."""
    cfg, params, img = _vlm(cuda_device)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 512))
    runs = [serve.serve_lm(cfg, params, prompt, tokens=6, device=cuda_device,
                           keep_logits=True, img_embeds=img)
            for _ in range(2)]
    for st in runs:
        assert st["k7_launches_prefill"] == cfg.n_layers == 4
        assert st["k7_launches_decode"] == 0 and st["finite"]
    assert torch.equal(runs[0]["logits"], runs[1]["logits"])
    np.testing.assert_array_equal(runs[0]["ids"], runs[1]["ids"])


def test_vlm_cross_cache_is_written_in_place_on_card(cuda_device):
    """The prefill writes each group's image K/V into the cache's own
    ``ck``/``cv`` tensors; the decode steps read them and leave them as
    they are."""
    cfg, params, img = _vlm(cuda_device)
    m = LM(cfg)
    cache = m.init_cache(2, 40, device=cuda_device)
    ck, cv = cache["cross"]["ck"], cache["cross"]["cv"]
    ids = torch.randint(0, cfg.vocab, (2, 32), device=cuda_device)
    with torch.no_grad():
        _, cache = m.prefill(params, ids, cache, img_embeds=img)
        assert cache["cross"]["ck"] is ck and cache["cross"]["cv"] is cv
        for g in range(ck.shape[0]):
            for got, w in ((ck, "wk"), (cv, "wv")):
                want = torch.einsum("bmd,dnh->bmnh", img,
                                    params["cross"]["attn"][w][g])
                assert torch.equal(got[g], want)
        kept = (ck.clone(), cv.clone())
        for t in range(32, 35):
            lg, cache = m.decode_step(params, ids[:, -1:], cache, t)
            assert torch.isfinite(lg).all()
    assert torch.equal(ck, kept[0]) and torch.equal(cv, kept[1])


def _grads_close(got, want, bf16: bool) -> None:
    """K8/K9's gradient against autograd through the plain forward, element
    by element: one bf16 ulp plus 2^-8 rms, or 2e-4 of |g| + rms in f32."""
    want = want.float()
    diff = (got.float() - want).abs()
    rms = want.square().mean().sqrt()
    limit = (2.0**-7 * want.abs() + 2.0**-8 * rms if bf16
             else 2e-4 * (want.abs() + rms))
    assert torch.isfinite(got).all() and (diff <= limit).all(), \
        float((diff / limit).max())


@pytest.mark.parametrize("B,T,H,hd,M", [(1, 128, 1, 64, 128),
                                        (2, 77, 3, 16, 131),
                                        (2, 128, 4, 32, 384),
                                        (1, 300, 2, 256, 200),
                                        (2, 33, 2, 128, 97)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0),
                                           (False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_version_on_card(
        cuda_device, B, T, H, hd, M, causal, window, dtype):
    g = torch.Generator(cuda_device).manual_seed(T + M + hd + 1)
    q, k, v, do = (torch.randn((B, L, H, hd), generator=g, device=cuda_device
                               ).to(dtype) for L in (T, M, M, T))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(*leaves, causal, window)
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        "flash_attention": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_ref(*ref, causal, window)[0], ref, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _grads_close(a, b, dtype == torch.bfloat16)


@pytest.mark.parametrize("T", [4096, 4128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1024)])
def test_flash_attention_backward_tensor_core_kernels_at_long_lengths_on_card(
        cuda_device, T, causal, window):
    """bf16 K8 and K9 on the tensor cores at the training length (T = 4128:
    off any tile), against the plain backward from K7's lse, element by
    element."""
    g = torch.Generator(cuda_device).manual_seed(T + window + 1)
    q, k, v, do = (torch.randn((1, T, 2, 256), generator=g,
                               device=cuda_device).bfloat16()
                   for _ in range(4))
    _, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    fa.reset_launches()
    got = fa.flash_attention_bwd(q, k, v, lse, do, causal, window)
    want = fa.flash_attention_bwd_ref(q, k, v, lse, do, causal, window)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert fa.ROUTE_LAUNCHES[name] == {"wgmma_bf16": 1, "simt_f32": 0}
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _grads_close(a, b, True)


def test_flash_attention_backward_routes_by_type_on_card(cuda_device):
    """bf16 K8/K9 take the tensor-core kernels, f32 the SIMT kernels."""
    g = torch.Generator(cuda_device).manual_seed(6)
    q, k, v, do = (torch.randn((2, 77, 3, 64), generator=g,
                               device=cuda_device) for _ in range(4))
    for dt, route in ((torch.float32, "simt_f32"),
                      (torch.bfloat16, "wgmma_bf16")):
        x = [t.to(dt) for t in (q, k, v, do)]
        _, lse = fa.flash_attention_fwd(*x[:3], True, 0)
        fa.reset_launches()
        fa.flash_attention_bwd(*x[:3], lse, x[3], True, 0)
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            assert fa.ROUTE_LAUNCHES[name] == {
                r: int(r == route) for r in ("wgmma_bf16", "simt_f32")}


def _simt_backward_matches_plain_version(q, k, v, do, causal, window):
    """f32 K8 then K9, one ``simt_f32`` launch each, against the plain
    backward from K7's lse, element by element (delta too)."""
    _, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    fa.reset_launches()
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, causal, window)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        window)
    want_dq, want_delta = fa.flash_attention_bwd_dq_ref(q, k, v, lse, do,
                                                        causal, window)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                      want_delta, causal,
                                                      window)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert fa.ROUTE_LAUNCHES[name] == {"wgmma_bf16": 0, "simt_f32": 1}
    for got, want in zip((dq, dk, dv, delta),
                         (want_dq, want_dk, want_dv, want_delta)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _grads_close(got, want, False)


@pytest.mark.parametrize("causal,window", [(True, 32), (True, 0)])
def test_simt_backward_at_the_drivers_shape_on_card(cuda_device, causal,
                                                    window):
    """The fault-tolerant driver's attention, [8, 64, 10, 64] f32."""
    g = torch.Generator(cuda_device).manual_seed(64 + window)
    q, k, v, do = (torch.randn((8, 64, 10, 64), generator=g,
                               device=cuda_device) for _ in range(4))
    _simt_backward_matches_plain_version(q, k, v, do, causal, window)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("T,M,causal,window", [
    (1, 17, False, 0), (15, 15, True, 0), (17, 17, True, 0),
    (15, 15, False, 0), (17, 17, False, 0),
    (300, 200, True, 40)])                 # rows 239.. see no key
def test_simt_backward_at_lengths_off_its_tiles_on_card(cuda_device, hd, T,
                                                        M, causal, window):
    """f32 K8/K9 where T or M is off the 16-row blocks and the streamed
    tiles, with one or two ring stages and K8's one or two sweeps.  T = 1
    sees M = 17 keys: against one key (causal, or M = 1) its softmax is
    constant, so dq and dk are 0 and both versions return rounding noise,
    which no limit relative to the gradient can hold."""
    g = torch.Generator(cuda_device).manual_seed(T + M + hd)
    q, k, v, do = (torch.randn((2, L, 2, hd), generator=g,
                               device=cuda_device) for L in (T, M, M, T))
    _simt_backward_matches_plain_version(q, k, v, do, causal, window)


def _simt_forward_matches_plain_version(q, k, v, causal, window):
    """f32 K7, one ``simt_f32`` launch, against its plain version: o within
    2e-5 of max |o| and of 2e-5 (|o| + rms(o)) element by element, lse
    within 1e-5 of max(1, |lse|)."""
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    want_o, want_lse = fa.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES["flash_attention"] == {"wgmma_bf16": 0,
                                                    "simt_f32": 1}
    assert o.dtype == torch.float32 and lse.shape == want_lse.shape
    diff = (o - want_o).abs()
    rms = want_o.square().mean().sqrt()
    assert diff.max() <= 2e-5 * want_o.abs().max()
    assert (diff <= 2e-5 * (want_o.abs() + rms)).all()
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp(min=1.0)
            ).all()


@pytest.mark.parametrize("causal,window", [(True, 32), (True, 0)])
def test_simt_forward_at_the_drivers_shape_on_card(cuda_device, causal,
                                                   window):
    """The fault-tolerant driver's attention, [8, 64, 10, 64] f32: 320
    blocks of one key tile each."""
    g = torch.Generator(cuda_device).manual_seed(640 + window)
    q, k, v = (torch.randn((8, 64, 10, 64), generator=g, device=cuda_device)
               for _ in range(3))
    _simt_forward_matches_plain_version(q, k, v, causal, window)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("T,M,causal,window", [
    (1, 17, False, 0), (15, 15, True, 0), (17, 17, True, 0),
    (15, 15, False, 0), (17, 17, False, 0),
    (300, 200, True, 40), (300, 200, False, 40),    # rows 239.. see no key
    (256, 256, True, 0), (256, 256, False, 0)])     # several key tiles
def test_simt_forward_at_lengths_off_its_blocks_and_tiles_on_card(
        cuda_device, hd, T, M, causal, window):
    """f32 K7 where T or M is off the 16-row blocks and the key tiles, with
    one or two ring stages and the online rescale; then f32 K8 and K9 from
    its lse against their plain versions (T = 1 sees M = 17 keys: see
    test_simt_backward_at_lengths_off_its_tiles_on_card)."""
    g = torch.Generator(cuda_device).manual_seed(7 * T + M + hd)
    q, k, v, do = (torch.randn((2, L, 2, hd), generator=g,
                               device=cuda_device) for L in (T, M, M, T))
    _simt_forward_matches_plain_version(q, k, v, causal, window)
    _simt_backward_matches_plain_version(q, k, v, do, causal, window)


def test_simt_forward_shared_memory_matches_the_python_reckoning(
        cuda_device):
    lib = fa.library()
    for hd in fa.HEAD_DIMS:
        assert (lib.repro_flash_attention_smem_bytes(hd, 0)
                == fa.simt_fwd_smem_bytes(hd))


def test_reduced_train_step_on_card_runs_k7_k8_k9_per_layer(cuda_device):
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init

    cfg = serve.lm_config("gemma3-12b", layers=6)
    L = cfg.n_layers
    params = LM(cfg).init(torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
                   for _ in range(2))
    losses = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)  # updated in place
        _, step = make_train_step(cfg, lr=1e-3, warmup=2, total_steps=10,
                                  loss_chunk=16)
        state = {"params": p, "opt": adamw_init(p)}
        fa.reset_launches()
        batch = {"ids": ids.to(dev), "labels": labels.to(dev),
                 "mask": torch.ones((2, 40), device=dev)}
        state, met = step(state, batch)
        losses[str(dev)] = float(met["loss"])
        counts = dict(fa.LAUNCHES)
    assert counts == {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                      "flash_attention_bwd_dkv": L}
    assert np.isfinite(losses["cuda"])
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_logits_backward_on_card_keeps_the_f32_gradient(cuda_device):
    """The loss's logits product in bf16: its backward carries the f32
    gradient as three bf16 terms, so it equals the product with the f32
    gradient (as JAX's transpose takes it) within one bf16 ulp, and on all
    but 1% of the elements."""
    from repro_torch.models import layers as ml

    g = torch.Generator(cuda_device).manual_seed(3)
    h, table = (torch.randn(s, generator=g, device=cuda_device).bfloat16()
                .requires_grad_() for s in ((96, 256), (4096, 256)))
    out = ml.logits_f32(h, table)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, h.float() @ table.float().t(),
                               rtol=1e-5, atol=1e-4)
    dout = torch.randn(out.shape, generator=g, device=cuda_device)
    got = torch.autograd.grad(out, (h, table), dout)
    want = ((dout @ table.detach().float()).bfloat16(),
            (dout.t() @ h.detach().float()).bfloat16())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        a, w = a.float(), w.float()
        rms = w.square().mean().sqrt()
        assert ((a - w).abs() <= 2.0**-7 * w.abs() + 2.0**-8 * rms).all()
        assert (a != w).float().mean().item() <= 0.01


def test_backward_wrappers_take_a_strided_output_gradient(cuda_device):
    """K8's and K9's wrappers refuse a strided do; flash_attention_bwd (the
    Function's backward) makes it contiguous once for both."""
    g = torch.Generator(cuda_device).manual_seed(4)
    q, k, v = (torch.randn((1, 40, 2, 32), generator=g, device=cuda_device)
               for _ in range(3))
    do = torch.randn((1, 2, 40, 32), generator=g,
                     device=cuda_device).transpose(1, 2)
    _, lse = fa.flash_attention_fwd(q, k, v, True, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dq(q, k, v, lse, do, True, 0)
    got = fa.flash_attention_bwd(q, k, v, lse, do, True, 0)
    want = fa.flash_attention_bwd_ref(q, k, v, lse, do.contiguous(), True, 0)
    for a, w in zip(got, want):
        _grads_close(a, w, False)


# --------------------------------------------------------------------------- #
# the KV-slot slice on the card: the pool, decode attention, the hot swap
# --------------------------------------------------------------------------- #
def test_kv_pool_arena_lives_on_the_card(cuda_device):
    from repro_torch.runtime import DecodeSession, KVSlotPool, SlotError

    pool = KVSlotPool(2, 4, {"k": (2, 3), "v": (2, 3)})   # the card
    assert pool.device.type == "cuda" and pool._buf["k"].is_cuda
    g = torch.Generator(cuda_device).manual_seed(8)
    with DecodeSession(pool) as ses:
        rows = [torch.randn((2, 3), generator=g, device=cuda_device)
                for _ in range(3)]
        for t, r in enumerate(rows):
            assert pool.append(ses.slot, k=r, v=-r) == t
        got = pool.read(ses.slot)
        assert got["k"].is_cuda and torch.equal(got["k"], torch.stack(rows))
        assert torch.equal(got["v"], -torch.stack(rows))
        assert pool.read(-1)["k"].shape == (0, 2, 3)
        assert pool.append(-1, k=rows[0], v=rows[0]) == -1
        pool.append(ses.slot, k=rows[0].cpu(), v=rows[0].cpu())  # from host
        with pytest.raises(SlotError, match="full"):
            pool.append(ses.slot, k=rows[0], v=rows[0])
    pool.check_no_leaks()


def test_decode_attention_on_the_card_matches_the_cpu(cuda_device):
    """Step by step, the incremental decode on the card (pool, weights and
    tokens there) against the same steps on the CPU, within the f32
    tolerance 2e-4 of the largest; the cache stays on the card."""
    from repro_torch.core import ModuleDatabase
    from repro_torch.models.zoo import register_decode_modules, sw_attention
    from repro_torch.runtime import KVSlotPool

    d, heads, T = 128, 4, 8
    rng = np.random.default_rng(2)
    ws = [torch.from_numpy((rng.standard_normal((d, d)) * 0.1)
                           .astype(np.float32)) for _ in range(4)]
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    attn = {}
    for dev in ("cpu", cuda_device):
        pool = KVSlotPool(1, T, {"k": (heads, d // heads),
                                 "v": (heads, d // heads)}, device=dev)
        db = ModuleDatabase()
        register_decode_modules(db, pool, n_heads=heads)
        attn[str(dev)] = (db.lookup("attention_decode").software, pool,
                          pool.alloc())
    (fc, pc, sc), (fg, pg, sg) = attn["cpu"], attn[str(cuda_device)]
    wg = [w.to(cuda_device) for w in ws]
    for t in range(T):
        want = fc(x[t:t + 1], sc, *ws)
        got = fg(x[t:t + 1].to(cuda_device), sg, *wg)
        assert got.is_cuda and pg.read(sg)["k"].is_cuda
        scale = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 2e-4 * scale, t
        full = sw_attention(x[:t + 1].to(cuda_device), *wg, n_heads=heads)
        assert (got - full[-1:]).abs().max().item() <= 2e-4 * scale, t
    assert pg.length(sg) == pc.length(sc) == T


def test_planner_and_hot_swap_on_the_card(cuda_device):
    """An ElasticPlanner over a traced chain on card tensors (the card is
    its default device): serve serially, hot-swap to its widened executor
    mid-stream, zero drops, results equal the pipeline run token by
    token."""
    from repro_torch.core import (Frontend, Library, ModuleDatabase,
                                  PipelineGenerator)
    from repro_torch.runtime import ElasticPlanner

    db = ModuleDatabase("t")
    db.register("mul2", software=lambda x: x * 2.0)
    db.register("add1", software=lambda x: x + 1.0)
    db.register("sq", software=lambda x: x * x)
    db.register("tanh", software=torch.tanh)
    lib = Library(db)

    def app(x):
        return lib.tanh(lib.sq(lib.add1(lib.mul2(x))))

    toks = [torch.full((256,), (i + 1) / 32.0, device=cuda_device)
            for i in range(24)]
    ir, _ = Frontend(db).trace(app, toks[0])
    pipe = PipelineGenerator(db).generate(ir, n_threads=3)
    want = pipe.run_sequential(toks)
    planner = ElasticPlanner(pipe.ir, db=db)
    assert planner.device.type == "cuda"
    ex_a, _ = planner.executor_for(3)
    ex_b, rebuilt = planner.executor_for(3, worker_budget=6)
    assert rebuilt and ex_b.replicas is not None
    ex_a.warmup(toks[0])
    ex_b.warmup(toks[0])
    srv = serve.RequestQueueServer(ex_a, max_batch=2, max_wait_ms=2.0)
    srv.start()
    try:
        reqs = [srv.submit(t) for t in toks[:12]]
        assert srv.swap_executor(ex_b, timeout=60.0) is ex_a
        reqs += [srv.submit(t) for t in toks[12:]]
        got = [r.wait(timeout=60.0) for r in reqs]
    finally:
        srv.stop()
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    st = srv.stats()
    assert st["requests_served"] == 24 and st["swaps"] == 1
    assert ex_a.stats().tokens_retired + ex_b.stats().tokens_retired == 24
    assert ex_b.stats().out_of_order_retired == 0
    ex_a.close()
    ex_b.close()


def test_planner_on_the_card_refuses_weights_traced_on_the_cpu(cuda_device):
    """The planner's default device is the card; an IR whose captured
    weights lie on the CPU would run its stages there, so it raises."""
    from repro_torch.core import Frontend, Library, ModuleDatabase
    from repro_torch.runtime import ElasticPlanner

    db = ModuleDatabase("t")
    db.register("scale", software=lambda x, w: x * w)
    lib = Library(db)
    w = torch.full((8,), 2.0)
    ir, _ = Frontend(db).trace(lambda x: lib.scale(x, w), torch.ones(8))
    with pytest.raises(ValueError, match="traced with .* on cpu"):
        ElasticPlanner(ir, db=db)
    ir.captured = {k: v.to(cuda_device) for k, v in ir.captured.items()}
    assert ElasticPlanner(ir, db=db).device.type == "cuda"


def test_two_rank_pipeline_of_full_width_gemma_layers_sharing_the_card(
        cuda_device):
    """Layers 4 (local) and 5 (global) of gemma3-12b at full widths, one a
    rank, the two ranks sharing the card (gloo, hand-offs through pinned
    host memory): outputs and each layer's gradient of mean(out²) against
    the sequential run here, 2e-2 of the largest |reference|; K7-K9 on the
    ranks' wgmma route."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.launch.mesh import run_on_local_mesh
    from repro_torch.models.transformer import pipeline_block, pipeline_layer

    from torch_spmd_ranks import gemma_pipeline_rank

    first, seed, xs_seed, M, T = 4, 7, 11, 2, 1024
    res = run_on_local_mesh((2,), ("stage",), gemma_pipeline_rank, first,
                            seed, xs_seed, M, T, device="cuda", timeout=600)
    cfg = get_config("gemma3-12b")
    block = pipeline_block(cfg)
    layers = [pipeline_layer(cfg, first + s, seed, cuda_device)
              for s in range(2)]
    weights = [tree_map(lambda a: a.requires_grad_(True), lp["block"])
               for lp in layers]
    g = torch.Generator(cuda_device).manual_seed(xs_seed)
    xs = torch.randn((M, 1, T, cfg.d_model), generator=g,
                     device=cuda_device).bfloat16()
    outs = []
    for m in range(M):
        h = xs[m]
        for lp in layers:
            h = block(lp, h)
        outs.append(h)
    ref = torch.stack(outs)
    (ref.float() ** 2).mean().backward()
    out = res[-1]["out"].to(cuda_device)
    assert (out.float() - ref.float()).abs().max() <= (
        2e-2 * ref.float().abs().max())
    for r, w in zip(res, weights):
        for got, want in zip(leaves(r["grad"]), leaves(w)):
            got, want = got.to(cuda_device).float(), want.grad.float()
            assert (got - want).abs().max() <= 2e-2 * want.abs().max()
        assert r["launches"] == {"flash_attention": M,
                                 "flash_attention_bwd_dq": M,
                                 "flash_attention_bwd_dkv": M}
        assert all(v["simt_f32"] == 0 for v in r["routes"].values())


def test_two_rank_tensor_parallel_serving_sharing_the_card(cuda_device):
    """A reduced bf16 gemma3 (4 layers, a local window under the prompt's
    length, hd 64) served tensor-parallel on a (1, 2) mesh of ranks sharing
    the card (gloo, collectives through pinned host memory): each rank
    holds half of the heads, ff and vocab; the prefill step's logits, three
    teacher-forced decode steps' logits and the gathered cache against the
    whole-model run here within 2e-2 of max |reference| (bf16: the f32
    partial sums round once, in another order); K7 on the wgmma route on
    every rank."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import build
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import run_on_local_mesh

    from torch_spmd_ranks import tp_serve_rank

    cfg = dc.replace(get_config("gemma3-12b").reduced(), dtype="bfloat16",
                     head_dim=64, d_model=256, d_ff=512)
    build.load("flash_attention")            # built once, before the spawn
    model = LM(cfg)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    g = torch.Generator(cuda_device).manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (2, 40), generator=g,
                        device=cuda_device)
    steps = torch.randint(0, cfg.vocab, (2, 3), generator=g,
                          device=cuda_device)
    _, pre = TST.make_prefill_step(cfg)
    ref = pre(params, {"ids": ids})
    cache = model.init_cache(2, 43)
    model.prefill(params, ids, cache)
    _, dec = TST.make_decode_step(cfg)
    ref_dec = [dec(params, cache, {"ids": steps[:, j:j + 1],
                                   "pos": 40 + j})[0] for j in range(3)]
    res = run_on_local_mesh((1, 2), ("data", "model"), tp_serve_rank, cfg,
                            tree_map(lambda a: a.cpu(), params), ids.cpu(),
                            steps.cpu(), device="cuda", timeout=600)

    def close(got, want):
        want = want.float()
        assert (got.to(cuda_device).float() - want).abs().max() <= (
            2e-2 * want.abs().max())

    for r in res:
        assert r["all_dtensors"]
        assert r["shapes"]["layers/attn/wq"][0][2] == cfg.n_heads // 2
        assert r["shapes"]["layers/mlp/wi"][0][3] == cfg.d_ff // 2
        assert r["shapes"]["embed/table"][0][0] == cfg.vocab_padded // 2
        close(r["logits"], ref)
        for got, want in zip(r["decode"], ref_dec):
            close(got, want)
        assert r["k7_routes"]["wgmma_bf16"] == 2 * cfg.n_layers
        assert r["k7_routes"]["simt_f32"] == 0
    for name in ("k", "v"):
        full = torch.zeros(res[0]["cache"][name][2], dtype=torch.bfloat16)
        for r in res:
            local, bounds, _ = r["cache"][name]
            assert local.shape[3] == cfg.n_kv_heads // 2
            full[bounds] = local
        close(full, cache[name])


def test_two_rank_expert_parallel_serving_sharing_the_card(cuda_device):
    """A reduced bf16 moonshot (4 layers, hd 64, 8 experts, top 2) served
    expert-parallel on a (1, 2) mesh of ranks sharing the card (gloo,
    collectives through pinned host memory): each rank holds 4 of the 8
    experts, half of the heads and vocab; the whole-model run's routing,
    recorded here, pinned into the ranks; the prefill step's logits, three
    teacher-forced decode steps' logits and the gathered cache within 2e-2
    of max |reference|; the two ranks' own choices equal bit for bit; K7
    on the wgmma route on every rank."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import build
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import run_on_local_mesh

    from torch_spmd_ranks import PinRouting, tp_serve_rank

    cfg = dc.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                     dtype="bfloat16", head_dim=64, d_model=256, d_ff=256,
                     n_experts=8)
    build.load("flash_attention")            # built once, before the spawn
    model = LM(cfg)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    g = torch.Generator(cuda_device).manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (2, 40), generator=g,
                        device=cuda_device)
    steps = torch.randint(0, cfg.vocab, (2, 3), generator=g,
                          device=cuda_device)
    log = PinRouting()
    moe.ROUTING_HOOK = log
    try:
        _, pre = TST.make_prefill_step(cfg)
        log.phase = "p0"
        ref = pre(params, {"ids": ids})
        cache = model.init_cache(2, 43)
        log.phase = "fill"
        model.prefill(params, ids, cache)
        _, dec = TST.make_decode_step(cfg)
        ref_dec = []
        for j in range(3):
            log.phase = f"dec{j}"
            ref_dec.append(dec(params, cache, {"ids": steps[:, j:j + 1],
                                               "pos": 40 + j})[0])
    finally:
        moe.ROUTING_HOOK = None
    pins: dict = {}
    for (phase, _), calls in sorted(log.own.items()):
        pins.setdefault(phase, []).append(calls[0])
    res = run_on_local_mesh((1, 2), ("data", "model"), tp_serve_rank, cfg,
                            tree_map(lambda a: a.cpu(), params), ids.cpu(),
                            steps.cpu(), device="cuda", timeout=600,
                            pins=pins)

    def close(got, want):
        want = want.float()
        assert (got.to(cuda_device).float() - want).abs().max() <= (
            2e-2 * want.abs().max())

    for r in res:
        assert r["all_dtensors"]
        assert r["shapes"]["layers/moe/wi"][0][1] == cfg.n_experts // 2
        assert r["shapes"]["layers/moe/router"][0][2] == cfg.n_experts
        assert r["shapes"]["layers/attn/wq"][0][2] == cfg.n_heads // 2
        close(r["logits"], ref)
        for got, want in zip(r["decode"], ref_dec):
            close(got, want)
        assert r["k7_routes"]["wgmma_bf16"] == 2 * cfg.n_layers
        assert r["k7_routes"]["simt_f32"] == 0
        assert set(r["own"]) == set(res[0]["own"]) == set(log.own)
        for key, calls in r["own"].items():
            assert all(torch.equal(a, b)
                       for a, b in zip(calls, res[0]["own"][key])), key
    for name in ("k", "v"):
        full = torch.zeros(res[0]["cache"][name][2], dtype=torch.bfloat16)
        for r in res:
            local, bounds, _ = r["cache"][name]
            full[bounds] = local
        close(full, cache[name])
