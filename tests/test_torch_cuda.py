"""The port on the card: each CUDA tile kernel (K1-K4, with the edges of
its source-group partitioning and every group count) and matrix kernel
(K5, K6, K7, K7 batched) against its plain torch version, and the codec's
device path against its CPU path, byte for byte; the selective scan (K8)
against its plain version at rtol = atol = 2e-5 (y) and bit for bit
(h_last), over both of its bodies (the ring body at its stage and ring
edges, and at the RG-LRU scan's 32k shape), and its refusal of an operand that
requires grad; one reduced falcon-mamba, qwen2 or olmoe train step on the
card against the CPU; a reduced starcoder2, olmoe, recurrentgemma or
seamless-m4t f32 prefill and decode on the card against the CPU; the
RG-LRU scan's K8 route at N = 1 against K8's plain version and against
its associative-scan route. Every test is marked
``cuda`` and skips without a CUDA device (the kernels are CUDA C++ and
have no CPU mode). Imports nothing of JAX, so it runs where the port
runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import itertools

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.product_code import CoreCode, CoreCodec  # noqa: E402
from repro_torch.kernels import _build, ops, ragged_decode  # noqa: E402
from repro_torch.kernels.gf256_matmul import expand_coeff_bitplanes  # noqa: E402
from repro_torch.kernels.gf256_matmul import gf_matmul_plain  # noqa: E402
from repro_torch.kernels.xor_parity import xor_rows_plain  # noqa: E402

# C entry -> (port entry, GF?)
ENTRIES = {
    "ragged_gf256_tiles": (ops.gf256_ragged, True),
    "ragged_xor_tiles": (ops.xor_ragged, False),
    "ragged_gf256_encode_tiles": (ops.gf256_ragged_encode, True),
    "ragged_xor_encode_tiles": (ops.xor_ragged_encode, False),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


def _run(name, mc, data, device):
    fn, is_gf = ENTRIES[name]
    d = torch.from_numpy(data).to(device)
    out = fn(torch.from_numpy(mc).to(device), d) if is_gf else fn(d)
    return out.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_kernel_matches_plain(name, card):
    """C in both chunk rungs, K in {1, 3, 6, 9}, TN in {128, 1024, 4096},
    with and without zero padding (tails, K rows, a null tile)."""
    rng = np.random.default_rng(7)
    _build.reset_launches()
    cases = 0
    for c in (ragged_decode.CHUNK_SMALL, ragged_decode.CHUNK_BIG):
        for kk in (1, 3, 6, 9):
            for tn in (128, 1024, 4096):
                for pad in (False, True):
                    data = rng.integers(0, 256, (c, kk, tn), dtype=np.uint8)
                    coef = rng.integers(0, 256, (c, kk), dtype=np.uint8)
                    if pad:
                        data[:, kk - kk // 2 :] = 0
                        coef[:, kk - kk // 2 :] = 0
                        data[:, :, tn - tn // 3 :] = 0
                        data[-1] = 0
                        coef[-1] = 0
                    mc = expand_coeff_bitplanes(coef)
                    np.testing.assert_array_equal(
                        _run(name, mc, data, card), _run(name, mc, data, "cpu")
                    )
                    cases += 1
    assert _build.LAUNCHES[name] == cases
    assert sum(_build.LAUNCHES.values()) == cases


def _edge_tiles(rng, c, kk, tn):
    """Random tiles with every kind of staging zero at once: a null tile,
    zero tails past a ragged length, zero trailing K rows."""
    data = rng.integers(0, 256, (c, kk, tn), dtype=np.uint8)
    coef = rng.integers(0, 256, (c, kk), dtype=np.uint8)
    live_k, live_n = max(1, kk - kk // 3), max(1, tn - tn // 5 - 3)
    data[:, live_k:] = 0
    coef[:, live_k:] = 0
    data[:, :, live_n:] = 0
    data[c // 2] = 0
    coef[c // 2] = 0
    return expand_coeff_bitplanes(coef), data


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_kernel_matches_plain_at_partition_edges(name, card):
    """The boundaries of the tile bodies' partitioning: TN from one
    vector to the widest tuned tile, and 1040, not a multiple of a
    block's bytes; K from 1 to 16, with K = 3, 5, 6 and 9 not multiples
    of a source-group size; both chunk rungs; unpadded and with null
    tiles, zero tails and zero K rows. Then K = 1600, above the 1536
    sources the first design's shared-memory splat held."""
    rng = np.random.default_rng(17)
    _build.reset_launches()
    cases = 0
    for c in (ragged_decode.CHUNK_SMALL, ragged_decode.CHUNK_BIG):
        for kk in (1, 2, 3, 5, 6, 9, 16):
            for tn in (16, 128, 1040, 4096, 65536):
                for pad in (False, True):
                    if pad:
                        mc, data = _edge_tiles(rng, c, kk, tn)
                    else:
                        data = rng.integers(0, 256, (c, kk, tn), dtype=np.uint8)
                        mc = expand_coeff_bitplanes(
                            rng.integers(0, 256, (c, kk), dtype=np.uint8))
                    np.testing.assert_array_equal(
                        _run(name, mc, data, card), _run(name, mc, data, "cpu"),
                        err_msg=f"C={c} K={kk} TN={tn} pad={pad}")
                    cases += 1
    for tn in (16, 1040):
        mc, data = _edge_tiles(rng, 4, 1600, tn)
        np.testing.assert_array_equal(_run(name, mc, data, card), _run(name, mc, data, "cpu"))
        cases += 1
    assert _build.LAUNCHES[name] == cases
    assert sum(_build.LAUNCHES.values()) == cases


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(card):
    rng = np.random.default_rng(3)
    code = CoreCode(9, 6, 3)
    objs = rng.integers(0, 256, (3, 6, 4096), dtype=np.uint8)
    on_card = CoreCodec(code, device="cuda").encode(objs)
    assert on_card.device.type == "cuda"
    mat = on_card.cpu().numpy()
    np.testing.assert_array_equal(mat, CoreCodec(code, device="cpu").encode(objs).numpy())
    assert CoreCodec(code).verify(mat)


def _matrix_cases(card, b, m, kk, n, seed):
    """{C entry: (kernel result, plain result)} for one (B, M, K, N)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    data = torch.randint(0, 256, (b, kk, n), dtype=torch.uint8, device=card, generator=gen)
    coefs = np.random.default_rng(seed).integers(0, 256, (b, m, kk), dtype=np.uint8)
    want = gf_matmul_plain(ops._planes(coefs, data.device), data)
    want_x = xor_rows_plain(data)
    return {
        "gf256_matmul_planes_batched": (ops.gf256_matmul_batched(coefs, data), want),
        "gf256_matmul_planes": (ops.gf256_matmul(coefs[0], data[0]), want[0]),
        "xor_parity_batched": (ops.xor_parity_batched(data), want_x),
        "xor_parity": (ops.xor_parity(data[0]), want_x[0]),
    }


@pytest.mark.cuda
def test_matrix_kernels_match_plain(card):
    """K5, K6, K7 and K7 batched through ops (padding to a block_n
    multiple included): M in {1, 3, 6} (6 takes a second accumulator
    pass), K in {1, 3, 6, 9}, B in {1, 4}, N in {128, 4096, 5000, 2^20}."""
    _build.reset_launches()
    cases = 0
    for b in (1, 4):
        for m in (1, 3, 6):
            for kk in (1, 3, 6, 9):
                for n in (128, 4096, 5000, 1 << 20):
                    for name, (got, want) in _matrix_cases(card, b, m, kk, n, cases).items():
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), (name, b, m, kk, n)
                    cases += 1
    for name in ("gf256_matmul_planes", "gf256_matmul_planes_batched", "xor_parity",
                 "xor_parity_batched"):
        assert _build.LAUNCHES[name] == cases


@pytest.mark.cuda
def test_matrix_kernels_at_64_mib_batched(card):
    """One batched launch over more than 2^31 bytes (B = 8, K = 6,
    N = 64 MiB: 3.2 GB of sources): the byte axis on gridDim.x and the
    size_t offsets of csrc/gf_matmul_xor.cu."""
    for name, (got, want) in _matrix_cases(card, 8, 1, 6, 64 << 20, 11).items():
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


def _scan_inputs(card, b, s, d, n, seed):
    """da in U(0.6, 0.999), dbu, cm and h0 standard normal, on the card."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=card, generator=gen)
    da = torch.rand((b, s, d, n), **f32).mul_(0.399).add_(0.6)
    dbu = torch.randn((b, s, d, n), **f32)
    return da, dbu, torch.randn((b, s, n), **f32), torch.randn((b, d, n), **f32)


@pytest.mark.cuda
def test_selective_scan_matches_plain(card):
    """K8 over chip_smoke.py's phase 6(a) sweep: B in {1, 4, 32}, S = 1
    (the float4 body's one-step instance), every remainder of its 4-step
    load batches and the prefill chunk, D in {200, 1000, 8192} (200 and
    1000 leave a ragged last block), N from 1 to 32 (the ring body at 1
    and 2), with and without h0; y within 2e-5, h_last bit-equal (both sides update h with a
    multiply, then an add)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    _build.reset_launches()
    cases = 0
    for b, s, d, n in itertools.product((1, 4, 32), (1, 2, 3, 7, 8, 9, 16, 128),
                                        (200, 1000, 8192), (1, 2, 4, 8, 16, 32)):
        da, dbu, cm, h0 = _scan_inputs(card, b, s, d, n, cases)
        for start in (None, h0):
            y, h = selective_scan(da, dbu, cm, h0=start, return_state=True)
            want_y, want_h = selective_scan_plain(da, dbu, cm, start)
            where = (b, s, d, n, start is not None)
            torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5, msg=str(where))
            assert torch.equal(h, want_h), where
            cases += 1
        del da, dbu, cm, h0, y, h, want_y, want_h
    assert _build.LAUNCHES["selective_scan"] == cases


@pytest.mark.cuda
def test_selective_scan_ring_body_matches_plain(card):
    """K8's ring body (N in {1, 2}) at its edges: B in {1, 4} (4 stages at
    B = 1, D = 4096; 2 at B = 4, D = 4096), S = 1, a stage of 16
    steps +- 1, 128 steps +- 1, the profiled prefill's 2048 and 4099
    (ending inside a stage), D in {200, 1000, 1001, 4096} (200 and 1000
    leave a ragged last group of 32 columns, 1001 takes the 4-byte
    copies), with and without h0; y within 2e-5, h_last bit-equal (each
    column's h is one sequential chain of a multiply, then an add, in
    both)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    _build.reset_launches()
    cases = 0
    for b, s, d, n in itertools.product((1, 4), (1, 15, 16, 17, 127, 128, 129, 2048, 4099),
                                        (200, 1000, 1001, 4096), (1, 2)):
        da, dbu, cm, h0 = _scan_inputs(card, b, s, d, n, 100 + cases)
        for start in (None, h0):
            y, h = selective_scan(da, dbu, cm, h0=start, return_state=True)
            want_y, want_h = selective_scan_plain(da, dbu, cm, start)
            where = (b, s, d, n, start is not None)
            torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5, msg=str(where))
            assert torch.equal(h, want_h), where
            cases += 1
        del da, dbu, cm, h0, y, h, want_y, want_h
    assert _build.LAUNCHES["selective_scan"] == cases


@pytest.mark.cuda
def test_selective_scan_ring_body_any_alignment(card):
    """da and dbu views one float past a 16-byte boundary: the ring body
    takes its 4-byte copies; y within 2e-5, h_last bit-equal."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    for n in (1, 2):
        da, dbu, cm, h0 = _scan_inputs(card, 2, 129, 4096, n, 31 + n)
        shape = da.shape
        views = []
        for t in (da, dbu):
            flat = torch.empty(t.numel() + 1, device=card)
            flat[1:] = t.reshape(-1)
            views.append(flat[1:].view(shape))
        assert views[0].data_ptr() % 16 == 4
        y, h = selective_scan(*views, cm, h0=h0, return_state=True)
        want_y, want_h = selective_scan_plain(da, dbu, cm, h0)
        torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
        assert torch.equal(h, want_h)


@pytest.mark.cuda
def test_selective_scan_rglru_32k_matches_plain(card):
    """The RG-LRU scan's 32k prefill shape (1, 32768, 4096, 1) from h0,
    once: y within 2e-5, h_last bit-equal to the plain version."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    da, dbu, cm, h0 = _scan_inputs(card, 1, 32768, 4096, 1, 7)
    y, h = selective_scan(da, dbu, cm, h0=h0, return_state=True)
    want_y, want_h = selective_scan_plain(da, dbu, cm, h0)
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    assert torch.equal(h, want_h)


@pytest.mark.cuda
def test_selective_scan_size_t_offsets(card):
    """One launch past 2^32 elements (B = 1, S = 32768, D = 8192, N = 16:
    34 GB of da and dbu) where the card holds it, else S = 16384 (2^31)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    free, _total = torch.cuda.mem_get_info(card)
    s = 32768 if free > 48e9 else 16384
    da, dbu, cm, h0 = _scan_inputs(card, 1, s, 8192, 16, 5)
    y, h = selective_scan(da, dbu, cm, h0=h0, return_state=True)
    want_y, want_h = selective_scan_plain(da, dbu, cm, h0)
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h, want_h, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_selective_scan_refuses_grad_on_the_card(card):
    """K8 has no backward: an operand on the card that requires grad
    raises under grad mode, and nothing is launched; the same call
    without grad launches once."""
    from repro_torch.kernels.selective_scan import selective_scan

    da, dbu, cm, h0 = _scan_inputs(card, 4, 1, 8192, 16, 11)
    _build.reset_launches()
    for t in (da, dbu, cm, h0):
        t.requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            selective_scan(da, dbu, cm, h0=h0, return_state=True)
        t.requires_grad_(False)
    assert _build.LAUNCHES["selective_scan"] == 0
    dbu.requires_grad_(True)
    with torch.no_grad():
        selective_scan(da, dbu, cm, h0=h0, return_state=True)
    assert _build.LAUNCHES["selective_scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "qwen2_72b", "olmoe_1b_7b"])
def test_reduced_train_step_card_matches_cpu(arch, card, monkeypatch):
    """One train step of the reduced falcon-mamba, qwen2 or olmoe (2 layers) in float32,
    TF32 off, from the same weights on the card and on the CPU: the loss
    within rtol = atol = 1e-4, each gradient leaf within 1e-3 of its max
    |CPU|, the parameters after the update within 1e-5 (a tenth of the
    step's learning rate), and K8 never launched by the step. The card's
    copy of the weights goes through ``models.convert`` both ways."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_config(arch).reduced(num_layers=2)
    api = get_model(cfg)
    oc = opt.OptConfig(lr=1e-4, warmup_steps=1)
    cpu = api.init(cfg, 0, device="cpu", dtype=torch.float32).requires_grad_(True)
    models = {"cpu": cpu, "cuda": convert.from_jax(convert.to_reference_tree(cpu), cfg,
                                                   device=card, trainable=True)}
    batch = SyntheticPipeline(cfg, 32, 2, 0).batch_at(0)
    step = ts.make_train_step(cfg, api, SINGLE, oc)
    out = {}
    _build.reset_launches()
    for dev, model in models.items():
        loss = api.loss(model, batch, cfg, SINGLE)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        state = ts.TrainState(model, opt.init_opt_state(convert.stacked_tree(model), oc),
                              torch.zeros((), dtype=torch.int32, device=model.device))
        state, metrics = step(state, batch)
        out[dev] = (float(metrics["loss"]), [g.cpu() for g in grads],
                    [p.detach().cpu() for p in state.params.parameters()])
    assert _build.LAUNCHES["selective_scan"] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4, abs=1e-4)
    for g, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - want).abs().max()) <= 1e-3 * float(want.abs().max())
    for p, want in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(p, want, rtol=0, atol=1e-5)


def _bf16_neighbours(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elements where two bf16 tensors hold adjacent bf16 values."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2_15b", "olmoe_1b_7b"])
def test_reduced_dense_prefill_decode_card_matches_cpu(arch, card, monkeypatch):
    """The reduced starcoder2 (layernorm, biases, gelu, GQA, a 64-token
    window) or olmoe (8 experts, top 2) in float32, TF32 off, from the same weights on the card and
    on the CPU: the prefill logits within rtol = atol = 1e-4, its bf16
    caches too except for one-ulp neighbours (float32-sized differences
    round k or v to the next bf16 value) in at most 1e-3 of the
    elements; then two decode steps from the CPU's prefill cache cast to
    float32, on both devices (every step of the decode float32), logits
    and caches within rtol = atol = 1e-4. No kernel is launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cpu = api.init(cfg, 0, device="cpu", dtype=torch.float32)
    models = {"cpu": cpu, "cuda": convert.from_jax(convert.to_reference_tree(cpu), cfg,
                                                   device=card)}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)))
    _build.reset_launches()
    out = {dev: api.prefill(m, {"tokens": tokens}, cfg, SINGLE, 128)
           for dev, m in models.items()}
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        got, want = out["cuda"][1][k].cpu(), out["cpu"][1][k]
        bad = ~torch.isclose(got.float(), want.float(), rtol=1e-4, atol=1e-4)
        flips = bad & _bf16_neighbours(got, want)
        assert int(flips.sum()) <= 1e-3 * got.numel() and not (bad & ~flips).any()
    f32 = {k: v.float() for k, v in out["cpu"][1].items()}
    caches = {"cpu": f32, "cuda": {k: v.to(card) for k, v in f32.items()}}
    nxt = out["cpu"][0].argmax(-1, keepdim=True)
    for pos in (64, 65):
        step = {}
        for dev, m in models.items():
            step[dev] = api.decode(m, nxt.to(m.device), caches[dev], pos, cfg, SINGLE, None)
            caches[dev] = step[dev][1]
        torch.testing.assert_close(step["cuda"][0].cpu(), step["cpu"][0], rtol=1e-4, atol=1e-4)
        for k in ("k", "v"):
            torch.testing.assert_close(step["cuda"][1][k].cpu(), step["cpu"][1][k], rtol=1e-4,
                                       atol=1e-4)
        nxt = step["cpu"][0].argmax(-1, keepdim=True)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "seamless_m4t_large_v2"])
def test_reduced_hybrid_encdec_prefill_decode_card_matches_cpu(arch, card, monkeypatch):
    """The reduced recurrentgemma (one (rec, rec, attn) group and a rec
    tail, an 80-token prompt over its 64-slot window) or seamless-m4t
    (2 + 2 layers, 8 encoder frames) in float32, TF32 off, from the same
    weights on the card and on the CPU, with the tolerances of
    ``test_reduced_dense_prefill_decode_card_matches_cpu`` over every
    leaf of the cache tree. The hybrid prefill launches K8 once per rec
    block (3) and its decode none; the encdec path none."""
    from repro_torch.configs import get_config
    from repro_torch.models import convert
    from repro_torch.models.registry import get_model
    from repro_torch.models.shardings import SINGLE
    from repro_torch.models.stack import tree_map, tree_paths

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cpu = api.init(cfg, 0, device="cpu", dtype=torch.float32)
    models = {"cpu": cpu, "cuda": convert.from_jax(convert.to_reference_tree(cpu), cfg,
                                                   device=card)}
    rng = np.random.default_rng(0)
    s = 80 if cfg.family == "hybrid" else 64
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s)))}
    if cfg.family == "encdec":
        frames = rng.standard_normal((2, cfg.num_stub_tokens, cfg.d_model)).astype(np.float32)
        batch["src_embed"] = torch.from_numpy(frames).to(torch.bfloat16)
    _build.reset_launches()
    out = {dev: api.prefill(m, {k: v.to(m.device) for k, v in batch.items()}, cfg, SINGLE,
                            128) for dev, m in models.items()}
    want_k8 = 3 if cfg.family == "hybrid" else 0
    assert _build.LAUNCHES["selective_scan"] == want_k8
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=1e-4, atol=1e-4)
    card_cache, cpu_cache = tree_paths(out["cuda"][1]), tree_paths(out["cpu"][1])
    assert set(card_cache) == set(cpu_cache)
    for name, want in cpu_cache.items():
        got = card_cache[name].cpu()
        assert got.dtype == want.dtype, name
        bad = ~torch.isclose(got.float(), want.float(), rtol=1e-4, atol=1e-4)
        if got.dtype == torch.bfloat16:
            flips = bad & _bf16_neighbours(got, want)
            assert int(flips.sum()) <= 1e-3 * got.numel(), name
            bad &= ~flips
        assert not bad.any(), name
    f32 = tree_map(lambda t: t.float(), out["cpu"][1])
    caches = {"cpu": f32, "cuda": tree_map(lambda t: t.to(card), f32)}
    nxt = out["cpu"][0].argmax(-1, keepdim=True)
    for pos in (s, s + 1):
        step = {}
        for dev, m in models.items():
            step[dev] = api.decode(m, nxt.to(m.device), caches[dev], pos, cfg, SINGLE, None)
            caches[dev] = step[dev][1]
        torch.testing.assert_close(step["cuda"][0].cpu(), step["cpu"][0], rtol=1e-4, atol=1e-4)
        card_cache, cpu_cache = tree_paths(step["cuda"][1]), tree_paths(step["cpu"][1])
        for name, want in cpu_cache.items():
            torch.testing.assert_close(card_cache[name].cpu(), want, rtol=1e-4, atol=1e-4)
        nxt = step["cpu"][0].argmax(-1, keepdim=True)
    assert _build.LAUNCHES["selective_scan"] == want_k8
    assert sum(_build.LAUNCHES.values()) == want_k8


@pytest.mark.cuda
def test_hybrid_k8_route_matches_plain(card):
    """The RG-LRU scan's K8 route at N = 1 (da = a, dbu = b, cm = 1) on
    the card, at recurrentgemma-9b's width (4096) over 512 steps from
    h0: the kernel's y and h_last against K8's plain version on the same
    operands (y within 2e-5, h_last bit-equal), and ``rglru_scan``
    without grad (one launch) against its associative-scan route under
    grad (no launch) within 2e-5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain
    from repro_torch.models import rglru

    cfg = get_config("recurrentgemma_9b")
    gen = torch.Generator(device=card).manual_seed(3)
    p = rglru.RgLru(cfg, gen, torch.float32, card)
    x = torch.randn((1, 512, cfg.lru_width), generator=gen, device=card)
    h0 = torch.randn((1, cfg.lru_width), generator=gen, device=card)
    log_a, gated = rglru._gates(x, p, cfg)
    a = torch.exp(log_a).reshape(1, 512, -1, 1)
    b = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated)
    b = b.reshape(1, 512, -1, 1)
    ones = torch.ones((1, 512, 1), device=card)
    y, h = selective_scan(a, b, ones, h0=h0[..., None], return_state=True)
    want_y, want_h = selective_scan_plain(a, b, ones, h0[..., None])
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
    assert torch.equal(h, want_h)

    _build.reset_launches()
    with torch.no_grad():
        ky, kh = rglru.rglru_scan(x, p, cfg, h0)
    assert _build.LAUNCHES["selective_scan"] == 1
    gy, gh = rglru.rglru_scan(x.clone().requires_grad_(True), p, cfg, h0)
    assert _build.LAUNCHES["selective_scan"] == 1 and gy.requires_grad
    torch.testing.assert_close(ky, gy.detach(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(kh, gh.detach(), rtol=2e-5, atol=2e-5)
