"""The port's CUDA kernels against their plain versions, and the
training step on the card against the CPU's, on the GPU.

Imports neither JAX nor the JAX package, so the file also runs on a GPU
machine without them (``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py``). Every test skips in its body where no CUDA
device is present."""

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.index import search
from evossearch_tpu_torch.ops import topk

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


def _exact_inputs(seed, n, d, q):
    """Small integers over 16: exact dots in any order, real ties."""
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy((rng.integers(-4, 5, (n, d)) / 16).astype(np.float32))
    queries = torch.from_numpy((rng.integers(-4, 5, (q, d)) / 16).astype(np.float32))
    return emb, queries


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 512, 768])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_kernel_equals_plain(dtype, d):
    """Bit for bit on exact-dot inputs: two partial last tiles, the serving
    buckets (1, 8, 64, 128), Q = 48 and Q = 45 (a partial 8- and 16-query
    tile), levels 3 and 4; at d = 768 and Q = 128 the bf16 path cuts the
    queries into chunks."""
    _need_gpu()
    for n in (70_001, 300_007):
        emb, q = _exact_inputs(51, n, d, 128)
        e, q = emb.to(DTYPES[dtype]).cuda(), q.cuda()
        for nq in (1, 8, 45, 48, 64, 128):
            for levels in (3, 4):
                before = topk.LAUNCHES["block"]
                got = topk.block_candidates(e, q[:nq], levels)
                assert topk.LAUNCHES["block"] == before + 1
                want = topk.block_candidates_plain(e, q[:nq], levels)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (n, nq, levels)


# over the 67,106,816 rows (cdiv(n, 2048) * 2 blocks in a grid's y) that the
# block kernel once could not launch past; the last tile is partial
PAST_OLD_GRID_CAP = 67_110_913


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_kernel_past_the_old_grid_cap(dtype):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(62)
    n, d, chunk = PAST_OLD_GRID_CAP, 128, 1 << 20
    # filled in chunks: integers over the whole shape at once would take
    # bytes of int64 the card does not have
    e = torch.empty((n, d), dtype=DTYPES[dtype], device="cuda")
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        e[s : s + m] = torch.randint(-4, 5, (m, d), generator=gen, device="cuda",
                                     dtype=torch.int8).to(e.dtype) / 16
    q = torch.randint(-4, 5, (8, d), generator=gen, device="cuda").float() / 16
    before = topk.LAUNCHES["block"]
    got = topk.block_candidates(e, q, 4)
    assert topk.LAUNCHES["block"] == before + 1
    want = topk.block_candidates_plain(e, q, 4)
    assert got[0].shape == (4, -(-n // 2048) * 8, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_rows", [512, None])
def test_tree_kernel_equals_plain(dtype, tile_rows):
    _need_gpu()
    tdt = DTYPES[dtype]
    tile_rows = tile_rows or topk._tree_tile_rows(tdt)
    emb, q = _exact_inputs(52, 70_001, 256, 7)
    e, q = emb.to(tdt).cuda(), q.cuda()
    before = topk.LAUNCHES["tree"]
    got = topk.tree_candidates(e, q, tile_rows)
    assert topk.LAUNCHES["tree"] == before + 1
    want = topk.tree_candidates_plain(e, q, tile_rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_launches_counted_by_corpus_dtype(dtype):
    """A launch on an f32 corpus counts under "<name>_f32" and one on a
    bf16 corpus under the kernel's name, beside the per-kernel count."""
    _need_gpu()
    tdt = DTYPES[dtype]
    emb, q = _exact_inputs(58, 70_001, 256, 7)
    e, q = emb.to(tdt).cuda(), q.cuda()
    for name, call in (("tree", lambda: topk.tree_candidates(e, q, 512)),
                       ("block", lambda: topk.block_candidates(e, q))):
        key = f"{name}_f32" if dtype == "f32" else name
        before, by_dtype = topk.LAUNCHES[name], dict(topk.DTYPE_LAUNCHES)
        call()
        torch.cuda.synchronize()
        assert topk.LAUNCHES[name] == before + 1
        by_dtype[key] += 1
        assert topk.DTYPE_LAUNCHES == by_dtype


@pytest.mark.gpu
@pytest.mark.parametrize("tile_rows", [512, 16384])
def test_tree_bf16_tensor_core_kernel_equals_plain(tile_rows):
    """The bf16 path on the tensor cores, bit for bit on exact-dot inputs:
    every query bucket, Q = 48, and Q = 96 (the ring of 4, 3 and 2 slots
    at d = 512); tile 512 gives 32-class blocks, the 5 tiles of 16384
    16-class blocks; d = 768 at Q = 128 cuts the queries into chunks."""
    _need_gpu()
    for d, counts in ((512, (1, 8, 48, 64, 96, 128)), (768, (128,))):
        emb, q = _exact_inputs(59, 70_001, d, 128)
        e, q = emb.to(torch.bfloat16).cuda(), q.cuda()
        for nq in counts:
            before = topk.LAUNCHES["tree"]
            got = topk.tree_candidates(e, q[:nq], tile_rows)
            assert topk.LAUNCHES["tree"] == before + 1
            want = topk.tree_candidates_plain(e, q[:nq], tile_rows)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (d, nq)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_rows", [512, 8192])
def test_tree_f32_tensor_core_kernel_equals_plain(tile_rows):
    """The f32 path (three TF32 passes), bit for bit on exact-dot inputs,
    where every split's small part is 0: every query bucket, Q = 48, 65 (two
    chunks of at most 64 f32 queries) and 96; d = 768 and 1024 cut the
    queries into narrower chunks."""
    _need_gpu()
    for d, counts in ((512, (1, 8, 48, 64, 65, 96, 128)), (768, (128,)), (1024, (48,))):
        emb, q = _exact_inputs(63, 70_001, d, 128)
        e, q = emb.cuda(), q.cuda()
        for nq in counts:
            before = topk.LAUNCHES["tree"]
            got = topk.tree_candidates(e, q[:nq], tile_rows)
            assert topk.LAUNCHES["tree"] == before + 1
            want = topk.tree_candidates_plain(e, q[:nq], tile_rows)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (d, nq)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["block", "tree"])
def test_f32_kernels_stay_within_the_split_error_model(kernel):
    """On cancellation-heavy f32 rows (full mantissas, alternating signs,
    magnitudes spanning 2^14) every emitted score is within
    (2^-19 + 2*d*2^-24)*sum|x*q| of its float64 dot (ops/csrc/topk_tc.cuh),
    and on unit rows within 1e-5 of the plain version."""
    _need_gpu()
    rng = np.random.default_rng(64)
    n, d = 70_001, 512
    sign = np.where(np.arange(d) % 2, -1.0, 1.0)
    x = (rng.random((n, d)) + 0.5) * 2.0 ** -rng.integers(0, 14, (n, d)) * sign
    q = (rng.random((16, d)) + 0.5) * 2.0 ** -rng.integers(0, 14, (16, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = torch.from_numpy(x.astype(np.float32)).cuda()
    qt = torch.from_numpy(q.astype(np.float32)).cuda()
    if kernel == "tree":
        s, i, _ = topk.tree_candidates(e, qt, 8192)
        s, i = s.cpu().numpy(), i.cpu().numpy()
    else:
        out_s, out_i = topk.block_candidates(e, qt, 4)
        s = out_s[:3].permute(2, 1, 0).reshape(16, -1).cpu().numpy()
        i = out_i.permute(2, 1, 0).reshape(16, -1).cpu().numpy()
    x64 = x.astype(np.float32).astype(np.float64)
    q64 = q.astype(np.float32).astype(np.float64)
    unit = 2.0 ** -19 + 2 * d * 2.0 ** -24
    for j in range(16):
        live = (i[j] < n) & (s[j] > topk.NEG_INF)
        p = x64[i[j][live]] * q64[j]
        assert (np.abs(s[j][live] - p.sum(1)) <= unit * np.abs(p).sum(1)).all(), j
    u = torch.randn(n, d, device="cuda")
    u /= torch.linalg.norm(u, dim=1, keepdim=True)
    uq = torch.nn.functional.normalize(torch.randn(48, d, device="cuda"), dim=1)
    if kernel == "tree":
        got, want = topk.tree_candidates(u, uq, 8192), topk.tree_candidates_plain(u, uq, 8192)
    else:
        got, want = topk.block_candidates(u, uq, 4), topk.block_candidates_plain(u, uq, 4)
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tree_kernel_at_the_largest_corpus(dtype):
    """The tree kernel over 67,110,913 rows of d = 128 (its grid holds the
    tiles in x on both dtypes), bit for bit on exact-dot inputs."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(65)
    n, d, chunk = PAST_OLD_GRID_CAP, 128, 1 << 20
    e = torch.empty((n, d), dtype=DTYPES[dtype], device="cuda")
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        e[s : s + m] = torch.randint(-4, 5, (m, d), generator=gen, device="cuda",
                                     dtype=torch.int8).to(e.dtype) / 16
    q = torch.randint(-4, 5, (8, d), generator=gen, device="cuda").float() / 16
    tile = topk._tree_tile_rows(DTYPES[dtype])
    got = topk.tree_candidates(e, q, tile)
    want = topk.tree_candidates_plain(e, q, tile)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_search_on_gpu_equals_cpu():
    _need_gpu()
    emb, q = _exact_inputs(53, 300_000, 128, 9)
    for dtype in DTYPES.values():
        e = emb.to(dtype)
        want = search.exact_search_batch(e, q, 48)
        got = search.best_exact_search_batch(e.cuda(), q, 48)  # the kernels
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.gpu
def test_matmul_f32_bf16_gemm_equals_widened_product():
    _need_gpu()
    from evossearch_tpu_torch.models.layers import matmul_f32

    gen = torch.Generator().manual_seed(54)
    logits = (torch.randn(2, 3, 50, 64, generator=gen),
              torch.randn(2, 3, 64, 50, generator=gen))
    dense = (torch.randn(2, 50, 768, generator=gen), torch.randn(768, 96, generator=gen))
    for a, b in (logits, dense):
        a, b = a.bfloat16().cuda(), b.bfloat16().cuda()
        got = matmul_f32(a, b)  # bf16 x bf16 -> f32 on the tensor cores
        want = torch.matmul(a.float(), b.float())  # f32 SGEMM, no TF32
        assert got.dtype == torch.float32 and got.shape == want.shape
        # bf16 products are exact in f32: only the summation order differs
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# (queries, tile rows) of the SQ8 kernels' cases: 45 a partial 8-query
# tile, the serving buckets and Q = 48 at the serving tile
SQ8_CASES = ((45, 512),) + tuple((nq, topk.SQ8_TILE_ROWS) for nq in (1, 8, 45, 48, 64, 128))


@pytest.mark.gpu
def test_sq8_kernel_equals_plain():
    _need_gpu()
    rng = np.random.default_rng(55)
    n, d = 70_001, 256
    e8 = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).cuda()
    scal2 = torch.from_numpy(np.stack([
        (2.0 ** -rng.integers(5, 10, n)).astype(np.float32),
        (rng.random(n) * 1e-2).astype(np.float32),
    ])).cuda()
    _, q = _exact_inputs(56, 1, d, 128)
    q = q.cuda()
    qn = torch.linalg.norm(q, dim=1)
    # tiles of 512 and the serving tile; 70,001 rows leave a partial last
    # tile and n % 4 != 0, so radd = scal2[1] starts off 16-byte alignment
    for nq, tile in SQ8_CASES:
        before = topk.LAUNCHES["sq8"]
        got = topk.sq8_candidates(e8, scal2, q[:nq], qn[:nq], tile)
        assert topk.LAUNCHES["sq8"] == before + 1
        want = topk.sq8_candidates_plain(e8, scal2, q[:nq], qn[:nq], tile)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(topk.SQ8_VARIANTS))
def test_sq8_variant_kernels_equal_plain(variant):
    _need_gpu()
    rng = np.random.default_rng(60)
    n, d = 70_001, 256
    e8 = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    corpus = (e8.float().to(torch.bfloat16) if variant == "bf16_struct" else e8).cuda()
    scal2 = torch.from_numpy(np.stack([
        (2.0 ** -rng.integers(5, 10, n)).astype(np.float32),
        (rng.random(n) * 1e-2).astype(np.float32),
    ])).cuda()
    _, q = _exact_inputs(61, 1, d, 128)
    q = q.cuda()
    qn = torch.linalg.norm(q, dim=1)
    for nq, tile in SQ8_CASES:
        before = topk.LAUNCHES["sq8_variant"]
        got = topk.sq8_variant_candidates(corpus, scal2, q[:nq], qn[:nq], variant, tile)
        assert topk.LAUNCHES["sq8_variant"] == before + 1
        want = topk.sq8_variant_candidates_plain(corpus, scal2, q[:nq], qn[:nq],
                                                 variant, tile)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_kernel_equals_plain(dtype):
    """Bit for bit on exact-dot inputs (a query of norm exactly 1): at
    k = 1, 7, 48 and 128 (``block_rows`` is checked, never used); on a
    plateau of rows tied at the best score around every block boundary of
    the persistent grid; on strictly ascending scores; at n = 1, 40 and
    one tile past one tile per block; fewer rows than k pad with
    (NEG_INF, -1)."""
    _need_gpu()
    rng = np.random.default_rng(57)
    emb, _ = _exact_inputs(58, 70_001, 512, 1)
    q = np.zeros(512, np.float32)  # 256 entries of +-1/16: norm exactly 1
    q[rng.choice(512, 256, replace=False)] = rng.choice([-1.0, 1.0], 256) / 16
    e, q = emb.to(DTYPES[dtype]).cuda(), torch.from_numpy(q).cuda()

    def same(e, q, k, block_rows=2048):
        before = topk.LAUNCHES["stream"]
        got = topk.fused_topk(e, q, k, block_rows)
        assert topk.LAUNCHES["stream"] == before + 1
        want = topk.fused_topk_plain(e, q, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (e.shape, k)

    for k, block_rows in ((48, 2048), (128, 2048), (7, 128), (128, 4096), (1, 2048)):
        same(e, q, k, block_rows)
    sms = torch.cuda.get_device_properties(e.device).multi_processor_count
    tile, blocks = topk._stream_layout(e.shape[0], 512, e.element_size(), sms)
    tiles = -(-e.shape[0] // tile)
    edges = [b * tiles // blocks * tile for b in range(1, blocks)]
    plateau = e.clone()
    plateau[[r + j for r in edges for j in (-2, -1, 0, 1)]] = (torch.sign(q) / 4).to(e.dtype)
    bits = torch.arange(0x80, 0x80 + 20_000, dtype=torch.int32)
    ascending = torch.zeros(20_000, 512, dtype=torch.bfloat16)
    ascending[:, 0] = bits.to(torch.int16).view(torch.bfloat16)  # strictly ascending
    e0 = torch.zeros(512, device="cuda")
    e0[0] = 1.0
    for k in (1, 48, 128):
        same(plateau, q, k)
        same(ascending.to(e.dtype).cuda(), e0, k)
        for n in (1, 40, blocks * tile + 1):
            same(e[:n], q, k)
    # fewer rows than k: padded slots read (NEG_INF, -1)
    s, i = topk.fused_topk(e[:40], q, 48)
    assert torch.equal(i[40:].cpu(), torch.full((8,), -1))


def _planes(seed, sizes):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8),
             rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8))
            for h, w in sizes]


@pytest.mark.gpu
def test_planar_device_preprocess_on_gpu_equals_cpu():
    """Within 1e-4 in normalized units but for round-half flips of the two
    devices' summation orders (at most 2 8-bit steps, on at most 0.1% of
    values)."""
    _need_gpu()
    from evossearch_tpu_torch.preprocess import (
        device_preprocess_planar_indexed,
        prepare_batch_planar,
    )

    prepared = prepare_batch_planar(
        _planes(7, [(240, 320), (101, 133), (480, 360), (1000, 750)]), 224)
    cpu = device_preprocess_planar_indexed(*(torch.from_numpy(a) for a in prepared))
    gpu = device_preprocess_planar_indexed(
        *(torch.from_numpy(a).cuda() for a in prepared)).cpu()
    diff = (gpu - cpu).abs()
    assert gpu.shape == (4, 224, 224, 3)
    assert (diff > 1e-4).float().mean() <= 1e-3
    assert diff.max() <= 2 / (255 * 0.26130258) + 1e-4


def openai_state_dict(spec, seed: int = 0, dtype=torch.float16) -> dict:
    """A seeded state dict in the OpenAI release layout for a ViT ``spec``
    (fp16 tensors, as the release files hold them)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def t(key, *shape, scale=None, base=0.0):
        scale = shape[-1] ** -0.5 if scale is None else scale
        sd[key] = (base + scale * torch.randn(*shape, generator=gen)).to(dtype)

    def tower(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                t(f"{p}.{ln}.weight", width, scale=0.1, base=1.0)
                t(f"{p}.{ln}.bias", width, scale=0.1)
            t(f"{p}.attn.in_proj_weight", 3 * width, width)
            t(f"{p}.attn.in_proj_bias", 3 * width, scale=0.02)
            t(f"{p}.attn.out_proj.weight", width, width)
            t(f"{p}.attn.out_proj.bias", width, scale=0.02)
            t(f"{p}.mlp.c_fc.weight", 4 * width, width)
            t(f"{p}.mlp.c_fc.bias", 4 * width, scale=0.02)
            t(f"{p}.mlp.c_proj.weight", width, 4 * width)
            t(f"{p}.mlp.c_proj.bias", width, scale=0.02)

    vw, tw, p = spec.vision_width, spec.text_width, spec.patch_size
    grid = spec.image_size // p
    t("visual.conv1.weight", vw, 3, p, p, scale=(3 * p * p) ** -0.5)
    t("visual.class_embedding", vw)
    t("visual.positional_embedding", grid * grid + 1, vw)
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        width = tw if ln == "ln_final" else vw
        t(f"{ln}.weight", width, scale=0.1, base=1.0)
        t(f"{ln}.bias", width, scale=0.1)
    tower("visual.transformer", vw, spec.vision_layers)
    t("visual.proj", vw, spec.embed_dim, scale=vw ** -0.5)
    t("token_embedding.weight", spec.vocab_size, tw, scale=0.02)
    t("positional_embedding", spec.context_length, tw, scale=0.01)
    tower("transformer", tw, spec.text_layers)
    t("text_projection", tw, spec.embed_dim, scale=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(4.6052, dtype=dtype)
    return sd


@pytest.mark.gpu
def test_openai_checkpoint_loads_on_gpu(tmp_path):
    """An engine on the card started from an OpenAI-layout ``.pt`` runs
    the inferred spec and matches the same file on the CPU (f32 compute)."""
    _need_gpu()
    from evossearch_tpu_torch.core import CLIPModelSpec, Config
    from evossearch_tpu_torch.engine import SearchEngine

    spec = CLIPModelSpec(
        name="custom-p16", image_size=64, patch_size=16, vision_width=128,
        vision_layers=2, vision_heads=2, text_width=64, text_layers=2,
        text_heads=1, vocab_size=49408, context_length=77, embed_dim=32,
    )
    path = tmp_path / "tiny.pt"
    torch.save(openai_state_dict(spec), path)
    engines = []
    for device in ("cuda", "cpu"):
        cfg = Config(env_path=tmp_path / "missing.env")
        cfg.CHECKPOINT_PATH, cfg.COMPUTE_DTYPE = str(path), "float32"
        engines.append(SearchEngine(cfg=cfg, device=device))
    gpu, cpu = engines
    try:
        assert gpu.spec == cpu.spec == spec
        assert next(gpu.params.parameters()).is_cuda
        rng = np.random.default_rng(8)
        images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                  for hw in ((64, 64), (90, 120))]
        np.testing.assert_allclose(gpu.encode_images(images), cpu.encode_images(images),
                                   atol=1e-4)
        np.testing.assert_allclose(gpu.encode_text("a red car"), cpu.encode_text("a red car"),
                                   atol=1e-4)
    finally:
        for eng in engines:
            eng.close()


def _random_bn_(model, seed):
    """Random BatchNorm gammas, betas and statistics (var > 0) in place:
    OpenAI's zero bn3 init would make every residual branch vanish."""
    from evossearch_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.scale.shape[0]
                mod.scale.copy_(0.5 + torch.rand(c, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.mean.copy_(0.2 * torch.randn(c, generator=gen))
                mod.var.copy_(0.5 + torch.rand(c, generator=gen))
    return model


@pytest.mark.gpu
def test_rn50_on_gpu_matches_cpu():
    """The full-width RN50 tower on the card against the CPU, both f32
    (TF32 off inside the forward: cosine >= 0.9999), and the card's bf16
    against the CPU's f32 (cosine >= 0.995)."""
    _need_gpu()
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
    from evossearch_tpu_torch.models import CLIP, encode_image

    spec = CLIP_MODEL_SPECS["RN50"]
    cpu = _random_bn_(CLIP(spec).init_random_(torch.Generator().manual_seed(0)), 1).eval()
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, spec.image_size, spec.image_size, 3)).astype(np.float32))
    want = encode_image(cpu, images)
    gpu = cpu.to("cuda")
    got = encode_image(gpu, images.cuda()).cpu()
    got_bf16 = encode_image(gpu, images.cuda(), torch.bfloat16).cpu()
    assert ((got * want).sum(-1) >= 0.9999).all()
    assert ((got_bf16 * want).sum(-1) >= 0.995).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ivf_on_gpu_matches_cpu(dtype, tmp_path):
    """One IVF sidecar searched on the card and on the CPU: the same ids
    (but where a near-tie may order by summation), scores within 1e-5;
    a build on the card lands on the CPU build's centroids."""
    _need_gpu()
    from evossearch_tpu_torch.index.ivf import IVFIndex, _assign

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((100, 128))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, 100, 20_000)] + 0.1 * rng.standard_normal((20_000, 128))
    emb = torch.from_numpy((emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32))
    emb = emb.to(DTYPES[dtype])
    cpu = IVFIndex.build(emb, nlist=128, iters=8, pre_normalized=True)
    cpu.save(tmp_path / "ivf.npz")
    gpu = IVFIndex.load(tmp_path / "ivf.npz", device="cuda")
    assert gpu.buckets.is_cuda and gpu.buckets.dtype == DTYPES[dtype]
    q = emb[:16].float() + 0.05 * torch.randn(16, 128, generator=torch.Generator().manual_seed(4))
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    for nprobe in (0, 128):
        s, i = cpu.search_batch(q, 48, nprobe)
        gs, gi = gpu.search_batch(q.cuda(), 48, nprobe)
        np.testing.assert_allclose(gs, s, rtol=0, atol=1e-5)
        clear = np.ones_like(s, bool)
        gap = np.abs(np.diff(s, axis=1)) > 1e-5
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        np.testing.assert_array_equal(gi[clear], i[clear])
    built = IVFIndex.build(emb.cuda(), nlist=128, iters=8, pre_normalized=True)
    assert float((built.centroids.cpu() - cpu.centroids).abs().max()) < 1e-4
    same = (_assign(emb, built.centroids.cpu()) == _assign(emb, cpu.centroids)).float()
    assert float(same.mean()) >= 0.999


def _train_spec():
    from evossearch_tpu_torch.core import CLIPModelSpec

    return CLIPModelSpec(
        name="small", image_size=64, patch_size=16, vision_width=128,
        vision_layers=3, vision_heads=4, text_width=128, text_layers=3,
        text_heads=4, vocab_size=512, context_length=16, embed_dim=64,
    )


def _train_batch(spec, n=8):
    rng = np.random.default_rng(5)
    images = rng.standard_normal((n, spec.image_size, spec.image_size, 3)).astype(np.float32)
    tokens = np.zeros((n, spec.context_length), np.int64)
    tokens[:, 0] = 1
    tokens[:, 1:8] = rng.integers(2, spec.vocab_size - 2, (n, 7))
    tokens[:, 8] = spec.vocab_size - 1  # eot = max id
    return torch.from_numpy(images), torch.from_numpy(tokens)


def _loss_and_grads(model, images, tokens, dtype, remat=True):
    from evossearch_tpu_torch.train import clip_loss

    model.zero_grad(set_to_none=True)
    loss = clip_loss(model, images, tokens, dtype, remat)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters()}


def _cosine(a, b) -> float:
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (torch.linalg.norm(a) * torch.linalg.norm(b)))


@pytest.mark.gpu
def test_train_step_on_gpu_matches_cpu():
    """One f32 loss and gradient on the card against the CPU's, same
    weights and batch, TF32 off for the f32 products: loss within 1e-4
    relative, every gradient leaf at cosine >= 0.9999; remat on against
    off on the card within 1e-6 relative; bf16 (the tensor-core product's
    backward, ``MatmulF32``) at cosine >= 0.99 to the CPU's bf16."""
    _need_gpu()
    import copy

    from evossearch_tpu_torch.models import CLIP

    spec = _train_spec()
    cpu = CLIP(spec).init_random_(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    images, tokens = _train_batch(spec)
    assert not torch.backends.cuda.matmul.allow_tf32
    loss_c, g_c = _loss_and_grads(cpu, images, tokens, torch.float32)
    loss_g, g_g = _loss_and_grads(gpu, images.cuda(), tokens.cuda(), torch.float32)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    assert min(_cosine(g_g[n], g_c[n]) for n in g_c) >= 0.9999
    loss_n, g_n = _loss_and_grads(gpu, images.cuda(), tokens.cuda(), torch.float32, remat=False)
    assert abs(loss_n - loss_g) <= 1e-6 * abs(loss_g)
    for n in g_g:
        assert float(torch.linalg.norm(g_n[n] - g_g[n])) <= 1e-6 * float(torch.linalg.norm(g_g[n]))
    loss_cb, g_cb = _loss_and_grads(cpu, images, tokens, torch.bfloat16)
    loss_gb, g_gb = _loss_and_grads(gpu, images.cuda(), tokens.cuda(), torch.bfloat16)
    assert np.isfinite(loss_gb)
    assert min(_cosine(g_gb[n], g_cb[n]) for n in g_cb) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("shape_b", [(96, 80), (2, 3, 96, 80)])
def test_matmul_f32_cuda_backward_matches_the_widened_product(shape_b):
    """The bf16 tensor-core product's gradients on the card equal the
    widened product's on the CPU to float32 summation order."""
    _need_gpu()
    from evossearch_tpu_torch.models.layers import matmul_f32

    gen = torch.Generator().manual_seed(6)
    a0 = torch.randn(2, 3, 40, 96, generator=gen).to(torch.bfloat16)
    b0 = torch.randn(*shape_b, generator=gen).to(torch.bfloat16)
    g = torch.randn(2, 3, 40, 80, generator=gen)
    grads = []
    for dev in ("cpu", "cuda"):
        a = a0.detach().to(dev).requires_grad_()
        b = b0.detach().to(dev).requires_grad_()
        out = matmul_f32(a, b)
        out.backward(g.to(dev))
        grads.append([t.detach().float().cpu() for t in (out, a.grad, b.grad)])
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


@pytest.mark.gpu
def test_sharded_search_on_gpu_equals_single_device():
    """Row blocks on one card ([cuda:0] * S) against the single-device
    route on exact-dot rows: bit for bit. S = 2 gives blocks of 2^18 rows
    and more (the kernels), S = 3 smaller ones (the dense path)."""
    _need_gpu()
    from evossearch_tpu_torch.parallel import ShardedIndex, corpus_mesh

    emb, q = _exact_inputs(61, 600_000, 128, 9)
    for dtype in DTYPES.values():
        e = emb.to(dtype).cuda()
        want = search.best_exact_search_batch(e, q, 48)
        for s in (2, 3):
            sh = ShardedIndex.from_matrix(e, mesh=corpus_mesh(devices=["cuda:0"] * s))
            before = dict(topk.LAUNCHES)
            got = sh.search_batch(q, 48)
            launched = sum(topk.LAUNCHES[k] - before[k] for k in ("block", "tree"))
            assert launched == (s if s == 2 else 0)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.gpu
def test_sharded_sq8_on_gpu_equals_one_device(tmp_path):
    """The SQ8 tier on four row blocks of one card: B3 once per block, the
    one-device tier's ids and scores."""
    _need_gpu()
    from evossearch_tpu_torch.index.sq8 import SQ8Index
    from evossearch_tpu_torch.index.store import IndexReader, IndexWriter
    from evossearch_tpu_torch.parallel import SQ8ShardedIndex, corpus_mesh

    rng = np.random.default_rng(62)
    emb = rng.standard_normal((50_001, 256)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = IndexWriter.create(tmp_path, model="t", dim=256)
    paths = [f"p{i}.jpg" for i in range(len(emb))]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 1} for p in paths])
    w.finalize()
    base = SQ8Index.build_from_reader(IndexReader.open(tmp_path), fetch=128)
    base.tile_rows = 512
    base.ensure_device("cuda")
    sharded = SQ8ShardedIndex(base, corpus_mesh(devices=["cuda:0"] * 4))
    q = emb[:5] + 0.01 * rng.standard_normal((5, 256)).astype(np.float32)
    before = topk.LAUNCHES["sq8"]
    s, i = sharded.search_batch(q, 20)
    assert topk.LAUNCHES["sq8"] - before == 4
    s1, i1 = base.search_batch(q, 20)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(s, s1)
    assert (i[:, 0] == np.arange(5)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sharded_ivf_on_gpu_matches_cpu(dtype, tmp_path):
    """One ivf_mesh4.npz searched on four blocks of the card and of the
    CPU: the same ids but where a near-tie may order by summation, scores
    within 1e-5."""
    _need_gpu()
    from evossearch_tpu_torch.index.store import bf16_bits
    from evossearch_tpu_torch.parallel import ShardedIVFIndex, corpus_mesh

    rng = np.random.default_rng(63)
    centers = rng.standard_normal((50, 128))
    emb = centers[rng.integers(0, 50, 20_000)] + 0.3 * rng.standard_normal((20_000, 128))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    rows = bf16_bits(emb) if dtype == "bf16" else emb
    cpu = ShardedIVFIndex.build(rows, mesh=corpus_mesh(devices=["cpu"] * 4), nlist=64)
    cpu.save(tmp_path / "ivf_mesh4.npz")
    gpu = ShardedIVFIndex.load(tmp_path / "ivf_mesh4.npz",
                               mesh=corpus_mesh(devices=["cuda:0"] * 4))
    assert gpu.buckets[0].is_cuda and gpu.buckets[0].dtype == DTYPES[dtype]
    q = emb[:16] + 0.05 * rng.standard_normal((16, 128)).astype(np.float32)
    for nprobe in (0, 64):
        s, i = cpu.search_batch(q, 48, nprobe)
        gs, gi = gpu.search_batch(q, 48, nprobe)
        np.testing.assert_allclose(gs, s, rtol=0, atol=1e-5)
        clear = np.ones_like(s, bool)
        gap = np.abs(np.diff(s, axis=1)) > 1e-5
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
        np.testing.assert_array_equal(gi[clear], i[clear])


@pytest.mark.gpu
def test_dp_encode_on_gpu_matches_single_device(tmp_path):
    """Data-parallel encode over [cuda:0, cuda:0] (two chunks of every
    bucket) against the single-device encode, f32."""
    _need_gpu()
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    spec = _train_spec()
    cfg = Config(env_path=tmp_path / "missing.env")
    cfg.COMPUTE_DTYPE = "float32"
    one = SearchEngine(cfg=cfg, spec=spec, device="cuda")
    dp = SearchEngine(cfg=cfg, spec=spec, params=one.params, device="cuda")
    dp.__dict__["_encode_devices"] = [torch.device("cuda", 0)] * 2
    rng = np.random.default_rng(64)
    images = [rng.integers(0, 256, (50 + j, 70, 3), dtype=np.uint8) for j in range(11)]
    np.testing.assert_allclose(dp.encode_images(images), one.encode_images(images),
                               rtol=0, atol=1e-5)
    one.close()
    dp.close()


def _step_on(model, spec, images, tokens):
    """One f32 step at lr 1e-3 (the JAX package's rule's rate): the loss."""
    from evossearch_tpu_torch.train import make_optimizer, make_train_step

    opt = make_optimizer(learning_rate=1e-3)
    return float(make_train_step(spec, opt)(model, opt.init(model), images, tokens))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_train_step_on_gpu_matches_one_device(shape):
    """One f32 step on the (data, model) mesh over [cuda:0] * 4 against
    the one-device step on the card, same weights and batch, TF32 off:
    loss within 1e-5, every param within 2e-5 at lr 1e-3 (the JAX
    package's rule for its own sharded step, tests/test_train.py)."""
    _need_gpu()
    import copy

    from evossearch_tpu_torch.models import CLIP, params_to_numpy
    from evossearch_tpu_torch.models.checkpoint import _flatten
    from evossearch_tpu_torch.train import ShardedCLIP, train_mesh

    spec = _train_spec()
    one = CLIP(spec).init_random_(torch.Generator().manual_seed(0)).cuda()
    mesh = train_mesh(devices=["cuda:0"] * 4, model_parallel=shape[1])
    sharded = ShardedCLIP.place(copy.deepcopy(one), mesh)
    images, tokens = _train_batch(spec)
    images, tokens = images.cuda(), tokens.cuda()
    assert not torch.backends.cuda.matmul.allow_tf32
    want_loss = _step_on(one, spec, images, tokens)
    loss = _step_on(sharded, spec, images, tokens)
    assert abs(loss - want_loss) < 1e-5
    want, got = _flatten(params_to_numpy(one)), _flatten(sharded.to_numpy())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-5, rtol=0, err_msg=key)


@pytest.mark.gpu
def test_sharded_checkpoint_round_trip_on_gpu(tmp_path):
    """Params and Adam state of a (2, 2) run over [cuda:0] * 4 written by
    save_sharded and restored onto (2, 2) and (4, 1), bit for bit, each
    shard on the card in its own storage."""
    _need_gpu()
    from evossearch_tpu_torch.models import CLIP
    from evossearch_tpu_torch.models.checkpoint import load_sharded, save_sharded
    from evossearch_tpu_torch.train import (
        ShardedAdamState,
        ShardedCLIP,
        make_optimizer,
        make_train_step,
        train_mesh,
    )

    spec = _train_spec()
    mesh = train_mesh(devices=["cuda:0"] * 4, model_parallel=2)
    model = ShardedCLIP.place(CLIP(spec).init_random_(torch.Generator().manual_seed(1)), mesh)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(model)
    images, tokens = _train_batch(spec)
    make_train_step(spec, opt)(model, state, images.cuda(), tokens.cuda())
    path = save_sharded(tmp_path / "ckpt", {"params": model, "opt_state": state})
    for model_parallel in (2, 1):
        target = ShardedCLIP.abstract(spec, train_mesh(devices=["cuda:0"] * 4,
                                                       model_parallel=model_parallel))
        got = load_sharded(path, {"params": target,
                                  "opt_state": ShardedAdamState.abstract(target)})
        assert got["opt_state"].count == 1
        pairs = [(model.params, got["params"].params), (state.mu, got["opt_state"].mu),
                 (state.nu, got["opt_state"].nu)]
        ptrs = set()
        for saved, restored in pairs:
            for key, leaf in restored.items():
                whole = saved[key].gather("cuda")
                for pos, shard in enumerate(leaf.shards):
                    assert shard.is_cuda
                    assert torch.equal(shard, whole[leaf.sharding.index(leaf.shape, pos)]), key
                    ptrs.add(shard.untyped_storage().data_ptr())
        assert len(ptrs) == sum(len(leaf.shards) for _, r in pairs for leaf in r.values())
