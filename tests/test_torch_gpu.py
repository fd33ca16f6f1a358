"""The port's CUDA kernels against their plain versions, on the GPU.

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
