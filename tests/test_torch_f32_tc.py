"""The arithmetic of the candidate kernels' f32 path, on the CPU, where no
kernel runs.

The tree and block kernels score an f32 corpus on the tensor cores in
three TF32 passes (``ops/csrc/topk_tc.cuh``): every f32 word x splits into
big = x & 0xffffe000 and small = x - big rounded to TF32, and the kernel
sums small*big, big*small and big*big. These tests pin, with numpy models
of the kernel's bit operations, that the split is exact, that the
three-pass dot stays within the header's error model
(2^-19 + 2*d*2^-24)*sum|x_k*q_k| against float64 (and within the smoke's
SCORE_ATOL of the plain version on unit rows), that it equals IEEE f32 on
the exact-dot inputs the bit-equality checks use, that the f32 ldmatrix
fragments pair each row word with its own query column in the layout the
m16n8k8 TF32 product reads, and that 48 f32 queries fit beside the ring
in one corpus read. The f32 plain versions are held against the JAX
package's Pallas kernels in interpret mode at the reference's f32 tile,
and the kernels themselves against the plain versions in
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.ops import topk_pallas as ref
from evossearch_tpu_torch.ops import topk

U24 = 2.0 ** -24
SCORE_ATOL = 1e-5  # chip_smoke.py's tolerance against the plain version
MASK = np.uint32(0xFFFFE000)


def _big(x: np.ndarray) -> np.ndarray:
    """The top 11 significant bits of f32 values (sign and exponent kept)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & MASK).view(np.float32)


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: f32 rounded to 10 stored mantissa bits, ties away
    from zero (a carry into the exponent is the right result)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & MASK).view(np.float32)


def _split(x: np.ndarray):
    big = _big(x)
    return big, _tf32(np.asarray(x, np.float32) - big)


def _edge_values() -> np.ndarray:
    f = np.finfo(np.float32)
    vals = [0.0, -0.0, f.max, -f.max, f.tiny, -f.tiny, f.smallest_subnormal,
            -f.smallest_subnormal, f.tiny - f.smallest_subnormal,
            np.nextafter(f.max, 0, dtype=np.float32), 1.0, -1.0]
    vals += [2.0 ** e for e in (-149, -148, -127, -126, -125, 0, 125, 126, 127)]
    vals += [-(2.0 ** e) for e in (-149, -126, 127)]
    return np.array(vals, np.float32)


def test_split_is_exact_and_big_fits_tf32():
    rng = np.random.default_rng(90)
    x = np.concatenate([
        _edge_values(),
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(4096) * 2.0 ** rng.integers(-140, 120, 4096)).astype(np.float32),
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32),
    ])
    x = x[np.isfinite(x)]
    big = _big(x)
    small = (x - big).astype(np.float32)
    # small = x - big is exact in f32, so big + small == x in f64 and f32
    np.testing.assert_array_equal(big.astype(np.float64) + small.astype(np.float64),
                                  x.astype(np.float64))
    np.testing.assert_array_equal((big + small).astype(np.float32), x)
    assert not (big.view(np.uint32) & ~MASK).any()
    # for normal x, |small| < 2^-10 |x|; rounding small to TF32 drops at
    # most its two lowest bits, 2^-22 of |x| (the split's error model),
    # wherever small is itself normal (|x| >= 2^-100 here); below, the
    # subnormal small loses at most 2^-22 of 2^-100
    r = _tf32(small)
    assert not (r.view(np.uint32) & ~MASK).any()
    err = np.abs(r.astype(np.float64) - small.astype(np.float64))
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    assert (np.abs(small[normal]) < 2.0 ** -10 * np.abs(x[normal])).all()
    wide = np.abs(x) >= 2.0 ** -100
    assert wide.sum() > 10_000 and (~wide).sum() >= 10
    assert (err[wide] <= 2.0 ** -22 * np.abs(x[wide].astype(np.float64))).all()
    assert (err[~wide] <= 2.0 ** -122).all()


def test_split_of_exact_dot_values_has_no_small_part():
    """k/16 with |k| <= 4 (and every integer over 16 the GPU tests draw)
    has at most 3 significant bits: small is 0, so the two small passes
    add only zeros."""
    vals = np.arange(-8, 9, dtype=np.float32) / 16
    big, small = _split(vals)
    np.testing.assert_array_equal(big, vals)
    assert not small.any()


def _rtz_add(acc: np.ndarray, p: np.ndarray) -> np.ndarray:
    """f32 acc + p rounded toward zero (the truncating accumulation the
    header assumes); the f64 sum of an f32 and an exact TF32 product is
    exact here."""
    s = acc.astype(np.float64) + p
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _three_pass_dot(x: np.ndarray, q: np.ndarray, splits: int = 1) -> np.ndarray:
    """Model of the kernel's f32 dot: per k-split, three accumulators fed
    one product at a time with truncating f32 adds (big*big, small*big,
    big*small; every TF32 product exact in f32), joined as
    (small*big + big*small) + big*big with IEEE adds; the splits' partial
    dots then added in split order."""
    xb, xs = _split(x)
    qb, qs = _split(q)
    terms = [xb.astype(np.float64) * qb, xs.astype(np.float64) * qb,
             xb.astype(np.float64) * qs]
    parts = []
    for cols in np.array_split(np.arange(x.shape[1]), splits):
        acc = [np.zeros(x.shape[0], np.float32) for _ in terms]
        for k in cols:
            acc = [_rtz_add(a, t[:, k]) for a, t in zip(acc, terms)]
        parts.append((acc[1] + acc[2]).astype(np.float32) + acc[0])
    out = parts[0]
    for part in parts[1:]:
        out = (out + part).astype(np.float32)
    return out


def _cancelling(rng, n: int, d: int):
    """Rows of full-mantissa f32 values with alternating signs by column
    and magnitudes spanning 2^14, and a one-signed query spanning 2^14:
    every dot cancels almost to nothing."""
    sign = np.where(np.arange(d) % 2, -1.0, 1.0)
    x = ((rng.random((n, d)) + 0.5) * 2.0 ** -rng.integers(0, 14, (n, d)) * sign)
    q = (rng.random(d) + 0.5) * 2.0 ** -rng.integers(0, 14, d)
    return x.astype(np.float32), (q / np.linalg.norm(q)).astype(np.float32)


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["unit", "cancelling"])
@pytest.mark.parametrize("d", [512, 1024])
def test_three_pass_dot_stays_within_the_error_model(d, kind):
    rng = np.random.default_rng(91 + d + len(kind))
    if kind == "unit":
        x, q = _unit(rng, 64, d), _unit(rng, 1, d)[0]
    else:
        x, q = _cancelling(rng, 64, d)
    p = x.astype(np.float64) * q.astype(np.float64)
    exact = p.sum(axis=1)
    size = np.abs(p).sum(axis=1)
    # the split alone (three exact products): at most 1.5*2^-20*sum|p|
    xb, xs = _split(x)
    qb, qs = _split(q)
    split_dot = (xb.astype(np.float64) * qb + xs.astype(np.float64) * qb
                 + xb.astype(np.float64) * qs).sum(axis=1)
    assert (np.abs(split_dot - exact) <= 1.5 * 2.0 ** -20 * size).all()
    model = (2.0 ** -19 + 2 * d * U24) * size
    worst = 0.0
    for splits in (1, 4, 8):
        err = np.abs(_three_pass_dot(x, q, splits).astype(np.float64) - exact)
        assert (err <= model).all(), (splits, float((err / model).max()))
        worst = max(worst, float((err / model).max()))
    assert worst > 0  # the model did round


def test_three_pass_dot_within_score_atol_of_the_plain_version():
    """On unit rows at d = 512 the three-pass scores stay within
    SCORE_ATOL of the plain version's IEEE f32 scores (tree_candidates_plain
    at the f32 tile, its emitted scores gathered by row)."""
    rng = np.random.default_rng(92)
    n, d = 8192, 512
    x, q = _unit(rng, n, d), _unit(rng, 3, d)
    cand_s, cand_i, _ = topk.tree_candidates_plain(
        torch.from_numpy(x), torch.from_numpy(q), 8192)
    for j in range(3):
        rows = cand_i[j].numpy()
        model = _three_pass_dot(x[rows], q[j], splits=4)
        assert float(np.abs(model - cand_s[j].numpy()).max()) <= SCORE_ATOL


def test_three_pass_dot_is_exact_on_exact_dot_inputs():
    """Every small part is 0 and every partial sum exact, so the model
    equals the plain version's IEEE f32 dot bit for bit in any split."""
    rng = np.random.default_rng(93)
    x = (rng.integers(-4, 5, (32, 512)) / 16).astype(np.float32)
    q = (rng.integers(-4, 5, 512) / 16).astype(np.float32)
    plain = (torch.from_numpy(x) @ torch.from_numpy(q)).numpy()
    for splits in (1, 2, 8):
        np.testing.assert_array_equal(_three_pass_dot(x, q, splits), plain)


# -- the f32 ldmatrix fragments (topk_tc.cuh: mma_role, mma_rank_tf32) --


def _ldmatrix_x4(mem: np.ndarray, addrs) -> np.ndarray:
    """ldmatrix.sync.m8n8.x4.b16 over 32-bit words of ``mem`` (a word array,
    byte address // 4): matrix j's eight rows are at the byte addresses of
    lanes 8j..8j+7, and lane l receives word l % 4 of row l // 4 of each
    matrix. Returns (32 lanes, 4 registers). Checks that each matrix's
    eight rows sit in eight different 16-byte bank groups."""
    addrs = np.asarray(addrs)
    out = np.empty((32, 4), mem.dtype)
    for j in range(4):
        rows = addrs[8 * j : 8 * j + 8]
        assert len({(a // 16) % 8 for a in rows}) == 8, "bank conflict"
        for lane in range(32):
            out[lane, j] = mem[rows[lane // 4] // 4 + lane % 4]
    return out


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("d", [512, 768, 1024])
def test_f32_row_fragments_are_the_m16n8k8_a_layout(c, d):
    """One x4 over a ring slot of f32 rows gives each lane the A fragment
    a0 = (row g, col t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4) of
    the 16-row tile, M index m being row 2*mt + m/8 of group m%8, for both
    k8 steps of the first and last 16-column half step."""
    r = c // 8
    gp = r * d * 4 + 16  # group_pitch<float>(C, d), bytes
    words = np.full((8 * gp) // 4, -1, np.int64)
    for w in range(8):
        for i in range(r):
            base = (w * gp) // 4 + i * d
            words[base : base + d] = (w * r + i) * 100_000 + np.arange(d)  # slot row, col
    for mt in range(c // 16):
        for k in (0, d // 8 - 2):  # the first and last half step
            for s in range(2):
                addrs = [(lane & 7) * gp + ((lane >> 3) & 1) * d * 4 + (lane >> 4) * 16
                         + 2 * mt * d * 4 + k * 32 + 32 * s for lane in range(32)]
                frag = _ldmatrix_x4(words, addrs)
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    col = 8 * k + 8 * s
                    for e, (m, cc) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
                        slot_row = (m % 8) * r + 2 * mt + m // 8
                        assert frag[lane, e] == slot_row * 100_000 + col + cc


def _chunk_off_f32(q: int, ch: int, d: int) -> int:
    return q * d + ((ch ^ (q & 7)) << 2)


@pytest.mark.parametrize("d", [512, 768, 1024])
def test_staged_f32_queries_are_the_m16n8k8_b_layout(d):
    """The queries staged as f32 chunks of 4 columns (chunk index XOR the
    query's low 3 bits) give, through one x4 per 8-query tile and 16-column
    half step, b0 = (k = t, query g) and b1 = (k = t+4, query g) of its two
    k8 steps, bank-conflict free."""
    nq = 16
    mem = np.full(nq * d, -1, np.int64)
    for qq in range(nq):
        for ch in range(d // 4):
            off = _chunk_off_f32(qq, ch, d)
            mem[off : off + 4] = qq * 100_000 + 4 * ch + np.arange(4)
    for tile in range(nq // 8):
        for k in range(0, d // 8, 2):  # the half step's first 8-column chunk
            frag = _ldmatrix_x4(mem, [4 * _chunk_off_f32(tile * 8 + (lane & 7),
                                                         2 * k + (lane >> 3), d)
                                      for lane in range(32)])
            for s in range(2):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    want = (tile * 8 + g) * 100_000 + 8 * k + 8 * s + t
                    assert (frag[lane, 2 * s], frag[lane, 2 * s + 1]) == (want, want + 4)


SMEM_OPTIN = 232_448 - 4 * 8  # an H100 block's opt-in, less the barriers


def _smem_bytes(c: int, qcap: int, slots: int, qc: int, d: int, qbytes: int) -> int:
    """smem_bytes of topk_tc.cuh: queries, ring slots, the dot slab."""
    npw = 4 if qcap >= 64 else 1
    slab_rows = max(npw * 8 * 8, qcap)
    return qc * d * qbytes + slots * 8 * (c // 8 * d * 4 + 16) + slab_rows * (c + 1) * 4


def test_f32_queries_read_the_corpus_once_up_to_64_queries():
    """At d = 512, 48 (and 64) f32 queries fit beside two 16-row ring slots
    and the slab, so one corpus read serves them; 32-row slots would not
    fit twice beside 48, which is why f32 rows take C = 16."""
    d = 512
    assert _smem_bytes(16, 64, 2, 64, d, 4) <= SMEM_OPTIN
    assert _smem_bytes(16, 64, 3, 48, d, 4) <= SMEM_OPTIN  # three slots at Q = 48
    assert _smem_bytes(32, 64, 2, 48, d, 4) > SMEM_OPTIN


def test_tree_f32_plain_equals_pallas_at_the_f32_tile():
    """tree_candidates_plain at the reference's f32 tile (8192 rows, three
    tiles, the last partial) against _tree_candidates in interpret mode on
    f32 exact-dot inputs, cell for cell."""
    rng = np.random.default_rng(94)
    n, d, q = 20_000, 128, 5
    emb = (rng.integers(-4, 5, (n, d)) / 16).astype(np.float32)
    queries = (rng.integers(-4, 5, (q, d)) / 16).astype(np.float32)
    padded = np.zeros((ref.LANES, d), np.float32)
    padded[:q] = queries
    want = ref._tree_candidates(jnp.asarray(emb), jnp.asarray(padded), 8192, interpret=True)
    got = topk.tree_candidates_plain(torch.from_numpy(emb), torch.from_numpy(queries), 8192)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:q])


def test_tree_f32_wrapper_takes_corpora_past_the_old_grid_limit(monkeypatch):
    """The f32 path's grid once held 4 blocks of every tile in its y
    dimension and raised above 134,209,536 rows; it now launches any int32
    row count. Checked on the argument path of a CUDA tensor without a
    card: a fake tensor reaches the launch with its shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []
    monkeypatch.setattr(topk, "_launch", lambda name, emb, args: calls.append((name, args)))
    n, d = 134_209_537, 128
    with FakeTensorMode(allow_non_fake_inputs=True):
        emb = torch.empty((n, d), dtype=torch.float32, device="cuda")
        queries = torch.zeros((8, d))
        cand_s, cand_i, bound = topk.tree_candidates(emb, queries, 8192)
    assert len(calls) == 1 and calls[0][0] == "tree"
    args = calls[0][1]
    assert args[1] == 0 and args[3:7] == [8, n, d, 8192]  # f32, nq, n, d, tile_rows
    tiles = -(-n // 8192)
    assert cand_s.shape == cand_i.shape == (8, tiles * 256) and bound.shape == (8, tiles * 128)
