"""The arithmetic that the SQ8 sweep's tensor-core kernel relies on, on
the CPU, where no kernel runs.

The CUDA kernel (``ops/csrc/topk_tc.cuh``, B3 and E1) widens int8 rows to
bf16 and sums their products with the bf16-rounded queries on the tensor
cores, which do not promise IEEE round-to-nearest accumulation. These
tests pin what the certificate needs from that: the ``radd`` that
``quantize_rows`` emits (the same as the JAX package's) also covers a
truncating accumulation, a numpy model of that accumulation stays within
its error bound and keeps every bound above its row's exact score, and
the kernel's k order inside a 16-column group pairs every row byte with
its own query value. The kernel itself is held against the plain version
in tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

from evossearch_tpu.index import sq8 as ref_sq8
from evossearch_tpu_torch.index.sq8 import C_BF16, quantize_rows

U24 = 2.0 ** -24
WIDTHS = (512, 768, 1024)
ROW_KINDS = ("unit", "spike", "alternating")


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bf16 of f32 values, back as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def _rows(kind: str, n: int, d: int, rng) -> np.ndarray:
    """Unit rows of three kinds: gaussian; one spike over small noise (a
    large scale, most int8 values 0, the residual dominant); alternating
    signs of near-equal magnitude (dots against a one-signed query cancel
    almost entirely)."""
    if kind == "unit":
        x = rng.standard_normal((n, d))
    elif kind == "spike":
        x = rng.standard_normal((n, d)) * 1e-3
        x[np.arange(n), rng.integers(0, d, n)] = 1.0
    else:
        x = (1.0 + 0.01 * rng.standard_normal((n, d))) * np.where(np.arange(d) % 2, -1.0, 1.0)
    x = x.astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_radd_covers_a_truncating_tensor_core_accumulation(d, kind):
    """radd (per unit of ||q||) covers, in float64: the residual term
    ||r||*(1 + C_BF16); the query rounding scale*||e8||*C_BF16; the host
    rerank's f32 accumulation d*2^-24*scale*||e8||; the kernel's
    truncating accumulation 2*d*2^-24*scale*||e8||*||q~|| (||q~|| <=
    1 + C_BF16); and the three roundings of the bound itself. What is left
    is about 0.05*C_BF16*anorm less the truncation's extra d*2^-24*anorm:
    the least margin found is 2.4*d*2^-24*anorm at d = 512, 1.3 at 768
    and 0.77 at 1024 (alternating rows)."""
    rng = np.random.default_rng(d + len(kind))
    a = _rows(kind, 256, d, rng)
    e8, scal2 = quantize_rows(a)
    ref_e8, ref_scal2 = ref_sq8.quantize_rows(a)
    np.testing.assert_array_equal(e8, ref_e8)  # the sidecar format is unchanged
    np.testing.assert_array_equal(scal2, ref_scal2)
    scale, radd = scal2.astype(np.float64)
    ef = e8.astype(np.float64)
    anorm = scale * np.linalg.norm(ef, axis=1)
    rnorm = np.linalg.norm(a.astype(np.float64) - scale[:, None] * ef, axis=1)
    qt = 1 + C_BF16  # ||q~|| for a unit query
    need = (rnorm * (1 + C_BF16) + anorm * C_BF16 + d * U24 * anorm
            + 2 * d * U24 * anorm * qt + 4 * U24 * (anorm * qt + radd))
    margin = (radd - need) / anorm
    assert margin.min() > 0, (d, kind, margin.min())
    assert margin.min() > (0.05 * C_BF16 - 1.1 * d * U24) * 0.9


def _rtz_add(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """f32 x + y rounded toward zero (the sum of two f32 is exact in f64
    here: every addend is a product of an int8 and a bf16)."""
    s = x.astype(np.float64) + y.astype(np.float64)
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _tc_dot(e8: np.ndarray, qt: np.ndarray, order: np.ndarray, splits: int) -> np.ndarray:
    """Model of the kernel's accumulation: the products e8*q~ (exact in
    f32) taken in ``order``, cut into ``splits`` k-splits, each summed in
    16-product MMA steps onto its accumulator with round-toward-zero f32
    adds; the splits' partial dots then added in split order with IEEE
    f32 adds."""
    p = (e8.astype(np.float32) * qt[None, :])[:, order]
    parts = []
    for chunk in np.split(p, splits, axis=1):
        acc = np.zeros(p.shape[0], np.float32)
        for k in range(chunk.shape[1]):
            acc = _rtz_add(acc, chunk[:, k])
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = (out + part).astype(np.float32)
    return out


@pytest.mark.parametrize("d", WIDTHS)
def test_truncating_accumulation_model_stays_in_bound_and_certifies(d):
    """On cancellation-heavy rows, the model's dot stays within
    2*d*2^-24*sum|p| of the float64 dot for any order and split count, and
    the bound u = dot*scale + ||q||*radd (rounded as the kernel rounds it)
    dominates the row's exact score against both the f32 and the
    bf16-rounded query, and the host's f32 score."""
    rng = np.random.default_rng(70 + d)
    a = _rows("alternating", 64, d, rng)
    e8, scal2 = quantize_rows(a)
    scale, radd = scal2
    # a one-signed query whose values span 2^14, so every dot cancels
    # almost to nothing and its partial sums need more than 24 bits
    q = ((np.abs(rng.standard_normal(d)) + 0.5) * 2.0 ** -rng.integers(0, 14, d)).astype(np.float32)
    q /= np.linalg.norm(q)
    qt = _bf16(q)
    qn = np.float32(np.linalg.norm(q))
    p = e8.astype(np.float64) * qt.astype(np.float64)[None, :]
    exact_dot = p.sum(axis=1)
    budget = 2 * d * U24 * np.abs(p).sum(axis=1)
    orders = [np.arange(d), rng.permutation(d),
              np.argsort(-np.abs(p).sum(axis=0), kind="stable")]
    worst = 0.0
    for order in orders:
        for splits in (1, 2, 8):
            dot = _tc_dot(e8, qt, order, splits)
            err = np.abs(dot.astype(np.float64) - exact_dot)
            assert (err <= budget).all()
            worst = max(worst, float((err / budget).max()))
            u = (dot * scale).astype(np.float32) + (qn * radd).astype(np.float32)
            a64 = a.astype(np.float64)
            for score in (a64 @ q.astype(np.float64), a64 @ qt.astype(np.float64),
                          (a @ q).astype(np.float64)):
                assert (u.astype(np.float64) >= score).all()
    assert worst > 0  # the model did round


# The kernel's k order inside a 16-column group (topk_tc.cuh): logical
# column s of the MMA holds corpus and query column K_ORDER[s]
K_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def test_int8_fragment_k_order_pairs_each_byte_with_its_query_value():
    """ldmatrix over int8 rows gives thread t (lane % 4) the row's bytes
    4t..4t+3 of a 16-column group; m16n8k16 reads them as the A fragment's
    logical columns {2t, 2t+1} (a0/a1) and {2t+8, 2t+9} (a2/a3), and the
    B fragment's query values from the same logical columns of the staged
    queries (column s staged from K_ORDER[s]). Every product then pairs a
    row byte with its own query column, and the permuted dot equals the
    plain dot on exact inputs."""
    order = np.array(K_ORDER)
    assert sorted(K_ORDER) == list(range(16))
    for t in range(4):
        for j, logical in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            assert K_ORDER[logical] == 4 * t + j
    rng = np.random.default_rng(80)
    d = 512
    e8 = rng.integers(-127, 128, (32, d)).astype(np.int8)
    q = (rng.integers(-4, 5, d) / 16).astype(np.float32)
    perm = np.arange(d) // 16 * 16 + np.tile(order, d // 16)
    assert np.array_equal(np.sort(perm), np.arange(d))
    permuted = (e8[:, perm].astype(np.float32) * q[perm]).sum(axis=1, dtype=np.float32)
    plain = e8.astype(np.float32) @ q
    np.testing.assert_array_equal(permuted, plain)
