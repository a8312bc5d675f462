"""The f32 route's GEMM tile and the attention forward past head dim 160, on
the CPU: their plain versions, the route's chunk loop and chunk plan, and
the f32 GEMM bound.

``gemm_f32_reference`` (the GEMM tile's plain version) is held against the
product in float64 numpy, within relative L2 1e-6 (f32 sums of at most a
few hundred products). The route's chunk loop, with the plain launches
passed in and a cap small enough for several chunks of heads and a split by
query rows, is held against the JAX package's flash attention under the
Pallas interpreter (as ``tests/test_attention.py`` runs it) at D = 512 with
a key bias and ragged L: out and lse within 2e-5, that file's tolerance.
The kernels themselves run on the card only (``test_torch_port_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvldm_tpu.ops.attention import flash_attention as jax_flash
from mvldm_tpu_torch.ops import f32_route
from mvldm_tpu_torch.tools import measure

from tests.test_torch_port_ops import _bias, _qkv, _t


def _rng_f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (label, m, n, k, b_kn, batch, bias, res, a_heads, out_heads, alpha): both B
# layouts, a batch with a bias row per entry, the head-merged A and the
# head-split output of the fused attention block, a residual, and ragged M,
# N and K (not multiples of the 128 x 128 x 32 tile).
GEMM_CASES = [
    ("(N, K) B", 200, 72, 40, False, 0, None, False, 0, 0, 1.0),
    ("(K, N) B", 200, 72, 40, True, 0, None, False, 0, 0, 1.0),
    ("ragged M, N, K", 257, 300, 333, False, 0, None, False, 0, 0, 1.0),
    ("ragged, (K, N) B", 129, 132, 131, True, 0, None, False, 0, 0, 1.0),
    ("bias and residual", 130, 36, 64, False, 0, "shared", True, 0, 0, 1.0),
    ("batch, a bias row each, alpha", 70, 52, 48, False, 3, "per entry", False, 0, 0, 0.125),
    ("batch, (K, N) B, shared bias", 33, 16, 130, True, 2, "shared", False, 0, 0, 1.0),
    ("head-merged A + bias + residual", 2 * 50, 24, 4 * 8, False, 0, "shared", True, 4, 0, 1.0),
    ("head-split output", 3 * 20, 5 * 8, 28, False, 0, None, False, 0, 5, 1.0),
]


@pytest.mark.parametrize("label,m,n,k,b_kn,batch,bias,res,a_heads,out_heads,alpha", GEMM_CASES,
                         ids=[c[0] for c in GEMM_CASES])
def test_gemm_reference_against_float64(label, m, n, k, b_kn, batch, bias, res, a_heads,
                                        out_heads, alpha):
    rng = np.random.default_rng(m + n + k)
    lead = (batch,) if batch else ()
    a = _rng_f32(rng, *lead, m, k)
    b = _rng_f32(rng, *lead, *((k, n) if b_kn else (n, k)))
    bv = None
    if bias == "shared":
        bv = _rng_f32(rng, n)
    elif bias == "per entry":
        bv = _rng_f32(rng, batch, n)
    rv = _rng_f32(rng, m, n) if res else None

    want = (a.astype(np.float64) @ (b if b_kn else np.swapaxes(b, -1, -2)).astype(np.float64))
    want = want * alpha
    if bv is not None:
        want = want + bv.astype(np.float64)[..., None, :]
    if rv is not None:
        want = want + rv
    a_in = a
    if a_heads:  # the attention output (N', H, L, D) whose tokens x (H D) is a
        d, l = k // a_heads, 50
        a_in = np.ascontiguousarray(a.reshape(m // l, l, a_heads, d).transpose(0, 2, 1, 3))
    l_out = 20
    got = f32_route.gemm_f32_reference(
        _t(a_in), _t(b), None if bv is None else _t(bv), None if rv is None else _t(rv), b_kn,
        alpha, out_heads, l_out if out_heads else 0)
    if out_heads:
        d = n // out_heads
        assert got.shape == (m // l_out, out_heads, l_out, d)
        got = got.transpose(1, 2).reshape(m, n)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-6, err


# (b, h, lq, lk, cap): one chunk; several chunks of whole heads; one head per
# chunk split by query rows (a ragged last piece); the bias and ragged L
# throughout (L not a multiple of 4 or of any tile).
ROUTE_CASES = [
    (2, 2, 70, 130, 1 << 30),
    (2, 3, 70, 130, 2 * 70 * 132 * 4),
    (1, 2, 77, 150, 30 * 152 * 4),
]


@pytest.mark.parametrize("b,h,lq,lk,cap", ROUTE_CASES)
def test_attention_route_plain_launches_vs_jax(b, h, lq, lk, cap):
    """The D > 160 forward's chunk loop, run with the plain launches, against
    the interpreted Pallas forward: out and lse."""
    d = 512
    q, k, v = _qkv(lq + lk, b, h, lq, lk, d)
    bias = _bias(lk, b, lk)
    chunks = f32_route.attention_chunks(b * h, lq, lk, cap)
    assert (len(chunks) > 1) == (cap < (1 << 30))
    out = torch.empty((b, h, lq, d))
    lse = torch.empty((b, h, lq))
    f32_route.attention_route_f32(_t(q), _t(k), _t(v), _t(bias), d ** -0.5, out, lse,
                                  f32_route.PlainRouteLaunches(), cap)
    j_out, j_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                             return_lse=True, interpret=True, block_q=128, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], atol=2e-5)


def test_attention_route_without_lse_matches_with():
    """lse=None takes a scratch lse: the same out."""
    q, k, v = (_t(x) for x in _qkv(5, 1, 2, 30, 45, 200))
    outs = []
    for lse in (None, torch.empty((1, 2, 30))):
        out = torch.empty_like(q)
        f32_route.attention_route_f32(q, k, v, None, 200 ** -0.5, out, lse,
                                      f32_route.PlainRouteLaunches(), 40 * 48 * 4)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


# (bh, lq, lk, cap, chunks): whole heads over the fewest chunks, each
# ceil(heads / chunks); a head past the cap split by rows the same way;
# rows of ceil4(Lk) f32.
CHUNK_CASES = [
    (12, 1024, 1024, 64 << 20, [(0, 12, 0, 1024)]),
    (12, 1024, 1024, 16 << 20, [(0, 4, 0, 1024), (4, 4, 0, 1024), (8, 4, 0, 1024)]),
    (5, 100, 100, 2 * 100 * 100 * 4, [(0, 2, 0, 100), (2, 2, 0, 100), (4, 1, 0, 100)]),
    (7, 100, 100, 3 * 100 * 100 * 4, [(0, 3, 0, 100), (3, 3, 0, 100), (6, 1, 0, 100)]),
    (2, 10, 13, 4 * 16 * 4, [(0, 1, 0, 4), (0, 1, 4, 4), (0, 1, 8, 2), (1, 1, 0, 4),
                             (1, 1, 4, 4), (1, 1, 8, 2)]),
    (1, 3, 5, 1, [(0, 1, 0, 1), (0, 1, 1, 1), (0, 1, 2, 1)]),
]


@pytest.mark.parametrize("bh,lq,lk,cap,want", CHUNK_CASES)
def test_attention_chunks(bh, lq, lk, cap, want):
    chunks = f32_route.attention_chunks(bh, lq, lk, cap)
    assert chunks == want
    covered = sorted((z, r) for z0, n, r0, rows in chunks
                     for z in range(z0, z0 + n) for r in range(r0, r0 + rows))
    assert covered == [(z, r) for z in range(bh) for r in range(lq)]
    lds = -(-lk // 4) * 4
    assert all(n * rows * lds * 4 <= cap or (n == 1 and rows == 1) for _, n, _, rows in chunks)


def test_attention_chunks_at_the_vae_shape_take_one_chunk():
    """The 256 px VAE's mid-block attention (12 heads of 1024 x 1024, 48 MB
    of scores) is one chunk under the default cap; a 512 px one (4096 x
    4096, 64 MB a head) one head a chunk."""
    assert f32_route.attention_chunks(12, 1024, 1024) == [(0, 12, 0, 1024)]
    assert f32_route.attention_chunks(2, 4096, 4096) == [(0, 1, 0, 4096), (1, 1, 0, 4096)]


def test_attention_rows_reference_in_place():
    rng = np.random.default_rng(0)
    s = _t(_rng_f32(rng, 2, 3, 8))
    s[0, 1, 3] = -1e30  # a masked key
    want_lse = torch.logsumexp(s[..., :6], -1)
    want_p = torch.softmax(s[..., :6], -1)
    tail = s[..., 6:].clone()
    lse = torch.empty((2, 3))
    f32_route.attention_rows_reference(s, lse, 6)
    torch.testing.assert_close(lse, want_lse)
    torch.testing.assert_close(s[..., :6], want_p)
    assert torch.equal(s[..., 6:], tail) and s[0, 1, 3] == 0.0


# (m, n, k, bound ms, bound_by, ffma ms): three TF32 products of 2 M N K at
# 494.7 TFLOP/s against the bytes at 3.35 TB/s; FFMA at 67 TFLOP/s.
GEMM_BOUNDS = [
    (4096, 1024, 1024, 0.05209, "operations", 0.1282),
    (10240, 2560, 320, 0.1017, "operations", 0.2504),
    (10240, 320, 1280, 0.05087, "operations", 0.1252),
    (16, 16, 16, 9.170e-7, "bytes", 9.170e-7),
]


@pytest.mark.parametrize("m,n,k,bound_ms,bound_by,ffma_ms", GEMM_BOUNDS)
def test_f32_gemm_bounds(m, n, k, bound_ms, bound_by, ffma_ms):
    moved = 4 * (m * k + k * n + m * n)
    rec = measure.f32_gemm_bounds(m, n, k, moved)
    assert rec["bound_by"] == bound_by
    assert rec["bound_ms"] == pytest.approx(bound_ms, rel=1e-3)
    assert rec["ffma_bound_ms"] == pytest.approx(ffma_ms, rel=1e-3)
    assert rec == measure.f32_bounds(2.0 * m * n * k, moved)
