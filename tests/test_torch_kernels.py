"""The port's plain kernel versions (``repro_torch.kernels.ref``) against the
JAX package's oracles (``repro.kernels.ref``) on the same numpy inputs, and
the dispatch rules of ``repro_torch.kernels.ops``.

Tolerances: the bit kernels, QSGD quantization and threshold masking are
exact (the same inputs, the same fp32 operations in the same order); the
fp32 products use ``rtol=atol=1e-5`` (both sides accumulate in fp32, in
different orders).  M is drawn with variance 1 / max(rows, cols) so that
the products are of order one and the tolerance is relative to the values
compared.  QSGD's uniform draw is JAX's own (``jax.random.uniform`` of the
key the JAX function gets, which is what its ``bernoulli`` compares
against).  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitpack as jbitpack
from repro.kernels import qsgd as jqsgd
from repro.kernels import ref as jref
from repro.kernels import topk as jtopk
from repro_torch.kernels import bitpack as kb
from repro_torch.kernels import build, ops
from repro_torch.kernels import powersgd as kp
from repro_torch.kernels import qsgd as kq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk as kt

# the shapes of tests/test_kernels.py::test_powersgd_encode_decode
PSGD_SHAPES = [(8, 128, 1), (256, 512, 4), (300, 700, 4), (1000, 130, 16),
               (7, 3, 2), (513, 1025, 8)]
BIT_NS = [1, 5, 31, 32, 33, 1000, 4097]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rows,cols,rank", PSGD_SHAPES)
def test_powersgd_encode_decode_match_jax(rows, cols, rank):
    rng = np.random.default_rng(rows * 7 + cols)
    m = rng.standard_normal((rows, cols), dtype=np.float32) \
        / np.float32(np.sqrt(max(rows, cols)))
    q = rng.standard_normal((cols, rank), dtype=np.float32)
    p = rng.standard_normal((rows, rank), dtype=np.float32)
    np.testing.assert_allclose(tref.powersgd_encode(_t(m), _t(q)).numpy(),
                               np.asarray(jref.powersgd_encode(m, q)),
                               rtol=1e-5, atol=1e-5)
    # PowerSGD's second round: the transposed view, as the compressor
    # passes it
    np.testing.assert_allclose(tref.powersgd_encode(_t(m).T, _t(p)).numpy(),
                               np.asarray(jref.powersgd_encode(m.T, p)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tref.powersgd_decode(_t(p), _t(q)).numpy(),
                               np.asarray(jref.powersgd_decode(p, q)),
                               rtol=1e-5, atol=1e-5)


def _signs_input(n, seed):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    special = np.array([-0.0, np.nan, 0.0, -1e-30, np.inf, -np.inf],
                       np.float32)
    k = min(n, special.size)
    g[:k] = special[:k]
    return g


@pytest.mark.parametrize("n", BIT_NS)
def test_pack_unpack_match_jax(n):
    g = _signs_input(n, n)
    words = tref.pack_signs(_t(g))
    assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jref.pack_signs(jnp.asarray(g))))
    np.testing.assert_array_equal(
        tref.unpack_signs(words, n).numpy(),
        np.asarray(jref.unpack_signs(jref.pack_signs(jnp.asarray(g)), n)))
    if n >= 2:   # -0.0 packs as 1, NaN as 0
        bits = tref.unpack_signs(words, n).numpy()
        assert bits[0] == 1 and bits[1] == 0


@pytest.mark.parametrize("n", BIT_NS)
@pytest.mark.parametrize("p", [1, 3, 4, 2, 5, 8, 31, 32, 33, 64])
def test_popcount_votes_match_jax(n, p):
    rng = np.random.default_rng(n * 10 + p)
    words = -(-n // 32)
    gathered = rng.integers(0, 2**32, (p, words), dtype=np.uint64) \
        .astype(np.uint32)
    got = tref.popcount_votes(_t(gathered.view(np.int32)), n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.popcount_votes(jnp.asarray(gathered), n)))


def _bitmap(fill, p, words, n, seed):
    """(p, words) uint32 words: all ones, all zeros, or random words whose
    last word has every pad bit past n set."""
    if fill == "ones":
        return np.full((p, words), 0xFFFFFFFF, np.uint32)
    if fill == "zeros":
        return np.zeros((p, words), np.uint32)
    w = np.random.default_rng(seed).integers(0, 2**32, (p, words),
                                             dtype=np.uint64).astype(np.uint32)
    if n % 32:
        w[:, -1] |= np.uint32((0xFFFFFFFF << (n % 32)) & 0xFFFFFFFF)
    return w


@pytest.mark.parametrize("n", [1, 31, 33, 1000])
@pytest.mark.parametrize("p", [1, 4, 33, 256])
@pytest.mark.parametrize("fill", ["ones", "zeros", "pad-bits-set"])
def test_popcount_votes_edge_bitmaps_match_jax(fill, p, n):
    """All-ones bitmaps count p everywhere, all-zeros 0, and set pad bits
    past n never reach the output, in the port and in the JAX oracle and
    Pallas kernel (interpret mode, as tests/test_kernels.py runs it)."""
    words = -(-n // 32)
    gathered = _bitmap(fill, p, words, n, p * 1000 + n)
    got = tref.popcount_votes(_t(gathered.view(np.int32)), n).numpy()
    want = np.asarray(jref.popcount_votes(jnp.asarray(gathered), n))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jbitpack.popcount_votes(
        jnp.asarray(gathered), n, interpret=True)))
    if fill != "pad-bits-set":
        assert (got == (p if fill == "ones" else 0)).all()


def _qsgd_input(case, n, seed):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if case == "zeros":                 # norm = 1e-12, every level 0
        g[:] = 0.0
    elif case == "one-hot":             # s == levels exactly: no carry
        g[:] = 0.0
        g[n // 3] = -1.0
    elif case == "signed-zeros":
        g[::3] = -0.0
        g[1::3] = 0.0
    return g


@pytest.mark.parametrize("case,n,levels", [
    ("normal", 33, 1), ("normal", 1000, 7), ("normal", 70_000, 127),
    ("zeros", 1000, 127), ("one-hot", 1000, 127), ("one-hot", 1000, 1),
    ("signed-zeros", 1000, 7)])
def test_qsgd_quantize_matches_jax_bit_for_bit(case, n, levels):
    g = _qsgd_input(case, n, n + levels)
    norm = np.float32(np.linalg.norm(g)) + np.float32(1e-12)
    key = jax.random.key(n * 131 + levels)
    u = np.array(jax.random.uniform(key, (n,), jnp.float32))
    got = tref.qsgd_quantize(_t(g), torch.tensor(norm), levels, _t(u))
    assert got.dtype == torch.int8 and got.shape == (n,)
    want = np.asarray(jref.qsgd_quantize(jnp.asarray(g), jnp.asarray(norm),
                                         levels, key))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(jqsgd.quantize(jnp.asarray(g), jnp.asarray(norm),
                                       levels, key, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert np.abs(got.numpy()).max() <= levels
    if case == "one-hot":
        assert got.numpy()[n // 3] == -levels and np.count_nonzero(got) == 1
    if case in ("zeros", "signed-zeros"):
        assert not got.numpy()[::3].any()


def _mask_input(n, seed):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    special = np.array([-0.0, np.nan, 0.0, -np.inf, np.inf, 1e-30],
                       np.float32)
    g[:special.size] = special
    return g


@pytest.mark.parametrize("n,t", [(6, 0.0), (1000, 0.0), (1000, -1.0),
                                 (1000, 1.5), (70_000, 2.0),
                                 (70_000, np.inf)])
def test_topk_threshold_mask_matches_jax_exactly(n, t):
    g = _mask_input(n, n)
    t = np.float32(t)
    got = tref.topk_threshold_mask(_t(g), torch.tensor(t)).numpy()
    want = np.asarray(jref.topk_threshold_mask(jnp.asarray(g),
                                               jnp.asarray(t)))
    pallas = np.asarray(jtopk.threshold_mask(jnp.asarray(g), jnp.asarray(t),
                                             interpret=True))
    # bit patterns: -0.0 kept where t <= 0, NaN masked to +0.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    assert got[1] == 0 and not np.isnan(got).any()
    if t <= 0:
        assert np.signbit(got[0])


@pytest.mark.parametrize("n,k", [(1000, 10), (70_000, 700), (5_000, 1)])
def test_topk_select_matches_jax(n, k):
    g = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    vals, idx = tref.topk_select(_t(g), k)
    jvals, jidx = jref.topk_select(jnp.asarray(g), k)
    assert idx.dtype == torch.int32 and vals.shape == (k,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("n,frac", [(100_000, 0.01), (1_000_000, 0.01),
                                    (200_000, 0.05)])
def test_sampled_threshold_keeps_about_k(n, frac):
    """The sampled threshold keeps between half and twice k elements at
    MSTop-K's fractions (the JAX package's check)."""
    g = torch.from_numpy(
        np.random.default_rng(n).standard_normal(n).astype(np.float32))
    k = int(n * frac)
    t = tref.sampled_threshold(g, k, torch.Generator().manual_seed(n))
    kept = int((tref.topk_threshold_mask(g, t) != 0).sum())
    assert 0.5 * k <= kept <= 2 * k, (kept, k)


def test_ops_dispatch_cpu_to_plain_and_count_nothing():
    build.reset_launches()
    m, q = torch.randn(40, 128), torch.randn(128, 4)
    assert torch.equal(ops.powersgd_encode(m, q), tref.powersgd_encode(m, q))
    assert torch.equal(ops.powersgd_decode(m @ q, q),
                       tref.powersgd_decode(m @ q, q))
    g = torch.randn(100)
    w = ops.pack_signs(g)
    assert torch.equal(w, tref.pack_signs(g))
    assert torch.equal(ops.popcount_votes(w[None], 100),
                       tref.popcount_votes(w[None], 100))
    norm, u = g.norm() + 1e-12, torch.rand(100)
    assert torch.equal(ops.qsgd_quantize(g, norm, 127, u),
                       tref.qsgd_quantize(g, norm, 127, u))
    t = torch.tensor(0.5)
    assert torch.equal(ops.topk_threshold_mask(g, t),
                       tref.topk_threshold_mask(g, t))
    for a, b in zip(ops.topk_select(g, 7), tref.topk_select(g, 7)):
        assert torch.equal(a, b)
    assert sum(build.LAUNCHES.values()) == 0


def test_ops_run_shape_only_on_meta():
    m = torch.empty(2560, 2560, device="meta")
    q = torch.empty(2560, 4, device="meta")
    assert ops.powersgd_encode(m.T, q).shape == (2560, 4)
    g = torch.empty(6_553_600, device="meta")
    assert ops.pack_signs(g).shape == (204_800,)
    q = ops.qsgd_quantize(g, torch.empty((), device="meta"), 127,
                          torch.empty_like(g))
    assert q.shape == (6_553_600,) and q.dtype == torch.int8
    vals, idx = ops.topk_select(g, 65_536)
    assert vals.shape == idx.shape == (65_536,) and idx.dtype == torch.int32


@pytest.mark.parametrize("call", [
    lambda: kp.encode(torch.randn(4, 8), torch.randn(8, 2)),
    lambda: kp.decode(torch.randn(4, 2), torch.randn(8, 2)),
    lambda: kb.pack_signs(torch.randn(64)),
    lambda: kb.popcount_votes(torch.zeros(2, 2, dtype=torch.int32), 64),
    lambda: kq.quantize(torch.randn(64), torch.tensor(8.0), 127,
                        torch.rand(64)),
    lambda: kt.threshold_mask(torch.randn(64), torch.tensor(0.5)),
], ids=["encode", "decode", "pack_signs", "popcount_votes", "quantize",
        "threshold_mask"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers launch or raise: a CPU tensor is refused before
    anything is built, never handed to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_build_without_nvcc_raises(monkeypatch):
    """Without a CUDA compiler the kernels cannot be built, and building
    says so instead of handing anything to the plain versions."""
    import shutil
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME or shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.lib()


# ------------------------------------------------ PowerSGD launch plans
H100_SMS = 132


def _view(case):
    """A CPU fp32 view for a named layout: (tensor, transposed?)."""
    kind, rows, cols = case
    if kind == "offset1":            # pointer and row stride unaligned
        return torch.zeros(rows * cols + 1)[1:].view(rows, cols)
    if kind == "padded":             # aligned pointer, row stride 130
        return torch.zeros(rows, cols + 2)[:, :cols]
    if kind == "offset4":            # aligned pointer and stride
        return torch.zeros(rows * cols + 4)[4:].view(rows, cols)
    return torch.zeros(rows, cols)


def _plan_of(m, rank=4, sms=H100_SMS):
    return kp.encode_plan(tuple(m.shape), m.stride(), m.storage_offset(),
                          rank, sms)


# (layout, rows, cols) -> (form, vec) of M @ Q and of M^T @ P
PLAN_CASES = [
    (("plain", 2560, 2560), ("rows", 4), ("cols", 4)),   # first bucket
    (("plain", 2302, 2432), ("rows", 4), ("cols", 4)),   # last bucket
    (("plain", 1, 127), ("rows", 1), ("rows", 1)),       # tiny bucket
    (("plain", 127, 1), ("rows", 1), ("rows", 1)),
    (("plain", 37, 129), ("rows", 1), ("cols", 1)),
    (("plain", 1, 128), ("rows", 4), ("rows", 1)),
    (("offset1", 37, 129), ("rows", 1), ("cols", 1)),
    (("offset1", 36, 128), ("rows", 1), ("cols", 1)),
    (("offset4", 36, 128), ("rows", 4), ("cols", 4)),
    (("padded", 8, 128), ("rows", 1), ("cols", 1)),
]


@pytest.mark.parametrize("case,want,want_t", PLAN_CASES,
                         ids=[f"{k}-{r}x{c}" for (k, r, c), _, _ in PLAN_CASES])
def test_encode_plan_picks_the_variant(case, want, want_t):
    """16-byte loads only where the pointer, the row stride and the walked
    length allow them; the transposed view goes to the column form unless
    a size-1 dim makes it a row."""
    m = _view(case)
    for rank in (1, 3, 4, 16):
        assert _plan_of(m, rank)[:2] == want
        assert _plan_of(m.T, rank)[:2] == want_t


@pytest.mark.parametrize("rows,cols,vec", [(2560, 2560, 4), (2302, 2432, 4),
                                           (1, 127, 1), (127, 1, 1),
                                           (37, 129, 1), (129, 37, 1)])
def test_decode_plan_picks_the_variant(rows, cols, vec):
    for rank in (1, 4, 16):
        plan = kp.decode_plan(rows, cols, rank, H100_SMS)
        assert (plan.form, plan.vec) == ("decode", vec)
        width = 32 * vec * kp.DECODE_CWARPS
        assert plan.tiles * width >= cols > (plan.tiles - 1) * width
        assert plan.xvec == (4 if rank % 4 == 0 else 1)
        assert kp.decode_plan(rows, cols, rank, H100_SMS, 1).xvec == 1


def test_factor_rows_are_read_as_float4_only_where_aligned():
    m = torch.zeros(64, 128)
    for rank, x_offset, xvec in ((4, 0, 4), (16, 4, 4), (8, 2, 1), (3, 0, 1),
                                 (1, 0, 1)):
        for view in (m, m.T):
            plan = kp.encode_plan(tuple(view.shape), view.stride(), 0, rank,
                                  H100_SMS, x_offset)
            assert plan.xvec == xvec, (rank, x_offset, plan)


def _covered(n, plan):
    """How many splits hold each of the n reduction elements."""
    hits = np.zeros(n, np.int64)
    for y in range(plan.splits):
        lo, hi = y * plan.per, min(n, (y + 1) * plan.per)
        assert lo < hi or n == 0, f"split {y} of {plan} is empty"
        hits[lo:hi] += 1
    return hits


@pytest.mark.parametrize("sms", [1, 8, 114, H100_SMS, 144])
@pytest.mark.parametrize("rows,cols", [(2560, 2560), (2302, 2432), (1, 127),
                                       (127, 1), (37, 129), (1, 1),
                                       (40_000, 164), (3, 70_000), (5, 0)])
def test_split_plans_cover_the_reduction_once(rows, cols, sms):
    m = torch.zeros(rows, cols)
    for view, n_a, n_b in ((m, rows, cols), (m.T, cols, rows)):
        plan = _plan_of(view, 4, sms)
        assert (_covered(n_b, plan) == 1).all(), plan
        assert 1 <= plan.splits <= 65535
        if plan.form == "rows":      # the splits cut along 16-byte words
            assert plan.per % 4 == 0
        tile = kp.ROWS_THREADS // 32 * kp.ROWS_PER_WARP \
            if plan.form == "rows" else 32 * plan.vec
        assert plan.tiles == -(-n_a // tile)
    if cols:
        plan = kp.decode_plan(rows, cols, 4, sms)
        assert (_covered(rows, plan) == 1).all() and plan.splits <= 65535


@pytest.mark.parametrize("rows,cols", [(2560, 2560), (2302, 2432)])
def test_split_plans_fill_the_card_at_the_bucket_shapes(rows, cols):
    """At both bucket shapes every PowerSGD launch has at least one block
    for each SM of an H100, and about WARPS_PER_SM on each: at
    least three quarters of it (the splits are whole multiples of a warp's
    unrolled step), and less than one split more."""
    m = torch.zeros(rows, cols)
    plans = [_plan_of(m), _plan_of(m.T), kp.decode_plan(rows, cols, 4,
                                                        H100_SMS)]
    threads = {"rows": kp.ROWS_THREADS, "cols": kp.COLS_THREADS,
               "decode": kp.DECODE_THREADS}
    for plan in plans:
        assert (plan.vec, plan.xvec) == (4, 4)
        per_split = plan.tiles * threads[plan.form] // 32
        want = kp.WARPS_PER_SM * H100_SMS
        assert plan.tiles * plan.splits >= H100_SMS, plan
        assert 0.75 * want <= per_split * plan.splits < want + per_split


# ------------------------------------------------ vote-count launch plans
BUCKET_NS = [6_553_600, 5_597_184]       # the main path's two bucket sizes


def _walk(plan):
    """How many times the kernel's warps visit each word group: warp w
    takes groups w * per_warp + j, then strides by every warp's share."""
    n_warps = plan.blocks * kb.VOTES_THREADS // 32
    hits = np.zeros(plan.groups + plan.per_warp * n_warps, np.int64)
    for warp in range(n_warps):
        starts = np.arange(warp * plan.per_warp, plan.groups,
                           n_warps * plan.per_warp)
        for j in range(plan.per_warp):
            np.add.at(hits, starts + j, 1)
    return hits[:plan.groups]


@pytest.mark.parametrize("sms", [1, 8, 114, H100_SMS, 144])
@pytest.mark.parametrize("p", [1, 4, 256])
@pytest.mark.parametrize("n", [0, 1, 33, 1024, 1025, 4097, 1_000_003,
                               *BUCKET_NS])
def test_votes_plan_covers_every_group_once(n, p, sms):
    """Every group of 32 words (1024 counts) is visited by exactly one
    warp, and the groups cover the n counts and no group more."""
    plan = kb.votes_plan(p, -(-n // 32), n, sms)
    assert plan.groups == -(-n // kb.GROUP_ELEMS)
    assert plan.groups * kb.GROUP_ELEMS >= n > \
        (plan.groups - 1) * kb.GROUP_ELEMS or n == 0
    assert (_walk(plan) == 1).all(), plan


@pytest.mark.parametrize("p", [1, 4, 16, 512])
def test_votes_plan_sizes_the_grid_from_the_sm_count(p):
    """The grid is never more than VOTES_BLOCKS_PER_SM blocks per SM; where
    the groups are fewer it is as many blocks as they fill, so at both of
    the main path's bucket sizes an H100 runs it in one resident wave."""
    for n in (1, 100_000, *BUCKET_NS, 200_000_000):
        words = -(-n // 32)
        for sms in (1, 8, H100_SMS):
            plan = kb.votes_plan(p, words, n, sms)
            cap = kb.VOTES_BLOCKS_PER_SM * sms
            warps = -(-plan.groups // plan.per_warp)
            assert 1 <= plan.blocks <= cap
            assert plan.blocks == min(cap, -(-warps // (kb.VOTES_THREADS
                                                        // 32)))
    full, last = (kb.votes_plan(p, -(-n // 32), n, H100_SMS)
                  for n in BUCKET_NS)
    if p < 256:
        assert (full.blocks, last.blocks) == (400, 342)


@pytest.mark.parametrize("p,planes,wide", [(1, 1, False), (2, 2, False),
                                           (3, 2, False), (4, 3, False),
                                           (16, 5, False), (255, 8, False),
                                           (256, 8, True), (512, 8, True)])
def test_votes_plan_counts_in_bit_length_planes(p, planes, wide):
    """bit_length(p) planes hold every count up to p; from p = 256 the
    kernel counts in chunks of 255 rows, one group per warp step."""
    plan = kb.votes_plan(p, 32, 1000, H100_SMS)
    assert (plan.planes, plan.wide) == (planes, wide)
    assert plan.per_warp == (1 if wide else kb.VOTES_GROUPS)
    assert p < 2**plan.planes or wide


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1024, 4097, *BUCKET_NS])
def test_votes_plan_splits_the_tail(n):
    """The first n - n % 4 counts go out in 16-byte stores, the last
    n % 4 one by one: the kernel's 16-byte store at element e (a multiple
    of 4) is taken exactly where e + 4 <= n."""
    plan = kb.votes_plan(4, -(-n // 32) + 1, n, H100_SMS)
    assert plan.vec_elems + plan.scalar_elems == n
    assert plan.vec_elems % 4 == 0 and 0 <= plan.scalar_elems < 4
    vec = [e for e in range(0, plan.groups * kb.GROUP_ELEMS, 4) if e + 4 <= n]
    assert len(vec) * 4 == plan.vec_elems


@pytest.mark.parametrize("p,words,n", [(1, 2**26, 2**31), (4, 2**27, 2**32),
                                       (1, 2, 65), (0, 4, 64), (-1, 4, 64),
                                       (1, 4, -1)])
def test_votes_plan_refuses(p, words, n):
    """n from 2**31 (32-bit element indices), n past 32 x words, and p < 1
    raise ValueError."""
    with pytest.raises(ValueError):
        kb.votes_plan(p, words, n, H100_SMS)


def test_votes_plan_takes_n_just_below_2_31():
    plan = kb.votes_plan(1, 2**26, 2**31 - 1, H100_SMS)
    assert plan.blocks == kb.VOTES_BLOCKS_PER_SM * H100_SMS
    assert plan.scalar_elems == 3


def test_both_wrappers_read_the_sm_count_from_build(monkeypatch):
    """The SM count lives in ``build.sms`` (read once per device): the
    PowerSGD wrappers plan with it before they launch, the vote count's
    plan takes it as an argument, and neither wrapper module keeps its
    own."""
    seen = []

    class Planned(Exception):
        pass

    def sms(dev):
        seen.append(dev)
        raise Planned

    monkeypatch.setattr(build, "sms", sms)
    monkeypatch.setattr(kp, "_require_cuda_fp32", lambda name, t: None)
    monkeypatch.setattr(build, "lib", lambda: pytest.fail("launched"))
    with pytest.raises(Planned):
        kp.encode(torch.empty(64, 128, device="meta"),
                  torch.empty(128, 4, device="meta"))
    with pytest.raises(Planned):
        kp.decode(torch.empty(64, 4, device="meta"),
                  torch.empty(128, 4, device="meta"))
    assert seen == [torch.device("meta")] * 2
    assert not hasattr(kp, "_sms") and not hasattr(kb, "_sms")
    assert kb.votes_plan(1, 204_800, 6_553_600, 7).blocks == \
        kb.VOTES_BLOCKS_PER_SM * 7


@pytest.fixture
def meta_ok(monkeypatch):
    """Let the wrappers take ``meta`` tensors as if they lay on the card,
    so that their refusals can be reached without one; anything that
    would reach the kernel library fails."""
    monkeypatch.setattr(kp, "_require_cuda_fp32", lambda name, t: None)
    monkeypatch.setattr(build, "lib", lambda: pytest.fail("launched"))


@pytest.mark.parametrize("rank", [0, 17])
def test_wrappers_refuse_ranks_outside_1_to_16(meta_ok, rank):
    m = torch.empty(64, 128, device="meta")
    with pytest.raises(ValueError, match="rank"):
        kp.encode(m, torch.empty(128, rank, device="meta"))
    with pytest.raises(ValueError, match="rank"):
        kp.decode(torch.empty(64, rank, device="meta"),
                  torch.empty(128, rank, device="meta"))
    with pytest.raises(ValueError, match="rank"):
        kp.encode_plan((64, 128), (128, 1), 0, rank, H100_SMS)


def test_encode_refuses_strides_with_no_unit_dim(meta_ok):
    m = torch.empty_strided((64, 128), (256, 2), device="meta")
    with pytest.raises(ValueError, match="unit stride"):
        kp.encode(m, torch.empty(128, 4, device="meta"))
    with pytest.raises(ValueError, match="unit stride"):
        kp.encode_plan((64, 128), (256, 2), 0, 4, H100_SMS)


def test_arrival_counters_are_kept_per_stream(monkeypatch):
    """Encodes on one stream share their arrival counters (each launch
    leaves them zeroed for the next); encodes on two streams, which may
    overlap, never share them."""
    monkeypatch.setattr(kp, "_counters", {})
    dev = torch.device("cpu")
    a = kp._counters_for(dev, 1, 20)
    assert kp._counters_for(dev, 1, 20) is a and a.numel() >= 20
    assert not a.any() and a.dtype == torch.int32
    b = kp._counters_for(dev, 2, 20)
    assert b is not a and b.data_ptr() != a.data_ptr()
    big = kp._counters_for(dev, 1, a.numel() + 1)
    assert big.numel() > a.numel() and kp._counters_for(dev, 2, 20) is b
