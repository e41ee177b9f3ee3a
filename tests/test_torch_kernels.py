"""The port's plain kernel versions (``repro_torch.kernels.ref``) against the
JAX package's oracles (``repro.kernels.ref``) on the same numpy inputs, and
the dispatch rules of ``repro_torch.kernels.ops``.

Tolerances: the bit kernels are exact; the fp32 products use
``rtol=atol=1e-5`` (both sides accumulate in fp32, in different orders).
M is drawn with variance 1 / max(rows, cols) so that the products are of
order one and the tolerance is relative to the values compared.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import bitpack as kb
from repro_torch.kernels import build, ops
from repro_torch.kernels import powersgd as kp
from repro_torch.kernels import ref as tref

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
@pytest.mark.parametrize("p", [1, 3, 4])
def test_popcount_votes_match_jax(n, p):
    rng = np.random.default_rng(n * 10 + p)
    words = -(-n // 32)
    gathered = rng.integers(0, 2**32, (p, words), dtype=np.uint64) \
        .astype(np.uint32)
    got = tref.popcount_votes(_t(gathered.view(np.int32)), n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.popcount_votes(jnp.asarray(gathered), n)))


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
    assert sum(build.LAUNCHES.values()) == 0


def test_ops_run_shape_only_on_meta():
    m = torch.empty(2560, 2560, device="meta")
    q = torch.empty(2560, 4, device="meta")
    assert ops.powersgd_encode(m.T, q).shape == (2560, 4)
    assert ops.pack_signs(torch.empty(6_553_600, device="meta")).shape \
        == (204_800,)


@pytest.mark.parametrize("call", [
    lambda: kp.encode(torch.randn(4, 8), torch.randn(8, 2)),
    lambda: kp.decode(torch.randn(4, 2), torch.randn(8, 2)),
    lambda: kb.pack_signs(torch.randn(64)),
    lambda: kb.popcount_votes(torch.zeros(2, 2, dtype=torch.int32), 64),
], ids=["encode", "decode", "pack_signs", "popcount_votes"])
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
