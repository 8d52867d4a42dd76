"""Port parity: packed-bit ops and the projection kernel's plain version
(bbbp_tpu_torch.ops.bitops against bbbp_tpu.ops.bitops on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import bitops as tbit  # noqa: E402


# The JAX package is the reference; it is imported by fixtures so that the
# CUDA test below also runs where JAX is absent (on the card's machine).
@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def jbit():
    return pytest.importorskip("bbbp_tpu.ops.bitops")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _folded(rng, d, k):
    sm = rng.random(d).astype(np.float32)
    ss = rng.random(d).astype(np.float32) + 0.5
    pm = rng.standard_normal(d).astype(np.float32)
    comp = rng.standard_normal((k, d)).astype(np.float32) / np.sqrt(d)
    return sm, ss, pm, comp


@pytest.mark.parametrize("n_bits", [64, 2048])
def test_pack_bits_bit_equal(n_bits, jbit):
    dense = (np.random.default_rng(1).random((50, n_bits)) < 0.05).astype(np.float32)
    got, want = tbit.pack_bits(dense), jbit.pack_bits(dense)
    assert got.dtype == np.uint32 and got.shape == (50, n_bits // 32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_bits", [2048, 2000])
@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_unpack_equal(n_bits, dtype, jnp, jbit):
    """Exact: the unpack is integer work. n_bits 2000 drops the top bits of
    the last word, as unpack_bits_jnp slices them."""
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 2**32, size=(40, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jbit.unpack_bits_jnp(jnp.asarray(packed), n_bits))
    got = tbit.unpack_bits_reference(
        torch.from_numpy(packed.view(np.int32)).view(getattr(torch, dtype)), n_bits)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_project_weights_equal(jbit):
    """Exact: the same numpy arithmetic on the same inputs."""
    folded = _folded(np.random.default_rng(3), 256, 8)
    w, c0 = tbit.project_weights(*folded)
    jw, jc0 = jbit.project_weights(*folded)
    assert w.flags.c_contiguous
    assert np.array_equal(w, jw) and np.array_equal(c0, jc0)


def test_packed_project_reference_matches_jax(jnp, jbit):
    """d=2048, k=30, N=300 against _packed_project_jnp (f32 on both sides);
    rtol 1e-5, atol 1e-4 because the two matmuls sum in different orders."""
    rng = np.random.default_rng(4)
    w, c0 = tbit.project_weights(*_folded(rng, 2048, 30))
    packed = tbit.pack_bits(rng.random((300, 2048)) < 0.05)
    want = np.asarray(jbit._packed_project_jnp(jnp.asarray(packed),
                                               jnp.asarray(w), jnp.asarray(c0)))
    got = tbit.packed_project_reference(torch.from_numpy(packed.view(np.int32)),
                                        torch.from_numpy(w), torch.from_numpy(c0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(5)
    w, c0 = (torch.from_numpy(a) for a in tbit.project_weights(*_folded(rng, 2048, 30)))
    packed = torch.from_numpy(tbit.pack_bits(rng.random((64, 2048)) < 0.05).view(np.int32))
    tbit.packed_project.launches.reset()
    got = tbit.packed_project(packed, w, c0)
    assert tbit.packed_project.launches.count == 0
    assert torch.equal(got, tbit.packed_project_reference(packed, w, c0))


@pytest.mark.parametrize("case", ["float_words", "too_few_words", "bad_c0",
                                  "strided", "f64_weights"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    w = torch.zeros((2048, 30))
    c0 = torch.zeros(30)
    packed = torch.zeros((8, 64), dtype=torch.int32)
    if case == "float_words":
        packed = packed.float()
    elif case == "too_few_words":
        packed = packed[:, :32].contiguous()
    elif case == "bad_c0":
        c0 = torch.zeros(29)
    elif case == "strided":
        packed = torch.zeros((8, 128), dtype=torch.int32)[:, ::2]
    elif case == "f64_weights":
        w = w.double()
    with pytest.raises((TypeError, ValueError)):
        tbit.packed_project(packed, w, c0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda(cuda_device):
    """The CUDA kernel against its plain version on the card at the slice's
    shapes; atol 1e-4, rtol 1e-5 (summation order differs)."""
    rng = np.random.default_rng(6)
    w, c0 = (torch.from_numpy(a).to(cuda_device)
             for a in tbit.project_weights(*_folded(rng, 2048, 30)))
    for n in (1, 255, 16385):
        dense = rng.random((n, 2048)) < 0.05
        dense[-1] = True
        packed = torch.from_numpy(tbit.pack_bits(dense).view(np.int32)).to(cuda_device)
        before = tbit.packed_project.launches.count
        got = tbit.packed_project(packed, w, c0)
        assert tbit.packed_project.launches.count == before + 1
        want = tbit.packed_project_reference(packed, w, c0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
