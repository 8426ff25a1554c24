"""The port's RBF kernel block against ``ital_tpu``'s, and its CUDA wrapper's contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.ops import pallas_rbf
from ital_tpu.ops.kernels import rbf_kernel as jax_rbf
from ital_tpu_torch.ops import _build, rbf_hopper
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(rng, m=37, n=53, d=16):
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("norms", ["none", "a2", "b2", "both"])
def test_plain_rbf_matches_jax(rng, norms):
    """f32 values within 1e-5 (times var) of the reference, with and without
    precomputed norms."""
    a, b = _pair(rng)
    kw_np = {}
    if norms in ("a2", "both"):
        kw_np["a2"] = (a * a).sum(-1)
    if norms in ("b2", "both"):
        kw_np["b2"] = (b * b).sum(-1)
    want = np.asarray(jax_rbf(jnp.asarray(a), jnp.asarray(b), 2.3, 0.7,
                              **{k: jnp.asarray(v) for k, v in kw_np.items()}))
    got = rbf_kernel(torch.from_numpy(a), torch.from_numpy(b), 2.3, 0.7,
                     **{k: torch.from_numpy(v) for k, v in kw_np.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * 0.7)


def test_plain_rbf_bf16_corpus_matches_jax(rng):
    """A bf16-stored corpus: norms and products in f32 from the stored values,
    as the reference does; self-distances cancel to exactly var."""
    a, b = _pair(rng, d=32)
    ab16 = jnp.asarray(a, jnp.bfloat16)
    bb16 = jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jax_rbf(ab16, bb16, 3.0, 1.0))
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = rbf_kernel(at, bt, 3.0, 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    self_k = rbf_kernel(at, at, 3.0, 1.0)
    np.testing.assert_allclose(torch.diagonal(self_k).numpy(), 1.0, atol=1e-6)


def test_plain_rbf_matches_pallas_kernel_interpret(rng, monkeypatch):
    """A tile-multiple shape against the Pallas TPU kernel in interpret mode,
    the way tests/test_pallas.py runs it."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    a = rng.normal(size=(256, 32)).astype(np.float32)
    b = rng.normal(size=(512, 32)).astype(np.float32)
    want = pallas_rbf.rbf_kernel_pallas.__wrapped__(
        jnp.asarray(a), jnp.asarray(b), 1.7, 0.9, tile_m=256, tile_n=256
    )
    got = rbf_kernel(torch.from_numpy(a), torch.from_numpy(b), 1.7, 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_tensors_take_the_plain_version(rng):
    """rbf_kernel on CPU tensors never reaches the CUDA wrapper."""
    a, b = _pair(rng)
    before = rbf_hopper.LAUNCHES
    got = rbf_kernel(torch.from_numpy(a), torch.from_numpy(b), 1.0, 1.0)
    want = rbf_kernel_plain(torch.from_numpy(a), torch.from_numpy(b), 1.0, 1.0)
    assert torch.equal(got, want)
    assert rbf_hopper.LAUNCHES == before


def test_cpu_block_written_into_out(rng):
    """``out=`` takes the block in place, the values of a new block."""
    a, b = (torch.from_numpy(t) for t in _pair(rng))
    out = torch.full((a.shape[0], b.shape[0]), float("nan"))
    got = rbf_kernel(a, b, 1.3, 0.7, b2=(b * b).sum(-1), out=out)
    assert got is out
    assert torch.equal(out, rbf_kernel(a, b, 1.3, 0.7, b2=(b * b).sum(-1)))
    with pytest.raises(ValueError, match="differentiates"):
        rbf_kernel(a, b, torch.tensor(1.3, requires_grad=True), 0.7, out=out)


@pytest.mark.parametrize("case,exc,match", [
    ("f64", TypeError, "float32 or bfloat16"),
    ("mixed_dtype", TypeError, "float32 or bfloat16"),
    ("one_d", ValueError, "2-D"),
    ("width", ValueError, "equal width"),
    ("strided", ValueError, "contiguous"),
    ("norm_shape", ValueError, "a2"),
    ("norm_dtype", ValueError, "b2"),
    ("cpu", ValueError, "CUDA device"),
    ("out_shape", ValueError, "out must be"),
    ("out_layout", ValueError, "out must be"),
    ("out_misaligned", ValueError, "16-byte-aligned"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    a = torch.zeros(8, 4)
    b = torch.zeros(5, 4)
    kw = {}
    if case == "f64":
        a, b = a.double(), b.double()
    elif case == "mixed_dtype":
        b = b.to(torch.bfloat16)
    elif case == "one_d":
        a = torch.zeros(8)
    elif case == "width":
        b = torch.zeros(5, 3)
    elif case == "strided":
        a = torch.zeros(4, 8).T
    elif case == "norm_shape":
        kw["a2"] = torch.zeros(7)
    elif case == "norm_dtype":
        kw["b2"] = torch.zeros(5, dtype=torch.float64)
    elif case == "out_shape":
        kw["out"] = torch.zeros(8, 4)
    elif case == "out_layout":
        kw["out"] = torch.zeros(5, 8).T
    elif case == "out_misaligned":
        kw["out"] = torch.zeros(8 * 5 + 1)[1:].view(8, 5)  # 4 bytes past an aligned base
    before = rbf_hopper.LAUNCHES
    with pytest.raises(exc, match=match):
        rbf_hopper.rbf_tile(a, b, 1.0, 1.0, **kw)
    assert rbf_hopper.LAUNCHES == before


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """No nvcc on PATH or under $CUDA_HOME: a clear error, no fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """The built library is keyed by the sources' hash: an edit builds anew."""
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
