"""The CUDA RBF kernel against its plain version, on a card.

No JAX here, so this file also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain


@pytest.mark.cuda
@pytest.mark.parametrize("shape,norms,dtype", [
    ((64, 2500, 512), "b2", torch.float32),
    ((4, 2500, 512), "b2", torch.float32),
    ((2500, 3, 512), "a2", torch.float32),
    ((64, 64, 512), "none", torch.float32),
    ((100, 300, 8), "none", torch.float32),
    ((1, 1, 3), "none", torch.float32),
    ((64, 2500, 512), "b2", torch.bfloat16),
    ((100, 300, 8), "none", torch.bfloat16),
])
def test_cuda_kernel_matches_plain(shape, norms, dtype):
    """f32 within 1e-5 x var of the plain version; bf16 within 1e-4 x var of
    the plain version on the same bf16 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    m, n, d = shape
    a = torch.from_numpy(rng.random((m, d), dtype=np.float32)).cuda().to(dtype)
    b = torch.from_numpy(rng.random((n, d), dtype=np.float32)).cuda().to(dtype)
    kw = {}
    if norms == "a2":
        kw["a2"] = (a.float() ** 2).sum(-1)
    if norms == "b2":
        kw["b2"] = (b.float() ** 2).sum(-1)
    ls = torch.tensor(float(np.sqrt(d)), device="cuda")
    before = rbf_hopper.LAUNCHES
    got = rbf_kernel(a, b, ls, 0.8, **kw)
    want = rbf_kernel_plain(a, b, ls, 0.8, **kw)
    torch.cuda.synchronize()
    assert rbf_hopper.LAUNCHES == before + 1
    atol = (1e-4 if dtype == torch.bfloat16 else 1e-5) * 0.8
    assert float((got - want).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_blockwise_reduce_abs_kpost_matches_plain(dtype):
    """The EMOC column sums on the card, one kernel launch per candidate block,
    against the same function on the CPU's plain path.  Each |k_post| entry
    differs by a few f32 ulps of var; a column sums N of them (atol 4e-7 x N);
    bf16 inputs are the same stored values on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost

    rng = np.random.default_rng(1)
    n, d, cap = 3000, 64, 24
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dtype)
    x2 = (x.float() ** 2).sum(-1)
    v = torch.from_numpy(rng.normal(scale=0.1, size=(cap, n)).astype(np.float32))
    cand = torch.arange(5, n, 3)
    want = blockwise_reduce_abs_kpost(x, v, cand, 4.0, 0.9, x2=x2, block=256)
    before = rbf_hopper.LAUNCHES
    got = blockwise_reduce_abs_kpost(x.cuda(), v.cuda(), cand.cuda(), 4.0, 0.9, x2=x2.cuda(),
                                     block=256)
    torch.cuda.synchronize()
    assert rbf_hopper.LAUNCHES == before + -(-cand.shape[0] // 256)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=4e-7 * n)


@pytest.mark.cuda
def test_cuda_empty_output_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a = torch.zeros(0, 16, device="cuda")
    b = torch.ones(5, 16, device="cuda")
    before = rbf_hopper.LAUNCHES
    assert rbf_kernel(a, b, 1.0, 1.0).shape == (0, 5)
    assert rbf_hopper.LAUNCHES == before
