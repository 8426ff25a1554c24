"""The RBF wrapper's route choice, and why the tensor-core route takes 3xTF32.

Both run on the CPU: the router is pure Python over shape, dtype and
alignment, and TF32 rounding is emulated with bit operations on an f32 view.
"""

import numpy as np
import pytest
import torch

from ital_tpu_torch.data.datasets import _synthetic_surrogate
from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.ops.kernels import rbf_kernel_plain

F32, BF16 = torch.float32, torch.bfloat16
ALIGNED = 0x7F0000000000  # a 256-byte aligned device address, as torch allocates


@pytest.mark.parametrize("shape,dtype,route", [
    # chip_smoke phase 3's shapes, with the route each takes.
    ((64, 25000, 512), F32, rbf_hopper.Route("wgmma", 1, False)),
    ((4, 25000, 512), F32, rbf_hopper.Route("wgmma", 1, False)),
    ((4096, 3, 512), F32, rbf_hopper.Route("wgmma", 1, True)),
    ((64, 64, 512), F32, rbf_hopper.Route("wgmma", 1, False)),
    ((25000, 3, 512), F32, rbf_hopper.Route("wgmma", 1, True)),
    ((100, 300, 8), F32, rbf_hopper.Route("tile")),
    ((64, 25000, 512), BF16, rbf_hopper.Route("wgmma", 1, False)),
    ((25000, 2048, 512), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((25000, 512, 512), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((2048, 25000, 512), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((25000, 48, 512), F32, rbf_hopper.Route("wgmma", 1, True)),
    ((129, 257, 100), F32, rbf_hopper.Route("tile")),
    ((25000, 2048, 512), BF16, rbf_hopper.Route("wgmma", 0, False)),
    # the edges of the rule
    ((25000, 64, 512), F32, rbf_hopper.Route("wgmma", 1, True)),
    ((65, 25000, 512), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((4, 4, 128), F32, rbf_hopper.Route("wgmma", 1, False)),
    ((4, 4, 124), F32, rbf_hopper.Route("tile")),
    ((64, 4000, 124), F32, rbf_hopper.Route("tile")),
    ((64, 25000, 124), F32, rbf_hopper.Route("wgmma", 1, False)),
    ((1024, 1024, 8), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((1023, 1024, 8), F32, rbf_hopper.Route("tile")),
    ((1, 1, 3), F32, rbf_hopper.Route("tile")),
    ((300, 700, 510), F32, rbf_hopper.Route("tile")),      # D % 4 != 0: rows not 16-byte multiples
    ((300, 700, 516), BF16, rbf_hopper.Route("tile")),     # D % 8 != 0 for bf16
    ((300, 700, 516), F32, rbf_hopper.Route("wgmma", 0, False)),
    ((300, 700, 520), BF16, rbf_hopper.Route("wgmma", 0, False)),
])
def test_route_at_each_shape(shape, dtype, route):
    m, n, d = shape
    assert rbf_hopper.choose_route(m, n, d, dtype, ALIGNED, ALIGNED + 4096) == route


def test_misaligned_pointers_take_the_tile_kernel():
    """TMA needs 16-byte aligned base pointers: a row-offset view with D = 6
    (24-byte rows) and a flat one-element offset with D = 8 both go to the
    tile kernel, and forcing the tensor-core route on them raises."""
    x6 = torch.zeros(400, 6)
    a6 = x6[1:]
    assert a6.data_ptr() % 16 != 0
    flat = torch.zeros(400 * 8 + 1)
    a8 = flat[1:].view(400, 8)
    assert a8.is_contiguous() and a8.data_ptr() % 16 != 0
    b8 = torch.zeros(300, 8)
    assert b8.data_ptr() % 16 == 0
    for a, b in ((a6, x6[:300]), (a8, b8), (b8, a8)):
        args = (a.shape[0], b.shape[0], a.shape[1], a.dtype, a.data_ptr(), b.data_ptr())
        assert rbf_hopper.choose_route(*args) == rbf_hopper.Route("tile")
        assert rbf_hopper.choose_route(*args, force="tile") == rbf_hopper.Route("tile")
        with pytest.raises(ValueError, match="16-byte"):
            rbf_hopper.choose_route(*args, force="wgmma")
    aligned = (300, 300, 8, F32, b8.data_ptr(), b8.data_ptr())
    assert rbf_hopper.choose_route(*aligned, force="wgmma").name == "wgmma"


def test_forced_routes():
    """A forced route overrides the size thresholds only, never alignment."""
    small = (4, 3, 64, F32, ALIGNED, ALIGNED)
    assert rbf_hopper.choose_route(*small) == rbf_hopper.Route("tile")
    assert rbf_hopper.choose_route(*small, force="wgmma") == rbf_hopper.Route("wgmma", 1, False)
    assert rbf_hopper.choose_route(25000, 3, 64, F32, ALIGNED, ALIGNED, force="wgmma") == \
        rbf_hopper.Route("wgmma", 1, True)
    wide = (2048, 2048, 512, F32, ALIGNED, ALIGNED)
    assert rbf_hopper.choose_route(*wide, force="tile") == rbf_hopper.Route("tile")
    with pytest.raises(ValueError, match="unknown route"):
        rbf_hopper.choose_route(*wide, force="cublas")


def test_route_counts_start_at_zero_for_both_routes():
    assert set(rbf_hopper.ROUTE_LAUNCHES) == {"wgmma", "tile"}


def test_scalar_args_by_value_or_in_place():
    """A number goes by value; a 0-d f32 tensor on the device is passed as it
    is; any other one-element tensor becomes a 0-d f32 one; the rest raise."""
    cpu = torch.device("cpu")
    assert rbf_hopper._scalar_arg(2.5, cpu, "ls") == (None, 2.5)
    t = torch.tensor(3.0)
    same, _ = rbf_hopper._scalar_arg(t, cpu, "ls")
    assert same is t
    made, _ = rbf_hopper._scalar_arg(torch.tensor([[3.0]], dtype=torch.float64), cpu, "ls")
    assert made.dim() == 0 and made.dtype == F32 and float(made) == 3.0
    with pytest.raises(ValueError, match="one-element"):
        rbf_hopper._scalar_arg(torch.ones(2), cpu, "ls")


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding to nearest with
    ties away from zero (add half of the dropped range to the magnitude bits,
    then clear them), on finite f32 values."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rna_emulation_rounds_like_the_card():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11), 1.0 + 2**-12,
                      2.0 - 2**-12], dtype=F32)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0, 2.0], dtype=F32)
    assert torch.equal(_tf32_rna(x), want)


def test_3xtf32_meets_the_f32_bound_where_1xtf32_does_not():
    """The error budget of the tensor-core route, on a 2000 x 512 MIRFLICKR
    surrogate (ReLU features, squared norms ~5000) at ls = 50, var = 1.

    The dot products are formed from emulated TF32 parts, each product exact
    (11-bit by 11-bit mantissas fit f32) and summed in f64, so this measures
    the operand rounding alone; the card also accumulates in f32, as the
    plain version does.  Against the plain f32 version: 3xTF32
    (big.big + big.small + small.big) stays within 1e-5 x var (measured
    ~2.3e-6, all of it the plain version's own f32 error: 3xTF32 is within
    ~3e-7 of the exact f64 kernel), while one TF32 pass misses it by ~58x
    (~5.8e-4: dot errors of ~1.7 on dot products of thousands).
    """
    x = torch.from_numpy(_synthetic_surrogate("mirflickr", 2000, 512, 14, seed=0).x)
    a, b = x[:256], x
    ls, var = 50.0, 1.0
    a2 = (a * a).sum(-1).double()
    b2 = (b * b).sum(-1).double()

    def kern(ab):
        d2 = torch.clamp(a2[:, None] + b2[None, :] - 2.0 * ab, min=0.0)
        return var * torch.exp(-d2 / (2.0 * ls**2))

    def dot(p, q):
        return p.double() @ q.double().T

    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    one_pass = kern(dot(a_big, b_big))
    three_pass = kern(dot(a_small, b_big) + dot(a_big, b_small) + dot(a_big, b_big))
    exact = kern(dot(a, b))
    plain = rbf_kernel_plain(a, b, ls, var).double()

    err3 = float((three_pass - plain).abs().max())
    err1 = float((one_pass - plain).abs().max())
    assert err3 <= 1e-5 * var
    assert float((three_pass - exact).abs().max()) <= 1e-6 * var
    assert err1 > 10 * 1e-5 * var
    np.testing.assert_allclose(three_pass.numpy(), exact.numpy(), atol=1e-6)
