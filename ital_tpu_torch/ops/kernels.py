"""RBF kernel blocks: the plain PyTorch version and the one entry point.

:func:`rbf_kernel` is what every caller uses.  On a CPU tensor it runs the
plain version below (:func:`rbf_kernel_plain`, the port of
``ital_tpu.ops.kernels.rbf_kernel``); on a CUDA tensor it launches one of the
hand-written kernels of :mod:`ital_tpu_torch.ops.rbf_hopper`, which picks the
route and raises on anything the kernels do not take.  No path falls back
from a kernel to the plain version.  Where the length scale or the variance
requires grad (hyperparameter learning), :class:`RBFHyperGrad` carries the
gradient past the kernel.  The blockwise consumers below
(:func:`rbf_kernel_blockwise`, :func:`blockwise_reduce_abs_kpost`) and the
cohort programs' :func:`rbf_sessions` form their blocks through it.

The posterior-covariance consumers count what they form, while tracing is on
(``utils/logging.py``; inside a program at its capture, and at each replay):
``kernels.kpost_blocks``, one per (N, block) posterior-covariance block a
session forms, and ``kernels.kpost_bytes``, its bytes (N x block x 4 in
float32).  A consumer that never writes such a block counts neither.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.utils.logging import count


def sqdist(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pairwise squared Euclidean distances between rows of ``a`` (M,D) and ``b`` (N,D).

    ``||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b``, clamped at zero.  ``a2``/``b2``
    optionally supply precomputed squared row norms ((M,) / (N,)).  Norms and
    the dot accumulate in at least f32 whatever the storage dtype: a bf16
    corpus is upcast (exactly) before the product, as the reference's
    ``preferred_element_type=float32`` does.
    """
    nt = torch.promote_types(a.dtype, torch.float32)
    af = a.to(nt)
    bf = b.to(nt)
    if a2 is None:
        a2 = (af * af).sum(-1)
    if b2 is None:
        b2 = (bf * bf).sum(-1)
    ab = af @ bf.T
    return torch.clamp(a2[:, None] + b2[None, :] - 2.0 * ab, min=0.0)


def rbf_kernel_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    length_scale: torch.Tensor | float,
    var: torch.Tensor | float = 1.0,
    *,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``var * exp(-||a-b||^2 / (2 ls^2))`` in plain PyTorch, on any device."""
    d2 = sqdist(a, b, a2=a2, b2=b2)
    return var * torch.exp(-d2 / (2.0 * length_scale**2))


def _rbf_forward(a, b, length_scale, var, a2, b2, out=None) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        k = rbf_kernel_plain(a, b, length_scale, var, a2=a2, b2=b2)
        return k if out is None else out.copy_(k)
    return rbf_hopper.rbf_tile(a, b, length_scale, var, a2=a2, b2=b2, out=out)


def _requires_grad(v) -> bool:
    return isinstance(v, torch.Tensor) and v.requires_grad


class RBFHyperGrad(torch.autograd.Function):
    """The RBF block with gradients for its length scale and variance.

    Forward is :func:`rbf_kernel`'s own: the plain version on CPU tensors, a
    hand-written kernel on CUDA tensors (whose output carries no autograd
    history of its own).  Backward, with ``G`` the output's gradient::

        d/d var = sum(G K) / var,    d/d ls = sum(G K d2) / ls^3

    with ``d2`` recomputed by :func:`sqdist` from the saved inputs (cheaper
    to trust than ``log(K / var)``, which breaks where K underflows).  The
    features take no gradient: nothing differentiates with respect to them.
    """

    @staticmethod
    def forward(ctx, a, b, length_scale, var, a2, b2):
        if a.requires_grad or b.requires_grad:
            raise ValueError(
                "rbf_kernel differentiates with respect to length_scale and var "
                "only; its inputs a and b must not require grad")
        k = _rbf_forward(a, b, length_scale, var, a2, b2)
        ctx.save_for_backward(a, b, a2, b2, k)
        ctx.hyper = tuple(v.detach() if isinstance(v, torch.Tensor) else v
                          for v in (length_scale, var))
        return k

    @staticmethod
    def backward(ctx, g):
        a, b, a2, b2, k = ctx.saved_tensors
        ls, var = ctx.hyper
        gk = g * k
        grad_ls = grad_var = None
        if ctx.needs_input_grad[2]:
            d2 = sqdist(a, b, a2=a2, b2=b2)
            grad_ls = ((gk * d2).sum() / ls**3).to(ls.dtype).reshape(ls.shape)
        if ctx.needs_input_grad[3]:
            grad_var = (gk.sum() / var).to(var.dtype).reshape(var.shape)
        return None, None, grad_ls, grad_var, None, None


def rbf_kernel(
    a: torch.Tensor,
    b: torch.Tensor,
    length_scale: torch.Tensor | float,
    var: torch.Tensor | float = 1.0,
    *,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RBF kernel block (M, N); the noise term is not included.

    CPU tensors take the plain version; CUDA tensors take a CUDA kernel
    (float32 output), which needs contiguous f32 or bf16 inputs.  Where
    ``length_scale`` or ``var`` requires grad, the call goes through
    :class:`RBFHyperGrad`, so the gradient reaches them on either device.
    ``out``: an (M, N) tensor the block is written into and returned, so
    that no second block is allocated (on the card contiguous f32, which
    the kernel writes directly); not with a gradient.
    """
    if _requires_grad(length_scale) or _requires_grad(var):
        if out is not None:
            raise ValueError("rbf_kernel writes no out= block where it differentiates")
        return RBFHyperGrad.apply(a, b, length_scale, var, a2, b2)
    return _rbf_forward(a, b, length_scale, var, a2, b2, out)


# The reference routes between its Pallas kernel and XLA by TPU-measured
# shape thresholds (``ital_tpu/ops/pallas_rbf.py::rbf_kernel_auto``); here the
# device picks plain or kernel, and ``rbf_hopper.choose_route`` picks the
# kernel by thresholds measured on the H100, so the router is the entry point
# itself.
rbf_kernel_auto = rbf_kernel


def _session_rows(a: torch.Tensor, index: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows of ``a`` (K, m, D) of the sessions in ``index``, as one
    contiguous (G m, D) block (a view where ``index`` is None: every
    session)."""
    return (a if index is None else a[index]).reshape(-1, a.shape[-1])


@functools.cache
def group_index(group: tuple, device) -> torch.Tensor:
    """The sessions of one hyperparameter group as an int64 index on
    ``device``, copied from the host once and cached: a captured program
    may not copy from the host, so the warm-up before its capture fills the
    cache, as it does the MI tables'.  Callers never write it."""
    return torch.tensor(group, dtype=torch.int64, device=device)


def rbf_sessions(
    a: torch.Tensor,
    b: torch.Tensor,
    length_scale: torch.Tensor,
    var: torch.Tensor,
    groups: list,
    *,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K sessions' RBF blocks (K, m, n), one :func:`rbf_kernel` call per group.

    ``a`` is (K, m, D), one block of rows per session, or (m, D) shared by
    every session (the corpus); ``b`` the same with n rows.  ``length_scale``
    and ``var`` are (K,), and ``groups`` lists the sessions in groups of
    equal values (``StackedGPState.hyper_groups``): the kernel reads one
    length scale and one variance per launch, so each group's rows are
    stacked into one launch with its first session's values.  Where both
    sides are per session, a group of G sessions takes one (G m, G n) launch
    and keeps its G diagonal blocks.  ``a2``/``b2``: the shared side's
    cached norms.  The group plan is decided on the host before the call;
    nothing here reads the device or copies from the host after the first
    call with a plan, so a captured program can hold it.
    """
    k = length_scale.shape[0]
    out = None
    for group in groups:
        # One group holds every session, in order; several gather theirs
        # through a cached device index (group_index).
        index = None if len(groups) == 1 else group_index(tuple(group), length_scale.device)
        ga = a if a.dim() == 2 else _session_rows(a, index)
        gb = b if b.dim() == 2 else _session_rows(b, index)
        blk = rbf_kernel(ga, gb, length_scale[group[0]], var[group[0]], a2=a2, b2=b2)
        g = len(group)
        if a.dim() == 2:  # (m, G n): the shared rows against each session's
            blk = blk.view(blk.shape[0], g, -1).permute(1, 0, 2)
        elif b.dim() == 2:  # (G m, n): each session's rows against the shared
            blk = blk.view(g, -1, blk.shape[1])
        else:  # (G m, G n): keep the diagonal blocks
            blk = torch.diagonal(blk.view(g, a.shape[1], g, b.shape[1]), dim1=0, dim2=2)
            blk = blk.permute(2, 0, 1)
        if len(groups) == 1:
            return blk
        if out is None:
            out = blk.new_empty((k, *blk.shape[1:]))
        out[index] = blk
    return out


def rbf_kernel_blockwise(
    a: torch.Tensor,
    b: torch.Tensor,
    length_scale: torch.Tensor | float,
    var: torch.Tensor | float = 1.0,
    *,
    block_rows: int = 1024,
) -> torch.Tensor:
    """:func:`rbf_kernel` computed over row blocks of ``a``: the same values,
    with the distance intermediates bounded to ``block_rows`` rows."""
    return torch.cat([rbf_kernel(blk, b, length_scale, var) for blk in a.split(block_rows)])


def blockwise_reduce_abs_kpost(
    x: torch.Tensor,
    v: torch.Tensor,
    cand_idx: torch.Tensor,
    length_scale: torch.Tensor | float,
    var: torch.Tensor | float,
    *,
    weights: Optional[torch.Tensor] = None,
    x2: Optional[torch.Tensor] = None,
    block: int = 2048,
) -> torch.Tensor:
    """For each candidate c: ``sum_x w(x) |k_post(x, c)|``, in candidate blocks.

    ``k_post(x, c) = k(x, c) - v[:, x] . v[:, c]`` is the GP posterior
    covariance (``v`` the (cap, N) whitened cross-kernel), the column sums of
    which the EMOC baselines need.  ``weights``: the optional (N,) ``w(x)``,
    1 where absent.  Each block forms one (N, block) kernel block (a CUDA
    kernel on the card), subtracts ``v^T v[:, block]`` with a matmul and
    reduces it; the N x N matrix is never held.  ``x2``: the corpus' cached
    f32 squared norms, so a bf16 corpus gets norms from its stored values.
    Counts the blocks (``kernels.kpost_blocks``, ``kernels.kpost_bytes``).
    """
    n, m = x.shape[0], cand_idx.shape[0]
    count("kernels.kpost_blocks", -(-m // block))
    count("kernels.kpost_bytes", n * m * v.element_size())

    def one_block(idx_blk):
        norms = {} if x2 is None else {"a2": x2, "b2": x2[idx_blk]}
        k_cross = rbf_kernel(x, x[idx_blk], length_scale, var, **norms)  # (N, block)
        k_post = (k_cross - v.T @ v[:, idx_blk]).abs_()
        if weights is not None:
            k_post.mul_(weights[:, None])
        return k_post.sum(0)

    return torch.cat([one_block(blk) for blk in cand_idx.split(block)])


def blockwise_reduce_abs_kpost_stacked(
    x: torch.Tensor,
    v: torch.Tensor,
    length_scale: torch.Tensor,
    var: torch.Tensor,
    groups: list,
    *,
    x2: Optional[torch.Tensor] = None,
    block: int = 2048,
) -> torch.Tensor:
    """:func:`blockwise_reduce_abs_kpost` over every corpus point for K
    sessions at once: (K, N) ``sum_x |k_post_k(x, c)|``, ``v`` (K, r, N) the
    sessions' own whitened rows.

    Per block of candidates, each hyperparameter group (``groups``, as
    :func:`rbf_sessions` takes them; ``length_scale``, ``var`` (K,)) forms
    one shared (N, block) kernel block, one kernel launch, and each of its
    sessions subtracts its own ``v^T v[:, block]`` from it and reduces, one
    session after another: a block per group and one session's temporaries
    are held at a time, never K blocks.  Counts the K sessions' blocks
    (``kernels.kpost_blocks``, ``kernels.kpost_bytes``).
    """
    n, k_all = x.shape[0], v.shape[0]
    count("kernels.kpost_blocks", k_all * -(-n // block))
    count("kernels.kpost_bytes", k_all * n * n * v.element_size())
    out = v.new_empty((k_all, n))
    for lo in range(0, n, block):
        c = slice(lo, min(lo + block, n))
        norms = {} if x2 is None else {"a2": x2, "b2": x2[c]}
        for group in groups:
            k_cross = rbf_kernel(x, x[c], length_scale[group[0]], var[group[0]], **norms)
            for k in group:
                out[k, c] = (k_cross - v[k].T @ v[k][:, c]).abs_().sum(0)
    return out
