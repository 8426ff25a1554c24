"""Plain reference of the EMOC selection, and the number ``emoc_gap`` that
judges served batches.

EMOC, expected model output change (Freytag, Rodner and Denzler, "Selecting
Influential Examples: Active Learning with Expected Model Output Changes",
ECCV 2014), for the GP relevance model with labels in {-1, +1}, as the ITAL
repository's EMOC computes it and ``ital_tpu/select/baselines.py`` restates
it: the expected L1 change of the posterior mean over the corpus if row c
were labeled, the label drawn from the model's own P(R_c):

    EMOC(c) = [Phi(z_c) |1 - mu_c| + (1 - Phi(z_c)) |-1 - mu_c|]
              / (sig2_c + noise) * sum_x |k_post(x, c)|,   z_c = mu_c / sqrt(sig2_c)

with ``k_post(x, c) = k(x, c) - w[:, x] . w[:, c]`` the posterior covariance
(``w`` the whitened cross-kernel of :class:`benchmark.reference.Posterior`)
summed over every corpus row, labeled rows included.  The batch is the
``batch`` unlabeled rows of highest score.  Phi is clamped to
[1e-7, 1 - 1e-7] and the posterior variance floored at 1e-8, as the ITAL
repository's guards do; there is no departure from its formula.

The column sums are formed in (rows, columns) blocks of the corpus, so that
no N x N matrix is held (25 000 rows in float64 would be 5 GB); each block
of the kernel is computed once and shared by every judged posterior, since
they share the configuration's hyperparameters.  It imports nothing of the
system under test.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import BLOCK_ROWS, INVALID_GAP

PHI_EPS = 1e-7
ROWS = 8192  # rows of a (rows, columns) block of the posterior covariance
COLUMNS = 2048


def _phi(z: torch.Tensor) -> torch.Tensor:
    return torch.clamp(0.5 * torch.special.erfc(-z / math.sqrt(2.0)), PHI_EPS, 1.0 - PHI_EPS)


def scores(ref, labels: list) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, N) EMOC scores and (S, N) column sums ``sum_x |k_post(x, c)|`` of
    the posteriors given each ``(idx, y)`` of ``labels``, in ``ref``'s
    precision."""
    torch.backends.cuda.matmul.allow_tf32 = False  # a float32 product stays float32
    torch.backends.cudnn.allow_tf32 = False
    prec, n = ref.prec, ref.n
    x = ref.rows(torch.arange(n, device=ref.device))
    mus, sig2s, ws = [], [], []
    for idx, y in labels:
        post = ref.posterior(idx, y)
        parts = [post.moments(x[lo:lo + BLOCK_ROWS]) for lo in range(0, n, BLOCK_ROWS)]
        mus.append(torch.cat([p[0] for p in parts]))
        sig2s.append(torch.cat([p[1] for p in parts]))
        ws.append(torch.cat([p[2] for p in parts], dim=1))  # (L, N)
    colabs = torch.zeros((len(labels), n), dtype=prec.dtype, device=ref.device)
    for c0 in range(0, n, COLUMNS):
        xc = x[c0:c0 + COLUMNS]
        for r0 in range(0, n, ROWS):
            k = ref.rbf(x[r0:r0 + ROWS], xc)
            for j, w in enumerate(ws):
                kpost = k - prec.mm(w[:, r0:r0 + ROWS].T, w[:, c0:c0 + COLUMNS])
                colabs[j, c0:c0 + COLUMNS] += kpost.abs_().sum(0)
    mu, sig2 = torch.stack(mus), torch.stack(sig2s)
    p_pos = _phi(mu / torch.sqrt(sig2))
    change = p_pos * (1.0 - mu).abs() + (1.0 - p_pos) * (-1.0 - mu).abs()
    return change / (sig2 + ref.noise) * colabs, colabs


def _labeled(ref, idx) -> torch.Tensor:
    labeled = torch.zeros(ref.n, dtype=torch.bool, device=ref.device)
    labeled[torch.as_tensor(list(idx), dtype=torch.int64, device=ref.device)] = True
    return labeled


def readings(ref, low, sampled: list) -> dict:
    """``emoc_gap``: over the ``sampled`` ``(idx, y, batch)``, the widest
    amount by which a served pick's reference score lies below the
    ``len(batch)``-th best reference score among the rows unlabeled when it
    was served, relative to the best such score (0 where every pick is
    among them; :data:`INVALID_GAP` for a pick that is labeled, repeated or
    outside the corpus).  With ``low`` (the reference in a lower precision),
    its own picks, the top rows by its own scores, are judged in the
    program's place."""
    if not sampled:
        return {"emoc_gap": 0.0}
    labels = [(idx, y) for idx, y, _ in sampled]
    want, _ = scores(ref, labels)
    got = scores(low, labels)[0] if low is not None else None
    gap = 0.0
    for j, (idx, _, batch) in enumerate(sampled):
        labeled = _labeled(ref, idx)
        if got is not None:
            free = torch.where(labeled, -torch.inf, got[j].to(want.dtype))
            batch = torch.sort(free, descending=True, stable=True).indices[:len(batch)].tolist()
        top = torch.sort(torch.where(labeled, -torch.inf, want[j]), descending=True).values
        best, cut = float(top[0]), float(top[len(batch) - 1])
        for t, pick in enumerate(int(b) for b in batch):
            if not ref.selectable(labeled, [int(b) for b in batch[:t]], pick):
                return {"emoc_gap": INVALID_GAP}
            gap = max(gap, (cut - float(want[j, pick])) / best)
    return {"emoc_gap": gap}
