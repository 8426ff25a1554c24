"""Plain reference of a served session's GP posterior over the corpus, and
the entry that judges a run: the posterior here, the served batches by the
plain reference of the configuration's strategy
(``benchmark/references/<strategy>.py``).

Written from the mathematics (the paper's GP), after
``tests/oracle/numpy_oracle.py``: dense, one labeled set at a time, in plain
PyTorch on whatever device it is given.  It imports nothing of the system
under test and takes nothing the system made: it works each posterior out
again from the corpus and the labels the benchmark handed to the service.
The posterior variance is floored at 1e-8, as the estimator's guards are.

:class:`Precision` says how it computes: ``float64`` is the reference;
``tf32`` is float32 with every matrix product's operands rounded to TF32's
10-bit mantissa (the precision a float32 program gets with TF32 on);
``fp8_corpus`` is float32 over the corpus rounded to float8 e4m3.  The last
two are the lower-precision controls of ``benchmark/control.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

VAR_FLOOR = 1e-8
BLOCK_ROWS = 1 << 16
INVALID_GAP = 1e9  # the gap of a pick that is labeled, repeated or outside the corpus


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "tf32", "fp8_corpus"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.tf32 = name == "tf32"
        self.corpus_cast = torch.float8_e4m3fn if name == "fp8_corpus" else None

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Reference:
    """The reference over corpus ``x`` (as served: its stored dtype) for one
    configuration ``spec`` (``gp``, ``user`` and ``selection`` sections of a
    configuration file), computing in ``prec``."""

    def __init__(self, x: torch.Tensor, spec: dict, prec: Precision):
        self.x = x
        self.n = x.shape[0]
        self.device = x.device
        self.prec = prec
        self.ls = float(spec["gp"]["length_scale"])
        self.var = float(spec["gp"]["var"])
        self.noise = float(spec["gp"]["noise"])
        self.label_prob = float(spec["user"]["label_prob"])
        self.mistake_prob = float(spec["user"]["mistake_prob"])
        self.selection = spec["selection"]

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        r = self.x[idx]
        if self.prec.corpus_cast is not None:
            r = r.to(self.prec.corpus_cast)
        return r.to(self.prec.dtype)

    def rbf(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * self.prec.mm(a, b.T)
        return self.var * torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * self.ls ** 2))

    def posterior(self, idx: Sequence[int], y: Sequence[float]) -> "Posterior":
        return Posterior(self, idx, y)

    def selectable(self, labeled: torch.Tensor, bt: Sequence[int], row: int) -> bool:
        """Whether ``row`` may follow the partial batch ``bt``: a corpus row,
        not ``labeled``, not in ``bt``."""
        return 0 <= row < self.n and not bool(labeled[row]) and row not in list(bt)


class Posterior:
    """The GP posterior given labeled rows ``idx`` with labels ``y``."""

    def __init__(self, ref: Reference, idx: Sequence[int], y: Sequence[float]):
        self.ref = ref
        dt, dev = ref.prec.dtype, ref.device
        self.idx = torch.as_tensor(list(idx), dtype=torch.int64, device=dev)
        self.xl = ref.rows(self.idx)
        eye = torch.eye(len(idx), dtype=dt, device=dev)
        self.chol = torch.linalg.cholesky(ref.rbf(self.xl, self.xl) + ref.noise * eye)
        ycol = torch.as_tensor(list(y), dtype=dt, device=dev)[:, None]
        self.beta = torch.linalg.solve_triangular(self.chol, ycol, upper=False)

    def whiten(self, rows: torch.Tensor) -> torch.Tensor:
        """(L, n) whitened cross-kernel of the labeled rows against ``rows``."""
        return torch.linalg.solve_triangular(self.chol, self.ref.rbf(self.xl, rows), upper=False)

    def moments(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        w = self.whiten(rows)
        mu = self.ref.prec.mm(w.T, self.beta)[:, 0]
        sig2 = torch.clamp(self.ref.var - (w * w).sum(0), min=VAR_FLOOR)
        return mu, sig2, w

    def full(self, with_var: bool = True) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Posterior mean (and variance) of every corpus row, in row blocks."""
        mus, sig2s = [], []
        for lo in range(0, self.ref.n, BLOCK_ROWS):
            rows = self.ref.rows(torch.arange(lo, min(self.ref.n, lo + BLOCK_ROWS),
                                              device=self.ref.device))
            mu, sig2, _ = self.moments(rows)
            mus.append(mu)
            sig2s.append(sig2)
        return torch.cat(mus), (torch.cat(sig2s) if with_var else None)


def readings(x: torch.Tensor, spec: dict, live: list, sampled: list, judge,
             control: Optional[str] = None) -> dict:
    """The numbers ``correct`` compares.

    ``live``: ``(idx, y, mu, sig2)`` of each session live when the window
    closed, its labels and the program's posterior over every row;
    ``sampled``: ``(idx, y, batch)`` of served batches, the labels the
    session held when it was served.  ``posterior_err`` is the widest gap of
    a posterior mean or variance from the reference's; ``judge(ref, low,
    sampled)``, the ``readings`` of the strategy's reference
    (``benchmark/references/<strategy>.py``), adds its numbers of the served
    batches.  With ``control``
    (a :class:`Precision` name), the reference in that precision is put in
    the program's place: its posteriors and its picks are judged instead.
    """
    ref = Reference(x, spec, Precision("float64"))
    low = Reference(x, spec, Precision(control)) if control else None
    post_err = 0.0
    for idx, y, mu_p, sig2_p in live:
        mu_r, sig2_r = ref.posterior(idx, y).full()
        if low is not None:
            mu_p, sig2_p = low.posterior(idx, y).full()
        mu_p = torch.as_tensor(mu_p, device=ref.device).to(torch.float64)
        sig2_p = torch.as_tensor(sig2_p, device=ref.device).to(torch.float64)
        post_err = max(post_err, float((mu_p - mu_r).abs().max()),
                       float((sig2_p - sig2_r).abs().max()))
    out = {"posterior_err": post_err}
    out.update(judge(ref, low, sampled))
    return out
